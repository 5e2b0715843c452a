"""``prep_ms.tettrainer``: ``prep_ms.trainer`` in the tet-mesh trainer
cell: device milliseconds per iteration of the operations enqueued inside
the port's ``dmesh2/prep`` ranges (projection, AA corners,
``face_depth01``, ray selection and camera gathers, for every view)."""

from bench_port import port_spans


def read(run):
    return port_spans.stage_ms(run, "prep")
