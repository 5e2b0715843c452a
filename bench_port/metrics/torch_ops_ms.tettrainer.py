"""``torch_ops_ms.tettrainer``: ``torch_ops_ms.trainer`` in the tet-mesh
trainer cell: device milliseconds per iteration in operations other than
the port's hand-written kernels."""

from bench_port import readers


def read(run):
    return readers.torch_ops_ms(run)
