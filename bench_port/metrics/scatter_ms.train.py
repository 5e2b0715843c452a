"""``scatter_ms.train``: device milliseconds per iteration of the operations
enqueued inside the port's ``dmesh2/scatter`` ranges (``reduce_entry_grads``:
the ``grad_reduce`` kernel and the fills and copies of its outputs)."""

from bench_port import port_spans


def read(run):
    return port_spans.stage_ms(run, "scatter")
