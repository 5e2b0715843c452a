"""``launches.trainer``: enqueuing runtime calls (kernel launches,
asynchronous copies and memsets) inside the port's ``dmesh2/train_step``
ranges per iteration: the render, the loss, the backward, the optimizer and
the capacity check. None where the port opens no such range."""

from bench_port import port_spans

ROOT = "train_step"


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    roots = [(s, e) for n, s, e in port_spans.port_ranges(t) if n == ROOT]
    if not roots:
        return None
    calls = [c for c, _ in port_spans.enqueue_calls(t)]
    return sum(any(s <= c <= e for s, e in roots) for c in calls) / t.iterations
