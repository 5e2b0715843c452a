"""The port's own profiler ranges in a traced window, for the per-layer
metrics that read them.

While a profiler records, the port opens ``dmesh2/<name>`` ranges around
its stages and ``dmesh2/sync/<site>`` ranges around the points where the
host waits for the device (``dmesh2_renderer_tpu_torch/utils/profiling.py``).
Here each device operation of the window is paired with the host call that
enqueued it: the enqueuing runtime calls (kernel launches, asynchronous
copies and memsets) in time order against the device operations in start
order, which is one to one because the port runs on one stream. The
operation goes to the innermost ``dmesh2/`` range enclosing its call; one
with none is outside the port.

Two things keep the two lists from being equally long, and the two clocks
from being compared directly (both seen on an H100 by correlation ids):
the profiler keeps no record of the operations of the window's first two or
three calls, and the device's timestamps drift from the host's by up to
about 1.7 ms over a window, so that the window sometimes cuts the last
operations off. So the operations are paired, in order, with one
contiguous run of the calls, leaving calls over at either end: of the
places that run can start, exactly one must make every pair agree in kind
(a copy, a memset or a kernel), or the pairing is refused (None), never
guessed. An idle stretch of the device is placed on the host's clock by the
call that ended it: it ran up to that call.
"""

from __future__ import annotations

import re

import numpy as np

PREFIX = "dmesh2/"
SYNC = "sync/"
ROOTS = ("render", "generate", "backward")
ENQUEUE = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaMemcpyAsync|cudaMemsetAsync)")


def _call_kind(name: str) -> int:
    """0 a copy, 1 a memset, 2 a kernel launch."""
    return 0 if "Memcpy" in name else 1 if "Memset" in name else 2


def _op_kind(name: str) -> int:
    return 0 if name.startswith("Memcpy") else 1 if name.startswith("Memset") else 2


def port_ranges(trace) -> list:
    """(name, start, end) of the port's ranges that start in the window,
    the name without ``dmesh2/``."""
    w0, w1 = trace.window
    return [(n[len(PREFIX):], s, e) for n, s, e in trace.host
            if n.startswith(PREFIX) and w0 <= s <= w1]


def enqueue_calls(trace) -> list:
    """(start, name) of the window's enqueuing runtime calls, in order."""
    w0, w1 = trace.window
    return sorted((s, n) for n, s, _ in trace.host if ENQUEUE.match(n) and w0 <= s <= w1)


class _Ranges:
    """Ranges (name, start, end), asked which of them hold a time."""

    def __init__(self, ranges):
        self.names = [n for n, _, _ in ranges]
        self.starts = np.array([s for _, s, _ in ranges], dtype=np.float64)
        self.ends = np.array([e for _, _, e in ranges], dtype=np.float64)

    def holding(self, t) -> tuple:
        """Names of the ranges holding time ``t``, innermost (latest
        start) first."""
        inside = np.nonzero((self.starts <= t) & (self.ends >= t))[0]
        order = inside[np.argsort(-self.starts[inside], kind="stable")]
        return tuple(self.names[i] for i in order)


def pair(trace):
    """(operation, call start) for each device operation of the window, in
    start order, with the call that enqueued it. None when the window has
    no device operations or the pairing is refused."""
    if not trace.device:
        return None
    ops = sorted(trace.device, key=lambda op: op[1])
    calls = enqueue_calls(trace)
    n = len(ops)
    op_kinds = np.array([_op_kind(name) for name, _, _ in ops], dtype=np.int8)
    call_kinds = np.array([_call_kind(name) for _, name in calls], dtype=np.int8)
    fits = [k for k in range(len(calls) - n + 1)
            if np.array_equal(call_kinds[k:k + n], op_kinds)]
    if len(fits) != 1:
        return None
    k = fits[0]
    return [(op, t) for op, (t, _) in zip(ops, calls[k:k + n])]


def attribute(trace):
    """Each paired device operation of the window, in start order, with the
    names of the port's ranges that enclose its enqueuing call, innermost
    first (empty: outside the port). None where :func:`pair` is."""
    pairs = pair(trace)
    if pairs is None:
        return None
    ranges = _Ranges(port_ranges(trace))
    return [(op, ranges.holding(t)) for op, t in pairs]


def device_ms_under(trace, name: str, attribution):
    """Device milliseconds per iteration of the operations enqueued inside
    a range ``name`` (at any depth); ``name`` None: outside every range.
    None without an attribution, or when no range ``name`` was opened."""
    if attribution is None:
        return None
    if name is not None and not any(n == name for n, _, _ in port_ranges(trace)):
        return None
    total = sum(e - s for (_, s, e), names in attribution
                if (name in names if name is not None else not names))
    return total * 1e-3 / trace.iterations


def idle_by_range(trace):
    """Idle device milliseconds per iteration by the innermost port range
    that holds, on the host's clock, each idle stretch's midpoint ("" outside
    the port); the stretch ends at the call of the operation that ended it,
    or at the window's end. None where :func:`pair` is."""
    pairs = pair(trace)
    if pairs is None:
        return None
    ranges = _Ranges(port_ranges(trace))
    w0, w1 = trace.window
    out = {}

    def charge(gap, end):
        names = ranges.holding(end - 0.5 * gap)
        key = names[0] if names else ""
        out[key] = out.get(key, 0.0) + gap * 1e-3 / trace.iterations

    busy = w0
    for (_, s, e), t in pairs:
        if s > busy:
            charge(s - busy, t)
        busy = max(busy, e)
    if w1 > busy:
        charge(w1 - busy, w1)
    return out


def _traced(run):
    """The run's trace where it has device operations and port ranges."""
    t = run.trace
    if t is None or not t.device or not port_ranges(t):
        return None
    return t


def stage_ms(run, name: str):
    """Device ms per iteration enqueued under the port's range ``name``."""
    t = _traced(run)
    if t is None:
        return None
    return device_ms_under(t, name, run.cached(("port_spans", "attribute"),
                                               lambda: attribute(t)))


def port_idle_ms(run):
    """Device-idle ms per iteration whose gap's midpoint lies inside a
    port range."""
    t = _traced(run)
    idle = None if t is None else idle_by_range(t)
    if idle is None:
        return None
    return sum(v for k, v in idle.items() if k)


def host_syncs(run):
    """The port's host-sync ranges per iteration."""
    t = _traced(run)
    if t is None:
        return None
    return sum(n.startswith(SYNC) for n, _, _ in port_ranges(t)) / t.iterations


def launches(run):
    """Enqueuing calls inside the port's root ranges per iteration."""
    t = _traced(run)
    if t is None:
        return None
    roots = [r for r in port_ranges(t) if r[0] in ROOTS]
    if not roots:
        return None
    held = _Ranges(roots)
    return sum(bool(held.holding(s)) for s, _ in enqueue_calls(t)) / t.iterations
