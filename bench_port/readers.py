"""Arithmetic shared by the metric readers of ``metrics/``.

Each reader takes a finished :class:`bench_port.harness.Run` and returns a
number, or None where it finds nothing to read: a share of a roofline is
never reported as 0 for want of a trace or a count.
"""

from __future__ import annotations

import math

from bench_port.harness import kernel_names, peaks


def per_iteration_ms(run):
    """The whole window over the iterations completed in it."""
    if not run.iterations or run.window_s is None:
        return None
    return run.window_s * 1e3 / run.iterations


def p95(values):
    """The 95th percentile by nearest rank: the value at rank ceil(0.95 n)
    of the sorted values."""
    if not values:
        return None
    v = sorted(values)
    return v[max(1, math.ceil(0.95 * len(v))) - 1]


def span_ms(run, name):
    """Mean host-clock milliseconds of the harness's span ``name``."""
    s = run.spans.get(name)
    return sum(s) / len(s) * 1e3 if s else None


def _bound_s(run, kernel):
    c = run.kernel_count(kernel)
    pk = peaks(run.device_name)
    if not c or not pk:
        return None
    return max(c["ops"] / pk["fp32_ops_per_s"], c["bytes"] / pk["hbm_bytes_per_s"])


def roofline(run, kernel):
    """Percent of the kernel's roofline: its least time at the data
    sheet's peaks (the larger of ops over float32 ops/s and bytes over
    HBM bytes/s) over its mean device time per launch in the trace."""
    if run.trace is None:
        return None
    times = run.trace.durations(run.kernel_pattern(kernel))
    bound = _bound_s(run, kernel) if times else None
    if not bound:
        return None
    return 100.0 * bound / (sum(times) / len(times))


def torch_ops_ms(run):
    """Device milliseconds per iteration in operations that are not the
    port's hand-written kernels (PyTorch's own kernels and copies)."""
    if run.trace is None or not run.trace.device:
        return None
    patterns = [run.kernel_pattern(k) for k in kernel_names()]
    return run.trace.other_seconds(patterns) * 1e3 / run.trace.iterations


def idle_pct(run):
    """100 less the percent of the traced window in which the device ran
    an operation."""
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
