"""``port_spans``: the port's ``dmesh2/`` ranges read from hand-built
traces (times in microseconds): launches paired with device operations in
order, each operation charged to the innermost enclosing range, idle time
to the range holding its midpoint, and None where the pairing fails or
nothing can be read."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from bench_port import harness, port_spans

# One iteration from 0 to 100: a render with its prep and binning, four
# launches (one a copy under a host sync), and one launch outside the port.
HOST = [
    ("bench_window", 0, 100),
    ("dmesh2/render", 2, 60),
    ("dmesh2/prep", 4, 20),
    ("cudaLaunchKernel", 5, 6),
    ("dmesh2/sync/view_indices", 8, 18),
    ("cudaMemcpyAsync", 9, 10),
    ("dmesh2/binning", 22, 40),
    ("cudaLaunchKernel", 23, 24),
    ("aten::sort", 25, 35),
    ("cudaLaunchKernelExC", 26, 27),
    ("cudaLaunchKernel", 70, 71),
]
DEVICE = [("elementwise", 7, 8), ("Memcpy HtoD", 11, 12), ("radixSort", 30, 36),
          ("sortPostprocess", 37, 45), ("loss_sum", 80, 90)]


def trace_of(device=DEVICE, host=HOST, window=(0.0, 100.0), iterations=1):
    return harness.Trace(list(device), list(host), window, iterations)


def run_of(trace):
    cache = {}

    def cached(key, fn):
        if key not in cache:
            cache[key] = fn()
        return cache[key]

    return SimpleNamespace(trace=trace, cached=cached)


def test_launches_pair_with_device_operations_in_order():
    # The device list comes in any order; the pairing is by start times.
    att = port_spans.attribute(trace_of(device=list(reversed(DEVICE))))
    assert [op[0] for op, _ in att] == [op[0] for op in DEVICE]
    assert [names for _, names in att] == [
        ("prep", "render"), ("sync/view_indices", "prep", "render"),
        ("binning", "render"), ("binning", "render"), ()]


def test_an_operation_goes_to_the_innermost_enclosing_range():
    t = trace_of(iterations=2)
    att = port_spans.attribute(t)
    # The copy (1 us) is under its sync range, under prep and under render.
    assert port_spans.device_ms_under(t, "prep", att) == pytest.approx(2e-3 / 2)
    assert port_spans.device_ms_under(t, "sync/view_indices", att) == pytest.approx(1e-3 / 2)
    assert port_spans.device_ms_under(t, "binning", att) == pytest.approx(14e-3 / 2)
    assert port_spans.device_ms_under(t, "render", att) == pytest.approx(16e-3 / 2)
    assert port_spans.device_ms_under(t, None, att) == pytest.approx(10e-3 / 2)
    # A range the program never opened reads nothing.
    assert port_spans.device_ms_under(t, "scatter", att) is None
    run = run_of(t)
    assert port_spans.stage_ms(run, "binning") == pytest.approx(7e-3)
    assert port_spans.host_syncs(run) == pytest.approx(0.5)
    # The launch at 70 lies outside every root range.
    assert port_spans.launches(run) == pytest.approx(2.0)


@pytest.mark.parametrize("lost", [
    # Two calls before the first recorded operation, whose operations the
    # profiler kept no record of.
    [("dmesh2/render", 0.5, 1.5), ("cudaMemcpyAsync", 0.6, 0.7), ("cudaLaunchKernel", 0.8, 0.9)],
    # A last call whose operation the window cut off.
    [("cudaMemsetAsync", 95, 96)],
], ids=["at_the_start", "at_the_end"])
def test_calls_without_a_recorded_operation_at_either_end_go_unpaired(lost):
    t = trace_of(host=HOST + lost)
    assert port_spans.attribute(t) == port_spans.attribute(trace_of())


NO_COPY = [h for h in HOST if h[0] != "cudaMemcpyAsync"]


@pytest.mark.parametrize("device,host", [
    (DEVICE + [("orphan", 92, 94)], HOST),                  # an operation with no call
    ([("Memset (Device)", *op[1:]) if op[0] == "elementwise" else op for op in DEVICE],
     HOST),                                                 # a kernel's call, a memset
    ([op for op in DEVICE if not op[0].startswith("Memcpy")], HOST),  # lost mid-window
    ([op for op in DEVICE if not op[0].startswith("Memcpy")],
     NO_COPY + [("cudaLaunchKernel", 95, 96)]),             # two places fit
], ids=["operation_without_call", "kinds_differ", "copy_lost_mid_window", "ambiguous"])
def test_a_pairing_that_does_not_hold_gives_none(device, host):
    t = trace_of(device=device, host=host)
    assert port_spans.attribute(t) is None
    assert port_spans.stage_ms(run_of(t), "prep") is None
    assert port_spans.idle_by_range(t) is None
    assert port_spans.port_idle_ms(run_of(t)) is None


def test_idle_time_goes_to_the_range_holding_its_midpoint_on_the_host_clock():
    # Each idle stretch ends at the call of the operation that ended it:
    # 0-7 (7 us) ends at the call at 5, midpoint 1.5, outside the port;
    # 8-11 at 9: 7.5 in prep; 12-30 at 23: 14 in the sync range; 36-37 at
    # 26: 25.5 in binning; 45-80 at 70: 52.5 in render; 90-100 at the
    # window's end: 95, outside.
    idle = port_spans.idle_by_range(trace_of(iterations=2))
    assert idle == pytest.approx({"": 17e-3 / 2, "prep": 3e-3 / 2, "sync/view_indices": 18e-3 / 2,
                                  "binning": 1e-3 / 2, "render": 35e-3 / 2})
    assert port_spans.port_idle_ms(run_of(trace_of(iterations=2))) == pytest.approx(57e-3 / 2)


READERS = [lambda r: port_spans.stage_ms(r, "prep"), port_spans.host_syncs,
           port_spans.launches, port_spans.port_idle_ms]


@pytest.mark.parametrize("read", READERS, ids=["stage_ms", "host_syncs", "launches",
                                               "port_idle_ms"])
def test_nothing_to_read_gives_none(read):
    # No device operations (a run on the CPU).
    assert read(run_of(trace_of(device=[]))) is None
    # A program that opens no port range (the parent of the ranges).
    bare = [h for h in HOST if not h[0].startswith("dmesh2/")]
    assert read(run_of(trace_of(host=bare))) is None
    # No trace at all.
    assert read(SimpleNamespace(trace=None)) is None
