"""The ``trainer`` loop kind on a tiny twin of ``soup1m_16view_1080p.trainer``
(``trainer_bench``: the same configuration file at 40x36, three views,
80 faces), on the CPU:
sound runs are correct, the control and every planted fault fail the
cell's limits, and running it edits no file the benchmark had."""

from __future__ import annotations

import hashlib
import json
import time

import pytest

from bench_port import harness
from bench_port.faults import planted
from bench_port.scene import build_scene

SEED = 2**33 + 29
REAL = "soup1m_16view_1080p.trainer"
TINY = "tiny.trainer"


def digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file()}


def run(spec, trace=False, seed=SEED):
    return harness.run_cell(spec, TINY, seed, 0.2, trace, "cpu", time.perf_counter(),
                            log=lambda msg: None)


def test_sound_runs_are_correct_and_edit_nothing(trainer_bench):
    spec, before = trainer_bench, digests(harness.BENCH)
    r = run(spec)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "step_ms"}
    assert set(r["checks"]) == set(json.loads(
        (harness.BENCH / f"checks/{REAL}.json").read_text()))
    r = run(spec, trace=True)
    assert r["correct"], r["checks"]
    # No device on the CPU: every per-layer reader finds nothing to read.
    assert r["metrics"] == {} and r["attempted"] == 2
    after = digests(harness.BENCH)
    assert {p: d for p, d in after.items() if p in before} == before


@pytest.mark.parametrize("fault", list(harness.load_module("loops", "trainer").FAULTS))
def test_a_broken_step_is_not_correct(trainer_bench, fault):
    spec = trainer_bench
    with planted("trainer", fault):
        r = run(spec)
    assert not r["correct"], r["checks"]


def test_the_control_fails_the_cells_limits(trainer_bench):
    """The reference with TF32 camera products, in the program's place and
    from the program's snapshot, on three seeds: each fails one of the
    cell's numbers at least."""
    spec = trainer_bench
    cell = harness.workload(spec, TINY)
    config = harness.load_data("configs", cell["config"])
    mix = harness.load_data("mixes", cell["traffic"])
    limits = harness.load_data("checks", TINY)
    loop_cls = harness.load_module("loops", "trainer").Loop
    for seed in (SEED, SEED + 1, SEED + 2):
        scene = build_scene(config, seed, "cpu")
        loop = loop_cls(scene, config, mix, harness.torch.device("cpu"), None)
        for _ in range(mix["warmup"] + 1):
            loop.step()
        prog = loop.outputs(seed)
        want = loop_cls.reference(scene, config, mix, "float32", prog)
        assert loop_cls.compare(prog, want)["truncated"] == 0
        control = loop_cls.reference(scene, config, mix, "tf32", prog)
        nums = loop_cls.compare(control, want)
        assert any(nums[k] > limits[k] for k in limits), (seed, nums)


def test_the_step_readers_read_the_step_ranges_or_nothing():
    """``launches.trainer`` counts the enqueuing calls inside
    ``dmesh2/train_step``; on a program without that range (the parent of
    the trainer cell's PR) it and ``loss_ms.trainer`` read nothing."""
    from types import SimpleNamespace

    def trace(host):
        return harness.Trace([("k", 6, 8), ("k", 81, 82)],
                             [("bench_window", 0, 100)] + host, (0, 100), 2)

    launch = ("cudaLaunchKernel", 6, 7), ("cudaLaunchKernel", 60, 61), ("cudaMemcpyAsync", 80, 81)
    steps = trace([("dmesh2/train_step", 5, 50), ("dmesh2/train_step", 70, 90), *launch])
    older = trace([("dmesh2/render", 5, 50), *launch])
    launches = harness.load_module("metrics", "launches.trainer")
    loss = harness.load_module("metrics", "loss_ms.trainer")
    assert launches.read(SimpleNamespace(trace=steps)) == 1.0
    assert launches.read(SimpleNamespace(trace=older)) is None
    assert loss.read(SimpleNamespace(trace=older, cached=lambda k, f: f())) is None
