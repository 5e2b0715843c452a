"""The ``trainer`` loop kind on a tiny twin of
``tetgrid32_16view_1080p.trainer`` (the same configuration file at 40x36,
three views, every face of tet_grid(3): 378 faces over 64 vertices shared by
up to 36 faces), on the CPU: sound runs are correct, the control and every
planted fault fail the cell's limits, and running it edits no file the
benchmark had."""

from __future__ import annotations

import hashlib
import json
import time
from pathlib import Path

import pytest

from bench_port import harness
from bench_port.faults import planted
from bench_port.scene import build_scene

SEED = 2**33 + 31
REAL = "tetgrid32_16view_1080p.trainer"
TINY = "tiny.tettrainer"
REPO = Path(__file__).resolve().parents[2]


def digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.fixture
def tettrainer_bench(tiny_bench):
    """``tiny_bench`` with the tiny twin of the tet-mesh trainer cell,
    judged by the real cell's limits."""
    root = harness.BENCH
    cfg = json.loads((root / "configs/tetgrid32_16view_1080p.json").read_text())
    cfg.update(name="tiny_tettrainer", width=40, height=36)
    cfg["scene"]["res"] = 3
    cfg["cameras"]["views"] = 3
    cfg["appearance"]["targets"].update(cells=[3, 4], height=36, width=40)
    cfg["raster"].update(binning_capacity=1 << 13, max_tiles_per_face=4, num_giant_faces=64,
                         giant_tiles=8)
    (root / "configs/tiny_tettrainer.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "mixes/trainer.json").read_text())
    mix.update(warmup=2, trace_iterations=2)
    (root / "mixes/trainer.json").write_text(json.dumps(mix))
    (root / f"checks/{TINY}.json").write_text((root / f"checks/{REAL}.json").read_text())
    spec = dict(tiny_bench)
    spec["workloads"] = tiny_bench["workloads"] + [
        dict(name=TINY, config="tiny_tettrainer", traffic="trainer", chips=1, why="tiny")]
    real = harness.load_spec(REPO)
    listing = {m["name"] for m in real["end_to_end"] + real["per_layer"]
               if REAL in m.get("workloads", ())}
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in listing:
            m["workloads"] = [w for w in m["workloads"] if w != REAL] + [TINY]
    return spec


def run(spec, trace=False, seed=SEED):
    return harness.run_cell(spec, TINY, seed, 0.2, trace, "cpu", time.perf_counter(),
                            log=lambda msg: None)


def test_sound_runs_are_correct_and_edit_nothing(tettrainer_bench):
    spec, before = tettrainer_bench, digests(harness.BENCH)
    r = run(spec)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s", "step_ms"}
    assert set(r["checks"]) == set(json.loads(
        (harness.BENCH / f"checks/{REAL}.json").read_text()))
    r = run(spec, trace=True)
    assert r["correct"], r["checks"]
    # No device on the CPU: every reader of the trace finds nothing; the
    # port's entry counters are read on any device.
    assert set(r["metrics"]) == {"blended_pct"} and r["attempted"] == 2
    assert 0.0 < r["metrics"]["blended_pct"]["value"] < 100.0
    after = digests(harness.BENCH)
    assert {p: d for p, d in after.items() if p in before} == before


@pytest.mark.parametrize("fault", list(harness.load_module("loops", "trainer").FAULTS))
def test_a_broken_step_is_not_correct(tettrainer_bench, fault):
    with planted("trainer", fault):
        r = run(tettrainer_bench)
    assert not r["correct"], r["checks"]


def test_the_control_fails_the_cells_limits(tettrainer_bench):
    """The reference with TF32 camera products, in the program's place and
    from the program's snapshot, on three seeds: each fails one of the
    cell's numbers at least."""
    cell = harness.workload(tettrainer_bench, TINY)
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


def test_blended_pct_reads_the_entry_counters_or_nothing(monkeypatch):
    """100 x blended / binned from ``counters()["entries"]``; None on a port
    without them (the parent of the counters) or before any checked
    render."""
    from dmesh2_renderer_tpu_torch.utils import profiling

    read = harness.load_module("metrics", "blended_pct").read
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"entries": {"binned": 400, "blended": 30, "truncated": 0}})
    assert read(None) == 7.5
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"entries": {"binned": 0, "blended": 0, "truncated": 0}})
    assert read(None) is None
    monkeypatch.setattr(profiling, "counters", lambda: {"syncs": {}, "launches": {}})
    assert read(None) is None
