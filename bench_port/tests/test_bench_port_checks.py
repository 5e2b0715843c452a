"""The output check: whole runs of tiny cells on the CPU (the look for a
card skipped), sound and with the timed path broken underneath, and the
control against each cell's limits.

The faults are each loop kind's (``FAULTS`` of ``loops/<kind>.py``),
planted in the port's own path.
"""

from __future__ import annotations

import json
import time

import pytest

from bench_port import harness
from bench_port.faults import planted
from bench_port.loop import sample_tiles, tile_pixels
from bench_port.scene import build_scene

SEED = 2**31 + 17


def run(spec, cell, trace=False):
    return harness.run_cell(spec, cell, SEED, 0.2, trace, "cpu", time.perf_counter(),
                            log=lambda msg: None)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.forward", "tiny.peel4", "tiny.peel17"])
def test_sound_runs_are_correct(tiny_bench, cell):
    r = run(tiny_bench, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(tiny_bench, cell, "end_to_end")}
    assert set(r["metrics"]) == names
    json.dumps(r)


def test_traced_run_reports_per_layer_metrics(tiny_bench):
    r = run(tiny_bench, "tiny.train", trace=True)
    assert r["correct"]
    # No device on the CPU: only the host-clock span reads something.
    assert set(r["metrics"]) == {"backward_ms.train"}
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def faults_of(kind):
    return list(harness.load_module("loops", kind).FAULTS)


CASES = [("tiny.train", f) for f in faults_of("train")] + \
    [("tiny.forward", f) for f in faults_of("frames")] + \
    [(cell, f) for cell in ("tiny.peel4", "tiny.peel17") for f in faults_of("peel")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tiny_bench, cell, fault):
    mix = harness.load_data("mixes", harness.workload(tiny_bench, cell)["traffic"])
    with planted(mix["loop"], fault):
        r = run(tiny_bench, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.forward", "tiny.peel4", "tiny.peel17"])
def test_the_control_fails_the_cells_limits(tiny_bench, cell):
    """The reference with TF32 camera products, in the program's place, on
    three seeds: each fails one of the cell's numbers at least."""
    c = harness.workload(tiny_bench, cell)
    config = harness.load_data("configs", c["config"])
    mix = harness.load_data("mixes", c["traffic"])
    limits = harness.load_data("checks", cell)
    loop = harness.load_module("loops", mix["loop"]).Loop
    for seed in (SEED, SEED + 1, SEED + 2):
        scene = build_scene(config, seed, "cpu")
        prog = {}
        if mix["loop"] == "peel":
            gx, gy = -(-config["width"] // 16), -(-config["height"] // 16)
            tiles = sample_tiles(seed, scene.views * gx * gy, mix["check_tiles"], "cpu")
            prog = dict(tiles=tiles)
            assert tile_pixels(tiles, scene.views, config["width"], config["height"]).shape[0]
        want = loop.reference(scene, config, mix, "float32", prog)
        control = loop.reference(scene, config, mix, "tf32", prog)
        nums = loop.compare(control, want)
        assert any(nums[k] > limits[k] for k in limits), (seed, nums)
