"""The output check: whole runs of tiny cells on the CPU (the look for a
card skipped), sound and with the timed path broken underneath, and the
control against each cell's limits.

The faults are each loop kind's (``FAULTS`` of ``loops/<kind>.py``),
planted in the port's own path. The cases marked ``garbage`` run the
differentiable cells with the backward compositor's table as the card
leaves it (``garbage_rows``): rows outside the contributing prefixes hold
NaN and 1e30, which nothing reads and no fault may pick.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from bench_port import calibrate, harness
from bench_port.faults import one_record, planted
from bench_port.loop import sample_tiles, tile_pixels
from bench_port.reference.binning import REC_OP, contributing_mask
from bench_port.scene import build_scene

SEED = 2**31 + 17
CELLS = ["tiny.train", "tiny.forward", "tiny.peel4", "tiny.peel17"]
# The cells that run the backward compositor.
GRADIENT_CELLS = ["tiny.train", "tiny.trainer"]


def with_garbage(table, keep):
    """``table`` with every row outside ``keep`` overwritten: every other
    one NaN, the rest 1e30, larger than any real gradient."""
    dead = (~keep).nonzero().flatten()
    table[dead[0::2]] = float("nan")
    table[dead[1::2]] = 1e30
    return table


@pytest.fixture
def garbage_rows(monkeypatch):
    """The port's ``composite_backward`` as the card runs it: every row
    outside the contributing prefixes unset (``torch.empty``), which
    nothing reads. The plain version zeroes them; here they hold NaN and
    1e30."""
    from dmesh2_renderer_tpu_torch.ops import rasterize

    orig = rasterize.composite_backward

    def f(records, tile_starts, tile_counts, nc_tile, *rest):
        out = orig(records, tile_starts, tile_counts, nc_tile, *rest)
        return with_garbage(out, contributing_mask(tile_starts, tile_counts, nc_tile,
                                                   out.shape[0]))

    monkeypatch.setattr(rasterize, "composite_backward", f)


def run(spec, cell, trace=False):
    return harness.run_cell(spec, cell, SEED, 0.2, trace, "cpu", time.perf_counter(),
                            log=lambda msg: None)


def bench_for(request, cell, garbage):
    """The benchmark the cell is in; with ``garbage``, ``garbage_rows`` on."""
    if garbage:
        request.getfixturevalue("garbage_rows")
    return request.getfixturevalue("trainer_bench" if cell == "tiny.trainer" else "tiny_bench")


@pytest.mark.parametrize("cell,garbage", [pytest.param(c, False, id=c) for c in CELLS] + [
    pytest.param(c, True, id=f"{c}-garbage") for c in GRADIENT_CELLS])
def test_sound_runs_are_correct(request, cell, garbage):
    spec = bench_for(request, cell, garbage)
    r = run(spec, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    names = {m["name"] for m in harness.cell_metrics(spec, cell, "end_to_end")}
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


@pytest.mark.parametrize("cell,fault,garbage", [
    pytest.param(c, f, False, id=f"{c}-{f}") for c, f in CASES] + [
    pytest.param(c, "altered_gradient", True, id=f"{c}-altered_gradient-garbage")
    for c in GRADIENT_CELLS])
def test_a_broken_timed_path_is_not_correct(request, cell, fault, garbage):
    spec = bench_for(request, cell, garbage)
    mix = harness.load_data("mixes", harness.workload(spec, cell)["traffic"])
    with planted(mix["loop"], fault):
        r = run(spec, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("prefix_opacity", ["random", "zero"])
def test_altered_gradient_scales_a_row_the_reduction_reads(prefix_opacity):
    """``one_record`` over a table whose rows outside the contributing
    prefixes hold NaN and 1e30: it scales by 1.5 the prefix row of the
    largest |opacity gradient| and nothing else; where every prefix row's
    opacity gradient is zero it raises instead of altering nothing."""
    gen = torch.Generator().manual_seed(SEED)
    starts = torch.tensor([0, 5, 5, 9], dtype=torch.int32)
    counts = torch.tensor([5, 0, 4, 3], dtype=torch.int32)
    nc_tile = torch.tensor([3, 2, 4, 0], dtype=torch.int32)
    keep = contributing_mask(starts, counts, nc_tile, 16)
    table = torch.randn((16, 32), generator=gen)
    if prefix_opacity == "zero":
        table[keep, REC_OP] = 0.0
    table = with_garbage(table, keep)
    altered = one_record(lambda *args: table.clone())
    if prefix_opacity == "zero":
        with pytest.raises(RuntimeError):
            altered(None, starts, counts, nc_tile)
        return
    out = altered(None, starts, counts, nc_tile)
    changed = ((out != table) & ~(out.isnan() & table.isnan())).any(dim=1).nonzero().flatten()
    row = int(torch.where(keep, table[:, REC_OP].abs(), -1.0).argmax())
    assert changed.tolist() == [row] and keep[row]
    torch.testing.assert_close(out[row, :29], 1.5 * table[row, :29])
    torch.testing.assert_close(out[row, 29:], table[row, 29:])


def test_calibrate_summary_names_each_uncaught_fault():
    """``calibrate --faults`` ends with the faults that passed every limit
    on some seed, and exits 1 while there is one."""
    lines = [dict(fault="altered", seed=1, fails=["color_gap"]),
             dict(fault="altered", seed=2, fails=["color_gap", "grad_gap"]),
             dict(fault="altered_gradient", seed=1, fails=["grad_gap"]),
             dict(fault="altered_gradient", seed=2, fails=[])]
    assert calibrate.fault_summary("w", lines) == (
        dict(workload="w", uncaught=["altered_gradient"]), 1)
    assert calibrate.fault_summary("w", lines[:3]) == (dict(workload="w", uncaught=[]), 0)


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
