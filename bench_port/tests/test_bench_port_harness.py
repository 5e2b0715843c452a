"""The harness's arithmetic on small recorded event lists, the metric
readers, the roofline counts at tiny sizes against hand counts, and a run
without a card."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench_port import counting, harness, readers
from bench_port.reference.binning import Binned

REPO = Path(__file__).resolve().parents[2]
H100 = "NVIDIA H100 80GB HBM3"


def trace_of(device, host=(), window=(0.0, 1000.0), iterations=1):
    return harness.Trace(list(device), list(host), window, iterations)


def test_merged_span_unions_overlaps():
    assert harness.merged_span([(0, 10), (5, 20), (30, 40), (35, 36)]) == 30
    assert harness.merged_span([]) == 0


def test_idle_share_of_a_recorded_window():
    # busy 0-100, 150-300 (overlapping ops), 900-1100 clipped to the window
    t = trace_of([("k1", 0, 100), ("k2", 150, 250), ("k3", 200, 300), ("k4", 900, 1100)])
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(350e-6)
    run = SimpleNamespace(trace=t)
    assert readers.idle_pct(run) == pytest.approx(65.0)


def test_torch_ops_and_port_kernels_are_told_apart_by_name():
    t = trace_of([
        ("void composite_fwd_kernel<...>(float const*)", 0, 100),
        ("void composite_bwd_kernel(float const*)", 100, 300),
        ("pack_stream_kernel", 300, 320),
        ("void peel_kernel<8>(int const*)", 320, 340),
        ("void peel_kernel_tiered<8, 8>(int const*)", 340, 380),
        ("void at::native::radixSortKVInPlace<...>", 400, 450),
        ("Memcpy DtoH (Device -> Pinned)", 450, 460),
        ("void at::native::vectorized_elementwise_kernel<...>", 500, 530),
    ], iterations=2)
    run = SimpleNamespace(trace=t, kernel_pattern=lambda k: harness.load_module("counts", k).PATTERN)
    # 50 + 10 + 30 us of PyTorch's own work over 2 iterations
    assert readers.torch_ops_ms(run) == pytest.approx(0.045)
    assert t.durations(run.kernel_pattern("peel")) == pytest.approx([20e-6])
    assert t.durations(run.kernel_pattern("peel_wide")) == pytest.approx([40e-6])
    assert t.durations(run.kernel_pattern("composite_fwd")) == pytest.approx([100e-6])


def test_idle_gaps_are_named_by_the_innermost_host_op():
    t = trace_of([("k", 0, 100), ("k", 400, 1000)],
                 host=[("bench_window", 0, 1000), ("forward", 50, 450),
                       ("aten::nonzero", 150, 350)])
    gaps = dict(t.idle_gaps())
    assert gaps == {"aten::nonzero": pytest.approx(300e-6)}


def test_p95_is_over_every_frame():
    values = list(range(1, 101))            # 1 .. 100 ms
    assert readers.p95(values) == 95
    assert readers.p95([5.0]) == 5.0
    assert readers.p95(list(range(1, 21))) == 19
    assert readers.p95([]) is None


def test_window_rates():
    run = SimpleNamespace(window_s=10.0, iterations=400)
    assert readers.per_iteration_ms(run) == pytest.approx(25.0)
    assert readers.per_iteration_ms(SimpleNamespace(window_s=1.0, iterations=0)) is None


def test_roofline_share():
    t = trace_of([("void composite_bwd_kernel(float)", 0, 500), ("composite_bwd_kernel", 500, 1000)],
                 iterations=2)
    counts = {"composite_bwd": dict(ops=67e9, bytes=3.35e9)}       # 1 ms at the op peak
    run = SimpleNamespace(trace=t, device_name=H100, window_s=0.002, iterations=2,
                          kernel_pattern=lambda k: harness.load_module("counts", k).PATTERN,
                          kernel_count=lambda k: counts.get(k))
    # bound 1 ms against a mean launch of 0.5 ms: 200%, a count too high or a time too short
    assert readers.roofline(run, "composite_bwd") == pytest.approx(200.0)
    assert readers.roofline(run, "composite_fwd") is None
    run.device_name = "some other card"
    assert readers.roofline(run, "composite_bwd") is None


def test_compositor_counts_by_hand():
    cfg = dict(width=32, height=16, aa_temperature=1.0)
    work = dict(forward=dict(records=10, pairs=1000, bbox_pairs=200, blend_pairs=50),
                backward=dict(records=8, grad_records=4, pairs=900, bbox_pairs=180,
                              blend_pairs=40), records=128, tiles=2)
    scene = SimpleNamespace(views=1, verts=torch.zeros(30, 3), faces=torch.zeros(10, 3))
    run = SimpleNamespace(config=cfg, reference=dict(work=work), scene=scene)
    n_pix = 512
    fwd = counting.composite_forward(run)
    assert fwd["ops"] == 1000 * 6 + 200 * (50 + 176) + 50 * 37
    assert fwd["bytes"] == 10 * 128 + (n_pix * 3 + 3 + 3 + 2) * 4 + 3 * 2 * 4 + n_pix * 7 * 4
    bwd = counting.composite_backward(run)
    assert bwd["ops"] == (900 * 6 + 180 * 226 + 40 * (37 + 111 + 143)
                          + 4 * (29 * 255 + 117))
    assert bwd["bytes"] == 8 * 128 + 128 * 128 + n_pix * 14 * 4 + 3 * 2 * 4
    pack = counting.record_pack(run)
    assert pack["ops"] == 0
    assert pack["bytes"] == (128 * 128 + 128 * 4 + 10 * 3 * 4
                             + (30 * 3 + 30 * 3 + 30 * 3 + 10 + 10 + 60) * 4)


def test_peel_full_scan_counts_by_hand():
    # One view of 32 x 16 (two tiles), the camera at (0, 0, 1), each ray
    # aimed at its pixel centre (cx, cy) on the plane z = 0. Face 0 is the
    # triangle x, y >= 0, x + y <= 20.25 on that plane; face 1 lies far off.
    # Tile 0 lists face 0; tile 1 lists faces 0 and 1.
    verts = torch.tensor([[0.0, 0.0, 0.0], [20.25, 0.0, 0.0], [0.0, 20.25, 0.0],
                          [100.0, 100.0, 0.0], [101.0, 100.0, 0.0], [100.0, 101.0, 0.0]])
    faces = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    ys, xs = torch.meshgrid(torch.arange(16.0) + 0.5, torch.arange(32.0) + 0.5, indexing="ij")
    ray_d = torch.stack([xs, ys, torch.full_like(xs, -1.0)], dim=-1)[None]
    binned = Binned(torch.tensor([0, 0, 1, 2, 2], dtype=torch.int32),
                    torch.tensor([0, 1], dtype=torch.int32),
                    torch.tensor([1, 2], dtype=torch.int32), None, None)
    w = counting.peel_scan(binned, faces, verts, torch.tensor([1, 1], dtype=torch.int32),
                           torch.tensor([[0.0, 0.0, 1.0]]), ray_d)
    assert w["entries"] == 3
    assert w["pairs"] == 3 * 256
    assert w["hits"] == int((xs + ys <= 20.25).sum())
    # A face that does not exist is neither an entry nor a hit.
    w = counting.peel_scan(binned, faces, verts, torch.tensor([0, 1], dtype=torch.int32),
                           torch.tensor([[0.0, 0.0, 1.0]]), ray_d)
    assert (w["entries"], w["pairs"], w["hits"]) == (1, 256, 0)


def test_spec_cells_have_their_files():
    spec = harness.load_spec()
    for cell in spec["workloads"]:
        cfg = harness.load_data("configs", cell["config"])
        mix = harness.load_data("mixes", cell["traffic"])
        limits = harness.load_data("checks", cell["name"])
        assert cfg["name"] == cell["config"] and "loop" in mix and limits
        kind = harness.load_module("loops", mix["loop"])
        assert kind.Loop and kind.KERNELS and kind.FAULTS
        for kind_dir, key in (("scenes", "scene"), ("cameras", "cameras"),
                              ("appearances", "appearance")):
            if key in cfg:
                assert callable(harness.load_module(kind_dir, cfg[key]["generator"]).make)
        for section in ("end_to_end", "per_layer"):
            for m in harness.cell_metrics(spec, cell["name"], section):
                assert hasattr(harness.load_module("metrics", m["name"]), "read")
    for k in harness.kernel_names():
        mod = harness.load_module("counts", k)
        assert mod.PATTERN and callable(mod.count)


def test_run_without_a_card_exits_non_zero_with_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "bench_port.run", "--workload", "soup1m_1080p.train",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_result_numbers_are_finite_json():
    assert harness._number(float("nan")) == harness._HUGE
    assert json.loads(json.dumps({"v": harness._number(math.inf)}))["v"] > 1e37


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dmesh2_renderer_tpu_torch_probe", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jaxlib.probe", object())
    assert harness.forbidden_loaded() == ["jaxlib"]


NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$"
UNIT = r"^[A-Za-z0-9_/%.\-]{1,16}$"
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_benchmark_json_keeps_to_its_shape():
    import re

    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["bench_port"] and 1 <= spec["run_seconds"] <= 51
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024

    def line(text):
        return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text

    names = set()
    for section, keys in KEYS.items():
        for entry in spec[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, entry
            assert re.match(NAME, entry["name"]) and entry["name"] not in names
            names.add(entry["name"])
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert line(entry[key]), entry
            if "unit" in entry:
                assert re.match(UNIT, entry["unit"]) and entry["better"] in ("lower", "higher")
    ends = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in ends
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in ends
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    cells = {c["name"] for c in spec["workloads"]}
    for c in spec["workloads"]:
        assert c["chips"] in (1, 4) and c["config"] in {x["name"] for x in spec["configs"]}
        reported = {m["name"] for m in harness.cell_metrics(spec, c["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(spec, c["name"], "per_layer")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for cfg in spec["configs"]:
        data = json.loads((REPO / cfg["file"]).read_text())
        assert cfg["file"].startswith("bench_port/") and data["name"] == cfg["name"]
        assert data["reduced"] == cfg["reduced"] and data["source"] == cfg["source"]
