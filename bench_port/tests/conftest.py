"""Tiny cells of the benchmark's configurations, for runs on the CPU.

``tiny_bench`` copies the benchmark's data and reader files into a
temporary directory, adds small configurations of both scenes (the same
files with smaller sizes) and mixes with few iterations, points the
harness there and returns a ``BENCHMARK.json``-shaped dict whose cells
are the real ones' under those names: ``tiny.train``, ``tiny.forward``,
``tiny.peel4`` and ``tiny.peel17``, each judged by the limits of the
real cell it stands for. ``trainer_bench`` adds ``tiny.trainer``, the
twin of ``soup1m_16view_1080p.trainer``.
"""

from __future__ import annotations

import json
import shutil

import pytest

from bench_port import harness

REAL_TRAINER = "soup1m_16view_1080p.trainer"
TINY_TRAINER = "tiny.trainer"
STANDS_FOR = {"tiny.train": "soup1m_1080p.train", "tiny.forward": "soup1m_1080p.forward",
              "tiny.peel4": "tetgrid32_1080p.peel8", "tiny.peel17": "tetgrid32_1080p.peel32"}


def _write(path, obj):
    path.write_text(json.dumps(obj))


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    real = harness.BENCH
    for d in ("configs", "mixes", "checks", "metrics", "counts", "loops", "scenes", "cameras",
              "appearances"):
        shutil.copytree(real / d, tmp_path / d)
    shutil.copy(real / "peaks.json", tmp_path / "peaks.json")
    soup = json.loads((real / "configs/soup1m_1080p.json").read_text())
    soup.update(name="tiny_soup", width=40, height=36)
    soup["scene"].update(n_faces=80, size=0.1)
    soup["raster"].update(binning_capacity=1 << 13, num_giant_faces=64)
    _write(tmp_path / "configs/tiny_soup.json", soup)
    tet = json.loads((real / "configs/tetgrid32_1080p.json").read_text())
    tet.update(name="tiny_tet", width=36, height=34)
    tet["scene"]["res"] = 3
    tet["raster"].update(binning_capacity=1 << 14)
    _write(tmp_path / "configs/tiny_tet.json", tet)
    for name in ("train", "forward"):
        mix = json.loads((real / f"mixes/{name}.json").read_text())
        mix.update(warmup=1, trace_iterations=1)
        _write(tmp_path / f"mixes/{name}.json", mix)
    for layers in (4, 17):
        _write(tmp_path / f"mixes/peel{layers}.json",
               dict(loop="peel", num_layers=layers, warmup=1, trace_iterations=1, check_tiles=6))
    spec = harness.load_spec(real.parent)
    cells = []
    for tiny, cell in STANDS_FOR.items():
        shutil.copy(real / f"checks/{cell}.json", tmp_path / f"checks/{tiny}.json")
        cfg = "tiny_soup" if tiny.endswith(("train", "forward")) else "tiny_tet"
        cells.append(dict(name=tiny, config=cfg, traffic=tiny.split(".")[1], chips=1, why="tiny"))
    spec["workloads"] = cells
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [t for t, c in STANDS_FOR.items() if c in m["workloads"]]
    monkeypatch.setattr(harness, "BENCH", tmp_path)
    return spec


@pytest.fixture
def trainer_bench(tiny_bench):
    """``tiny_bench`` with the tiny twin of the trainer cell (the same
    configuration file at 40x36, three views, 80 faces), judged by the
    real cell's limits."""
    root = harness.BENCH
    cfg = json.loads((root / "configs/soup1m_16view_1080p.json").read_text())
    cfg.update(name="tiny_trainer", width=40, height=36)
    cfg["scene"].update(n_faces=80, size=0.1)
    cfg["cameras"]["views"] = 3
    cfg["appearance"]["targets"].update(cells=[3, 4], height=36, width=40)
    cfg["raster"].update(binning_capacity=1 << 13, num_giant_faces=3 * 64)
    (root / "configs/tiny_trainer.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "mixes/trainer.json").read_text())
    mix.update(warmup=2, trace_iterations=2)
    (root / "mixes/trainer.json").write_text(json.dumps(mix))
    (root / f"checks/{TINY_TRAINER}.json").write_text(
        (root / f"checks/{REAL_TRAINER}.json").read_text())
    spec = dict(tiny_bench)
    spec["workloads"] = tiny_bench["workloads"] + [
        dict(name=TINY_TRAINER, config="tiny_trainer", traffic="trainer", chips=1, why="tiny")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] == "step_ms" or m["name"].endswith(".trainer"):
            m["workloads"] = [w for w in m["workloads"] if w != REAL_TRAINER] + [TINY_TRAINER]
    return spec
