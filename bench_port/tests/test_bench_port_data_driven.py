"""A new configuration, traffic mix, loop kind, scene or camera generator,
per-layer metric and work count come in as new files and entries alone: no
file the benchmark has is edited."""

from __future__ import annotations

import hashlib
import json
import time

from bench_port import harness
from bench_port.scene import build_scene

# A scene generator: a seeded square grid of small triangles in the plane
# z = 0, each face from three neighbouring grid points; ``rows`` is a part
# that ``Scene`` has no field for.
FAN = '''
import torch


def make(p, gen, device, parts):
    n = int(p["n"])
    xs = torch.linspace(-0.8, 0.8, n, device=device)
    gy, gx = torch.meshgrid(xs, xs, indexing="ij")
    verts = torch.stack([gx, gy, torch.zeros_like(gx)], dim=-1).reshape(-1, 3)
    verts = verts + 0.01 * torch.randn(verts.shape, generator=gen, device=device)
    i = torch.arange(n - 1, device=device)
    a = (i[:, None] * n + i[None, :]).reshape(-1)
    faces = torch.stack([a, a + 1, a + n], dim=1).to(torch.int32)
    return dict(verts=verts.contiguous(), faces=faces, rows=torch.tensor(n))
'''

# A camera generator: one camera on the +z axis looking at the origin.
FRONT = '''
import torch

from bench_port.scene import look_at, perspective


def make(p, gen, device, parts):
    mv = look_at((0.0, 0.0, float(p["distance"])))
    proj = perspective(45.0, 1.0, 0.1, 10.0)
    return dict(mv=torch.as_tensor(mv)[None].to(device),
                proj=torch.as_tensor(proj)[None].to(device))
'''

# A loop kind: forward-only frames whose check is the depth alone.
DEPTH_FRAMES = '''
import torch

from bench_port.loop import RendererLoop, gap
from bench_port.reference import render as ref

KERNELS = ("pack_stream", "composite_fwd")
FAULTS = {}


class Loop(RendererLoop):
    def step(self):
        s = self.scene
        with torch.no_grad():
            self.last = self.forward(s.verts, s.verts_color, s.faces_opacity, s.faces_intense)

    def outputs(self, seed):
        return dict(depth=self.last[1], **self.aux_outputs())

    @staticmethod
    def reference(scene, config, mix, precision, prog):
        return ref.render(scene, int(config["width"]), int(config["height"]),
                          float(config["aa_temperature"]), config["raster"], precision)

    @staticmethod
    def compare(prog, reference):
        return dict(depth_gap=gap(prog["depth"], reference["depth"]),
                    truncated=prog["num_truncated"])
'''


def digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file()}


def cell(name, config, traffic):
    return dict(name=name, config=config, traffic=traffic, chips=1, why="throwaway")


def test_a_new_cell_needs_only_new_files(tiny_bench):
    root = harness.BENCH
    before = digests(root)
    # A throwaway configuration: the tiny tet grid with a third of its faces.
    cfg = json.loads((root / "configs/tiny_tet.json").read_text())
    cfg["name"] = "throwaway_tet"
    cfg["scene"]["exist_fraction"] = 0.33
    (root / "configs/throwaway_tet.json").write_text(json.dumps(cfg))
    # A throwaway mix: the peel at 2 layers.
    (root / "mixes/peel2.json").write_text(json.dumps(
        dict(loop="peel", num_layers=2, warmup=1, trace_iterations=1, check_tiles=4)))
    (root / "checks/throwaway_tet.peel2.json").write_text(json.dumps(
        dict(pixels_differ=0, rendered_gap=0, truncated=0)))
    # A throwaway configuration on a new scene and a new camera generator,
    # run by a new loop kind.
    (root / "scenes/throwaway_fan.py").write_text(FAN)
    (root / "cameras/throwaway_front.py").write_text(FRONT)
    (root / "loops/depth_frames.py").write_text(DEPTH_FRAMES)
    soup = json.loads((root / "configs/tiny_soup.json").read_text())
    fan = dict(soup, name="throwaway_fan", scene=dict(generator="throwaway_fan", n=6),
               cameras=dict(generator="throwaway_front", distance=2.5))
    (root / "configs/throwaway_fan.json").write_text(json.dumps(fan))
    scene = build_scene(fan, 5, "cpu")
    assert scene.views == 1 and int(scene.extra.pop("rows")) == 6 and not scene.extra
    (root / "mixes/depth.json").write_text(json.dumps(
        dict(loop="depth_frames", warmup=1, trace_iterations=1)))
    (root / "checks/throwaway_fan.depth.json").write_text(json.dumps(
        dict(depth_gap=3e-4, truncated=0)))
    # Throwaway metrics: an end-to-end one of the new loop kind's cell, a
    # per-layer one in each new cell; and a throwaway kernel count.
    calls = "def read(run):\n    return float(run.iterations)\n"
    (root / "metrics/calls.peel2.py").write_text(calls)
    (root / "metrics/calls.depth.py").write_text(calls)
    (root / "metrics/depth_frame_ms.py").write_text(
        "from bench_port import readers\n\n\ndef read(run):\n"
        "    return readers.per_iteration_ms(run)\n")
    (root / "counts/throwaway_kernel.py").write_text(
        "PATTERN = r'^no such kernel$'\n\ndef count(run):\n    return None\n")
    spec = dict(tiny_bench)
    spec["workloads"] = tiny_bench["workloads"] + [
        cell("throwaway_tet.peel2", "throwaway_tet", "peel2"),
        cell("throwaway_fan.depth", "throwaway_fan", "depth")]
    spec["end_to_end"] = [dict(m) for m in tiny_bench["end_to_end"]] + [dict(
        name="depth_frame_ms", unit="ms", better="lower", bound=0.05, source="host_clock",
        workloads=["throwaway_fan.depth"])]
    for m in spec["end_to_end"]:
        if m["name"] == "peel_ms":
            m["workloads"] = m["workloads"] + ["throwaway_tet.peel2"]
    expect = {"throwaway_tet.peel2": ("peel_ms", "calls.peel2"),
              "throwaway_fan.depth": ("depth_frame_ms", "calls.depth")}
    spec["per_layer"] = tiny_bench["per_layer"] + [dict(
        name=metric, unit="1", better="higher", source="host_clock", layer="device (H100)",
        moves=e2e, workloads=[c]) for c, (e2e, metric) in expect.items()]
    for c, (e2e, metric) in expect.items():
        for trace in (False, True):
            r = harness.run_cell(spec, c, 5, 0.1, trace, "cpu", time.perf_counter(),
                                 log=lambda m: None)
            assert r["correct"], r["checks"]
            assert set(r["metrics"]) == ({metric} if trace else {"setup_s", e2e})
    assert "throwaway_kernel" in harness.kernel_names()
    after = digests(root)
    assert {p: d for p, d in after.items() if p in before} == before
