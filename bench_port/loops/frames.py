"""``frames``: one iteration is one forward-only frame (``torch.no_grad()``),
timed to its outputs: its latency is the CUDA events around it, after a
synchronise. The check: the last frame's colour and depth."""

from __future__ import annotations

import time

import torch

from bench_port import faults
from bench_port.loop import RendererLoop, render_numbers
from bench_port.reference import render as ref

KERNELS = ("pack_stream", "composite_fwd")
FAULTS = faults.RENDER


class Loop(RendererLoop):
    def step(self) -> float:
        s = self.scene
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with torch.no_grad():
                self.last = self.forward(s.verts, s.verts_color, s.faces_opacity, s.faces_intense)
            end.record()
            end.synchronize()
            return start.elapsed_time(end)
        t0 = time.perf_counter()
        with torch.no_grad():
            self.last = self.forward(s.verts, s.verts_color, s.faces_opacity, s.faces_intense)
        return (time.perf_counter() - t0) * 1e3

    def outputs(self, seed):
        color, depth = self.last
        return dict(color=color, depth=depth, **self.aux_outputs())

    @staticmethod
    def reference(scene, config, mix, precision, prog):
        return ref.render(scene, int(config["width"]), int(config["height"]),
                          float(config["aa_temperature"]), config["raster"], precision)

    @staticmethod
    def compare(prog, reference) -> dict:
        return render_numbers(prog, reference)
