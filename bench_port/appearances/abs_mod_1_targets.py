"""``abs_mod_1_targets``: ``abs_mod_1``'s appearance, then one target image
per view for an optimisation loop (``target_color``, (B, H, W, 3) in
[0, 1)): each channel a grid of ``targets.cells`` (rows, columns) uniform
draws, bilinearly upsampled (corners aligned) to ``targets.height`` x
``targets.width``, so the images vary only at low frequency."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_port.harness import load_module


def make(p, gen, device, parts):
    out = load_module("appearances", "abs_mod_1").make(p, gen, device, parts)
    t = p["targets"]
    rows, cols = (int(n) for n in t["cells"])
    knots = torch.rand((parts["mv"].shape[0], 3, rows, cols), generator=gen, device=device)
    images = F.interpolate(knots, size=(int(t["height"]), int(t["width"])), mode="bilinear",
                           align_corners=True)
    out["target_color"] = images.permute(0, 2, 3, 1).contiguous()
    return out
