"""``abs_mod_1``: vertex colours |v| mod 1 (the JAX package's ``bench.py``),
every face at ``opacity`` and, in every view, at ``intensity``; a
``background`` colour."""

from __future__ import annotations

import torch


def make(p, gen, device, parts):
    verts, n_faces, views = parts["verts"], parts["faces"].shape[0], parts["mv"].shape[0]
    return dict(
        verts_color=torch.remainder(verts.abs(), 1.0),
        faces_opacity=torch.full((n_faces,), float(p["opacity"]), device=device),
        faces_intense=torch.full((views, n_faces), float(p["intensity"]), device=device),
        background=torch.tensor(p["background"], dtype=torch.float32, device=device),
    )
