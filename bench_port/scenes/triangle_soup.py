"""``triangle_soup``: ``n_faces`` independent triangles, centres uniform in
[-extent, extent]^3 and corner offsets normal at scale ``size``, drawn from
the seed on the device (the JAX package's ``bench.py`` soup)."""

from __future__ import annotations

import torch


def make(p, gen, device, parts):
    n, extent, size = int(p["n_faces"]), float(p["extent"]), float(p["size"])
    centers = (torch.rand((n, 1, 3), generator=gen, device=device) * 2.0 - 1.0) * extent
    offsets = torch.randn((n, 3, 3), generator=gen, device=device) * size
    verts = (centers + offsets).reshape(-1, 3).contiguous()
    faces = torch.arange(3 * n, dtype=torch.int32, device=device).reshape(n, 3)
    return dict(verts=verts, faces=faces)
