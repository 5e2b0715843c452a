"""Scene-driven capacity sizing for the static binning design.

Port of ``dmesh2_renderer_tpu/utils/autotune.py``. The tile binning has
static capacities; this module runs only the cheap geometry prefix (the
renderer's screen-space stage ``geometry.project_faces`` and the tile
rects, no kernels, no sort) on the actual scene and derives a
``RasterConfig`` whose capacities cover it with headroom, the same config
the JAX package derives for the same scene.

Typical use::

    cfg = suggest_config(verts, faces, mv, proj, W, H)
    color, depth, aux = render(..., config=cfg)     # aux.num_truncated == 0
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dmesh2_renderer_tpu_torch import geometry as G
from dmesh2_renderer_tpu_torch.ops.binning import face_tile_rects, tile_grid_size
from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.validate import resolve_device


def scene_binning_stats(verts, faces, mv, proj, width: int, height: int,
                        device=None):
    """Per-scene emission statistics from the geometry prefix only.

    Returns a dict: ``total_emissions`` (sum over views of per-face tile
    counts -- the bbox-rect count, an upper bound on what any cull keeps),
    ``max_tiles`` (largest single-face tile footprint), ``tiles_hist``
    (per-(batch, face) tile counts, flattened numpy), ``grid`` (gx, gy).
    Runs on the card unless ``device`` says otherwise.
    """
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    verts, mv, proj = f32(verts), f32(mv), f32(proj)
    faces = torch.as_tensor(faces, dtype=torch.int32, device=dev)
    verts_ndc, aa = G.project_faces(verts, faces, mv, proj, width, height)
    _, _, _, alive = face_depth01(verts_ndc, faces)
    gx, gy = tile_grid_size(width, height)
    pm = torch.zeros((mv.shape[0], 2), dtype=torch.int32, device=dev)
    _, _, rw, rh = face_tile_rects(aa, pm, gx, gy)
    tiles = torch.where(alive, rw * rh, torch.zeros_like(rw))
    tiles_np = tiles.reshape(-1).cpu().numpy()
    return {
        "total_emissions": int(tiles_np.sum(dtype=np.int64)),
        "max_tiles": int(tiles_np.max()) if tiles_np.size else 0,
        "tiles_hist": tiles_np,
        "grid": (gx, gy),
    }


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


def suggest_config(
    verts, faces, mv, proj, width: int, height: int,
    base: RasterConfig | None = None,
    margin: float = 1.3,
    kt_percentile: float = 99.0,
    device=None,
):
    """Derive static capacities that cover this scene with headroom.

    * ``binning_capacity``: bbox emission count x ``margin``, rounded up to
      1024 (conservative: the exact-overlap cull and behind-camera culls
      only shrink it).
    * ``max_tiles_per_face`` (Kt): the ``kt_percentile`` of per-face tile
      counts, capped at 4x the 90th percentile -- the dense grid stays small
      while only outlier faces spill.
    * ``num_giant_faces`` / ``giant_tiles``: sized so every face above Kt
      fits the giant tier with 2x headroom (camera motion between probe and
      render changes footprints).
    * ``vertex_sort_mode="static"`` unless ``base`` chose otherwise: the
      JAX package's measured-faster reduction for concrete faces. The port
      reduces with ``index_add_`` either way; it keeps the field so that the
      config carries across, and skips the valence guard in that mode as the
      JAX package does.

    ``grad_compact_capacity`` is not derived: the contributing count depends
    on occlusion (a forward-pass quantity). ``base`` carries every
    non-capacity knob through. Geometry changes move footprints; ``margin``
    absorbs drift, and ``aux.num_truncated`` / ``Renderer.forward`` warnings
    remain the contract that overflow is never silent.
    """
    base = base or RasterConfig()
    s = scene_binning_stats(verts, faces, mv, proj, width, height, device=device)
    hist = s["tiles_hist"]
    gx, gy = s["grid"]

    if hist.size == 0 or s["total_emissions"] == 0:
        return dataclasses.replace(base, binning_capacity=1024)

    pos = hist[hist > 0]
    kt = int(np.percentile(pos, kt_percentile)) if pos.size else 1
    kt = min(kt, 4 * max(1, int(np.percentile(pos, 90.0))) if pos.size else kt)
    kt = max(4, min(kt, gx * gy))
    n_giant = int((hist > kt).sum())
    num_giant_faces = _round_up(max(2 * n_giant, 16), 16) if n_giant else 0
    giant_tiles = min(max(s["max_tiles"], kt), gx * gy) if n_giant else None

    capacity = _round_up(int(s["total_emissions"] * margin) + 128, 1024)
    return dataclasses.replace(
        base,
        binning_capacity=capacity,
        max_tiles_per_face=kt,
        num_giant_faces=num_giant_faces,
        giant_tiles=giant_tiles,
        vertex_sort_mode=("static" if base.vertex_sort_mode == "sort"
                          else base.vertex_sort_mode),
    )
