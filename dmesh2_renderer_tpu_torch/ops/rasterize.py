"""The rasterization op: binning + record pack + tile compositor (forward).

Port of the forward half of ``dmesh2_renderer_tpu/ops/rasterize.py``
(``_pipeline`` and ``rasterize_fwd_impl``). The differentiable
``torch.autograd.Function`` around it comes with the backward compositor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmesh2_renderer_tpu_torch.ops import reference as ref_ops
from dmesh2_renderer_tpu_torch.ops.binning import Binning, bin_faces, pack_stream
from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig


class RasterAux(NamedTuple):
    num_rendered: torch.Tensor   # () int64: true duplicated-instance count
    num_truncated: torch.Tensor  # () int64: entries dropped by capacity/Kt
    # () int64: entries inside some tile's contributing prefix -- what
    # RasterConfig.grad_compact_capacity must cover for a lossless backward.
    num_grad_contributing: torch.Tensor


def build_stream(verts, verts_color, faces_opacity, verts_ndc, faces_intense,
                 aa_face_verts, faces, patch_min, patch_width: int,
                 patch_height: int, config: RasterConfig):
    """Depth/cull, tile binning and the record pack.

    Returns (Binning, records (R, 32) f32).
    """
    depth01, _, _, alive = ref_ops.face_depth01(verts_ndc, faces)
    binning: Binning = bin_faces(
        aa_face_verts, depth01, alive, patch_min, patch_width, patch_height,
        config.binning_capacity, config.max_tiles_per_face,
        num_giant_faces=config.num_giant_faces,
        giant_tiles=config.giant_tiles,
        exact_tile_cull=config.exact_tile_cull,
    )
    records = pack_stream(binning.entry_bf, faces, verts, verts_color,
                          verts_ndc, faces_opacity, faces_intense,
                          aa_face_verts)
    return binning, records


def make_rasterizer(patch_width: int, patch_height: int, aa_temperature: float,
                    config: RasterConfig):
    """Build the forward rasterize op for one patch shape and config.

    The returned function has signature

        rasterize(verts, verts_color, faces_opacity, verts_ndc,
                  faces_intense, aa_face_verts, faces, background,
                  patch_min, ray_o_cam, ray_d)
        -> (color, depth_raw, final_t, RasterAux)

    with ``faces`` and ``patch_min`` int32 and the rest float32, all on one
    device. ``config.use_pallas=False`` renders with the plain reference
    compositor instead (no binning; the aux counters are zero).
    """
    tau = float(aa_temperature)

    def rasterize(verts, verts_color, faces_opacity, verts_ndc, faces_intense,
                  aa_face_verts, faces, background, patch_min, ray_o_cam,
                  ray_d):
        if not config.use_pallas:
            color, depth, ref_aux = ref_ops.render_reference(
                verts, faces, verts_color, faces_opacity, verts_ndc,
                faces_intense, aa_face_verts, background, patch_min,
                ray_o_cam[:, None, None, :].expand(ray_d.shape), ray_d, tau,
            )
            zero = torch.zeros((), dtype=torch.int64, device=ray_d.device)
            return color, depth, ref_aux.final_t, RasterAux(zero, zero, zero)
        binning, records = build_stream(
            verts, verts_color, faces_opacity, verts_ndc, faces_intense,
            aa_face_verts, faces, patch_min, patch_width, patch_height, config,
        )
        color, depth, final_t, _prev_t, _, nc_tile = composite_forward(
            records, binning.tile_starts, binning.tile_counts,
            ray_o_cam.contiguous(), ray_d, background, patch_min,
            patch_width, patch_height, tau,
        )
        n_contrib_total = torch.minimum(
            binning.tile_counts, torch.clamp(nc_tile, min=0)).sum()
        aux = RasterAux(binning.num_rendered, binning.num_truncated,
                        n_contrib_total)
        return color, depth, final_t, aux

    return rasterize
