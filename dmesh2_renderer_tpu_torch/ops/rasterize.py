"""The differentiable rasterization op: binning + record pack + tile
compositors, behind a ``torch.autograd.Function``.

Port of ``dmesh2_renderer_tpu/ops/rasterize.py`` (``_pipeline``,
``rasterize_fwd_impl`` and its ``jax.custom_vjp``). The forward bins the
faces, packs the records and composites; it keeps the record stream, the
tile ranges, the per-tile contributor ranks and the per-pixel outputs for
the backward. The backward runs the backward compositor (the kernel on CUDA
tensors, its plain version on CPU tensors) and reduces its per-entry
records to the gradients of the first six inputs, as the JAX op does. A
backward on CUDA tensors launches ``csrc/composite_bwd.cu`` and
``csrc/grad_reduce.cu`` or raises. The op calls ``bin_faces``,
``pack_stream``, ``composite_forward`` and ``composite_backward`` through
this module's globals, so that a test or a benchmark can replace one by
setting the module attribute.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmesh2_renderer_tpu_torch.ops import reference as ref_ops
from dmesh2_renderer_tpu_torch.ops.binning import Binning, bin_faces, pack_stream
from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
    composite_backward, reduce_entry_grads,
)
from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.profiling import span


class RasterAux(NamedTuple):
    num_rendered: torch.Tensor   # () int64: true duplicated-instance count
    num_truncated: torch.Tensor  # () int64: entries dropped by capacity/Kt
    # () int64: entries inside some tile's contributing prefix -- what the
    # JAX package's RasterConfig.grad_compact_capacity must cover.
    num_grad_contributing: torch.Tensor


def build_stream(verts, verts_color, faces_opacity, verts_ndc, faces_intense,
                 aa_face_verts, faces, patch_min, patch_width: int,
                 patch_height: int, config: RasterConfig):
    """Depth/cull, tile binning and the record pack.

    Returns (Binning, records (R, 32) f32).
    """
    with span("prep"):
        depth01, _, _, alive = ref_ops.face_depth01(verts_ndc, faces)
    with span("binning"):
        binning: Binning = bin_faces(
            aa_face_verts, depth01, alive, patch_min, patch_width, patch_height,
            config.binning_capacity, config.max_tiles_per_face,
            num_giant_faces=config.num_giant_faces,
            giant_tiles=config.giant_tiles,
            exact_tile_cull=config.exact_tile_cull,
        )
    with span("pack"):
        records = pack_stream(binning.entry_bf, faces, verts, verts_color,
                              verts_ndc, faces_opacity, faces_intense,
                              aa_face_verts)
    return binning, records


class Rasterize(torch.autograd.Function):
    """Forward compositor with the analytic backward (kernels on CUDA).

    Differentiable inputs: verts, verts_color, faces_opacity, verts_ndc,
    faces_intense, aa_face_verts. Outputs: color, depth_raw, final_t (all
    differentiable) and the three aux counters (not).
    """

    @staticmethod
    def forward(ctx, verts, verts_color, faces_opacity, verts_ndc,
                faces_intense, aa_face_verts, faces, background, patch_min,
                ray_o_cam, ray_d, patch_width, patch_height, tau, config):
        ray_o_cam = ray_o_cam.contiguous()
        binning, records = build_stream(
            verts, verts_color, faces_opacity, verts_ndc, faces_intense,
            aa_face_verts, faces, patch_min, patch_width, patch_height, config,
        )
        with span("fwd_kernel"):
            color, depth, final_t, prev_t, _, nc_tile = composite_forward(
                records, binning.tile_starts, binning.tile_counts, ray_o_cam,
                ray_d, background, patch_min, patch_width, patch_height, tau,
            )
            n_contrib_total = torch.minimum(
                binning.tile_counts, torch.clamp(nc_tile, min=0)).sum()
        ctx.save_for_backward(
            records, binning.entry_bf, binning.tile_starts, binning.tile_counts,
            nc_tile, color, depth, final_t, prev_t, faces, background,
            patch_min, ray_o_cam, ray_d)
        ctx.statics = (patch_width, patch_height, tau, verts.shape[0],
                       verts_ndc.shape)
        aux = (binning.num_rendered, binning.num_truncated, n_contrib_total)
        ctx.mark_non_differentiable(*aux)
        return (color, depth, final_t, *aux)

    @staticmethod
    def backward(ctx, g_color, g_depth, g_final_t, *_aux_grads):
        (records, entry_bf, starts, counts, nc_tile, color, depth, final_t,
         prev_t, faces, background, patch_min, ray_o_cam,
         ray_d) = ctx.saved_tensors
        patch_width, patch_height, tau, n_verts, ndc_shape = ctx.statics

        def cotangent(g, like):
            return torch.zeros_like(like) if g is None else g.contiguous()

        with span("backward"):
            with span("bwd_kernel"):
                grad_records = composite_backward(
                    records, starts, counts, nc_tile, ray_o_cam, ray_d,
                    background, patch_min, color, depth, final_t, prev_t,
                    cotangent(g_color, color), cotangent(g_depth, depth),
                    cotangent(g_final_t, final_t), patch_width, patch_height,
                    tau,
                )
            with span("scatter"):
                # NDC x/y reach the loss only through aa_face_verts: d_vndc's
                # x and y are zero.
                d_verts, d_vcolor, d_op, d_vndc, d_int, d_aa = reduce_entry_grads(
                    grad_records, entry_bf, starts, counts, nc_tile, faces,
                    n_verts, ndc_shape[0])
        return (d_verts, d_vcolor, d_op, d_vndc, d_int, d_aa,
                None, None, None, None, None, None, None, None, None)


def make_rasterizer(patch_width: int, patch_height: int, aa_temperature: float,
                    config: RasterConfig):
    """Build the rasterize op for one patch shape and config.

    The returned function has signature

        rasterize(verts, verts_color, faces_opacity, verts_ndc,
                  faces_intense, aa_face_verts, faces, background,
                  patch_min, ray_o_cam, ray_d)
        -> (color, depth_raw, final_t, RasterAux)

    with ``faces`` and ``patch_min`` int32 and the rest float32, all on one
    device, and gradients defined for the first six arguments (the
    background gets none, as in the JAX op). ``final_t`` is a
    differentiable output: its cotangent joins the background term of the
    backward. ``config.use_pallas=False`` renders with the plain reference
    compositor instead (no binning; the aux counters are zero), which
    autograd differentiates.
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
        color, depth, final_t, *aux = Rasterize.apply(
            verts, verts_color, faces_opacity, verts_ndc, faces_intense,
            aa_face_verts, faces, background, patch_min, ray_o_cam, ray_d,
            patch_width, patch_height, tau, config,
        )
        return color, depth, final_t, RasterAux(*aux)

    return rasterize
