"""The plain reference's two pipelines, from the scene's own tensors.

``render`` is the differentiable renderer's frame: projection, the CCW
screen triangles, mean-depth binning, the record table, the forward
compositor and, with ``backward=True``, the gradients of ``color.sum() +
depth.sum()`` with respect to the vertices, vertex colours, face opacities
and intensities: the analytic backward compositor, the reduction, then
autograd of the projection and the screen triangles back to the vertices.
``peel`` is the depth peel of a sample of tiles: projection, min-depth
binning without tile cull, the peel.

Neither reads anything the program made. TF32 is off for every matrix
product; ``precision="tf32"`` computes the camera products with TF32
operands instead (the control).
"""

from __future__ import annotations

import torch

from bench_port.reference.binning import bin_faces, contributing_mask, pack_records
from bench_port.reference.composite import (
    composite_backward, composite_forward, scatter_entry_grads,
)
from bench_port.reference.geometry import face_aa_verts_ccw, face_depth01, init_rays, project
from bench_port.reference.peel import peel_tiles

TRAINABLE = ("verts", "verts_color", "faces_opacity", "faces_intense")


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _binning_args(raster: dict, cull: bool):
    return dict(capacity=raster["binning_capacity"],
                max_tiles_per_face=raster["max_tiles_per_face"],
                num_giant_faces=raster.get("num_giant_faces", 64),
                giant_tiles=raster.get("giant_tiles"),
                exact_tile_cull=cull and raster.get("exact_tile_cull", False))


def render(scene, width: int, height: int, tau: float, raster: dict,
           precision: str = "float32", backward: bool = False) -> dict:
    """Returns color (B, H, W, 3), depth in [0, 1] (larger is nearer),
    ``num_rendered``, ``num_truncated`` (ints), the compositors' ``work``
    and, with ``backward``, ``grads`` by leaf name."""
    _tf32_off()
    verts = scene.verts.detach().clone().requires_grad_(backward)
    with torch.set_grad_enabled(backward):
        ndc, img = project(verts, scene.mv, scene.proj, width, height, precision)
        tris = face_aa_verts_ccw(img, scene.faces)
    with torch.no_grad():
        ray_o, ray_d = init_rays(scene.mv, scene.proj, width, height, precision)
        ray_o_cam = ray_o[:, 0, 0, :].contiguous()
        ndc_d, tris_d, verts_d = ndc.detach(), tris.detach(), verts.detach()
        depth01, _, _, alive = face_depth01(ndc_d, scene.faces)
        binned = bin_faces(tris_d, depth01, alive, width, height, **_binning_args(raster, True))
        records = pack_records(binned.entry_bf, scene.faces, verts_d, scene.verts_color, ndc_d,
                               scene.faces_opacity, scene.faces_intense, tris_d)
        fwd_work = {}
        color, depth_raw, final_t, prev_t, _, nc_tile = composite_forward(
            records, binned.tile_starts, binned.tile_counts, ray_o_cam, ray_d,
            scene.background, width, height, tau, work=fwd_work)
    out = dict(color=color, depth=1.0 - (depth_raw + 1.0) / 2.0,
               num_rendered=int(binned.num_rendered), num_truncated=int(binned.num_truncated),
               work=dict(forward={k: int(v) for k, v in fwd_work.items()},
                         records=records.shape[0], tiles=binned.tile_counts.shape[0]))
    if not backward:
        return out
    with torch.no_grad():
        # The cotangents of color.sum() + depth.sum(): depth = 1 - (raw + 1) / 2.
        g_color = torch.ones_like(color)
        g_depth = torch.full_like(depth_raw, -0.5)
        bwd_work = {}
        grad_records = composite_backward(
            records, binned.tile_starts, binned.tile_counts, nc_tile, ray_o_cam, ray_d,
            scene.background, color, depth_raw, final_t, prev_t, g_color, g_depth,
            torch.zeros_like(final_t), width, height, tau, work=bwd_work)
        keep = contributing_mask(binned.tile_starts, binned.tile_counts, nc_tile,
                                 binned.entry_bf.shape[0])
        d_verts, d_vcolor, d_op, d_ndc_z, d_int, d_tris = scatter_entry_grads(
            grad_records, binned.entry_bf, scene.faces, verts.shape[0], scene.views, keep)
        d_ndc = torch.zeros_like(ndc_d)
        d_ndc[..., 2] = d_ndc_z
    (chain,) = torch.autograd.grad((ndc, tris), verts, (d_ndc, d_tris))
    out["grads"] = dict(verts=d_verts + chain, verts_color=d_vcolor, faces_opacity=d_op,
                        faces_intense=d_int)
    out["work"]["backward"] = {k: int(v) for k, v in bwd_work.items()}
    return out


def peel_binning(scene, width: int, height: int, raster: dict, precision: str = "float32"):
    """Rays (ray_o_cam (B, 3), ray_d (B, H, W, 3)) and the min-depth
    binning of the peel (no tile cull)."""
    _tf32_off()
    with torch.no_grad():
        ray_o, ray_d = init_rays(scene.mv, scene.proj, width, height, precision)
        ndc, img = project(scene.verts, scene.mv, scene.proj, width, height, precision)
        tris = face_aa_verts_ccw(img, scene.faces)
        _, min_depth, _, alive = face_depth01(ndc, scene.faces)
        binned = bin_faces(tris, min_depth, alive, width, height, **_binning_args(raster, False))
    return ray_o[:, 0, 0, :].contiguous(), ray_d, binned


def peel(scene, width: int, height: int, raster: dict, num_layers: int, tiles,
         precision: str = "float32") -> dict:
    """The peel of the tiles ``tiles`` (int64): ``layers`` (N, L) and
    ``counts`` (N,) int32 of their N in-frame pixels, ``pixels`` (N, 3)
    (batch, y, x), ``num_rendered``, ``num_truncated``, and what the peel's
    roofline count reads (``binned``, the rays)."""
    ray_o_cam, ray_d, binned = peel_binning(scene, width, height, raster, precision)
    exist = (scene.exist > 0).to(torch.int32)
    with torch.no_grad():
        layers, counts, pixels = peel_tiles(
            binned.entry_bf, scene.faces, scene.verts, exist, binned.tile_starts,
            binned.tile_counts, ray_o_cam, ray_d, num_layers, tiles)
    return dict(layers=layers, counts=counts, pixels=pixels,
                num_rendered=int(binned.num_rendered), num_truncated=int(binned.num_truncated),
                binned=binned, ray_o_cam=ray_o_cam, ray_d=ray_d, exist=exist)
