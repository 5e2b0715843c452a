"""Forward tile compositor: the plain version and the CUDA kernel's wrapper.

Port of ``dmesh2_renderer_tpu/ops/pallas_fwd.py::composite_forward``. Both
functions here take the (R, 32) record stream of ``ops/binning.pack_stream``
and the binning's tile ranges and return the same
``(color, depth, final_t, prev_t, n_contrib, nc_tile)`` as the JAX
function, in (B, H, W[, 3]) layout, with ``nc_tile`` the (T,) per-tile
largest contributor rank.

``composite_forward`` runs ``csrc/composite_fwd.cu`` on CUDA tensors and the
plain version on CPU tensors. The plain version walks every tile's list in
step, one entry per step, with all tiles' 256 pixels as (T, 256) planes; it
repeats the kernel's arithmetic in the kernel's operation order. Its
per-pair arithmetic, :func:`pair_quantities`, is shared with the plain
backward compositor, as ``csrc/pair_math.cuh`` is shared by the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dmesh2_renderer_tpu_torch.aa import tri_box_overlap_area_xy
from dmesh2_renderer_tpu_torch.geometry import clamp_bary_uv
from dmesh2_renderer_tpu_torch.ops import _kernels
from dmesh2_renderer_tpu_torch.ops.binning import (
    REC_AA, REC_C, REC_IN, REC_OP, REC_V, REC_Z, tile_grid_size,
)
from dmesh2_renderer_tpu_torch.utils.config import (
    FACE_RECORD_WIDTH, T_EPS, TILE_PIXELS, TILE_X, TILE_Y,
)

# Float operations per (face, pixel) pair that depend on the pixel, counted
# from csrc/composite_fwd.cu and split by how far a pair gets. Every pair a
# pixel still needs pays the bbox test (6). A pair inside the face's bbox
# also pays Moeller-Trumbore dots and divide (19), the clamp (25), the ratio
# and pass tests (6) and, when tau > 0, the AA area (176: 3 edges x 56, sum,
# clip, box). A pair that blends also pays interpolation and blend (37).
# Per-face terms (cross products, edge reciprocals, bbox extremes) are not
# counted.
OPS_PER_PAIR = 6
OPS_PER_BBOX_PAIR = 19 + 25 + 6
OPS_PER_AA_PAIR = 176
OPS_PER_BLEND_PAIR = 37

# Early-exit check period of the plain version (a host sync on the card).
_EXIT_CHECK = 16


def tile_pixels(b, gx, gy, patch_width, patch_height, patch_min, device):
    """Per-(tile, lane) pixel coordinates: batch (T,), x, y, in_patch, and
    the integer pixel-box corners px0, py0 as float (T, 256) planes."""
    n_tiles = b * gx * gy
    tile = torch.arange(n_tiles, device=device)
    bt = tile // (gx * gy)
    rem = tile - bt * (gx * gy)
    ty = rem // gx
    tx = rem - ty * gx
    lane = torch.arange(TILE_PIXELS, device=device)
    x = tx[:, None] * TILE_X + (lane % TILE_X)[None, :]
    y = ty[:, None] * TILE_Y + (lane // TILE_X)[None, :]
    in_patch = (x < patch_width) & (y < patch_height)
    pm = patch_min.long()
    px0 = (pm[bt, 0][:, None] + x).to(torch.float32)
    py0 = (pm[bt, 1][:, None] + y).to(torch.float32)
    return bt, x, y, in_patch, px0, py0


def _untile(planes, b, h, w, gx, gy):
    """(T, 256) tile-major planes -> (B, H, W)."""
    x = planes.reshape(b, gy, gx, TILE_Y, TILE_X).permute(0, 1, 3, 2, 4)
    return x.reshape(b, gy * TILE_Y, gx * TILE_X)[:, :h, :w]


def tile_planes(x, bt, y, xx, in_patch):
    """(B, H, W) per-pixel values -> (T, 256) tile planes, zero outside the
    patch (the pixel grids from :func:`tile_pixels`)."""
    h, w = x.shape[1], x.shape[2]
    v = x[bt[:, None], y.clamp(max=h - 1), xx.clamp(max=w - 1)]
    return torch.where(in_patch, v, torch.zeros_like(v))


class PairQuantities(NamedTuple):
    """Per-(face, pixel) values of one step of the compositor walk.

    Faces are (T, 1) record columns against (T, 256) pixel planes; every
    field is a (T, 256) plane. ``passes`` is every skip test of the blend
    rule except the transmittance test.
    """

    passes: torch.Tensor   # bool: MT valid, AA area > 0, bbox, ratio != 0
    bbox_ok: torch.Tensor  # bool
    u: torch.Tensor        # unclamped Moeller-Trumbore barycentrics
    v: torch.Tensor
    inv: torch.Tensor      # 1 / MT denominator
    code: torch.Tensor     # int32 clamp region
    uc: torch.Tensor       # clamped barycentrics
    vc: torch.Tensor
    ratio: torch.Tensor    # coverage: (1 - tau) * inside + tau * area
    alpha: torch.Tensor    # opacity * ratio
    m_r: torch.Tensor      # interpolated colour, before intensity
    m_g: torch.Tensor
    m_b: torch.Tensor
    i_d: torch.Tensor      # interpolated NDC depth


def pair_quantities(rec, rdx, rdy, rdz, ox, oy, oz, px0, py0, px1, py1,
                    tau: float) -> PairQuantities:
    """The per-pair arithmetic shared by both plain compositors, in the
    operation order of ``csrc/pair_math.cuh``. ``rec``: (T, 32) records."""

    def col(i):
        return rec[:, i:i + 1]

    v0x, v0y, v0z = col(REC_V + 0), col(REC_V + 1), col(REC_V + 2)
    v1x, v1y, v1z = col(REC_V + 3), col(REC_V + 4), col(REC_V + 5)
    v2x, v2y, v2z = col(REC_V + 6), col(REC_V + 7), col(REC_V + 8)
    e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
    e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
    t0x, t0y, t0z = ox - v0x, oy - v0y, oz - v0z
    nx = e2y * e1z - e2z * e1y
    ny = e2z * e1x - e2x * e1z
    nz = e2x * e1y - e2y * e1x
    mx = e2y * t0z - e2z * t0y
    my = e2z * t0x - e2x * t0z
    mz = e2x * t0y - e2y * t0x
    qx = t0y * e1z - t0z * e1y
    qy = t0z * e1x - t0x * e1z
    qz = t0x * e1y - t0y * e1x
    denom = nx * rdx + ny * rdy + nz * rdz
    mt_ok = denom != 0.0
    inv = 1.0 / torch.where(mt_ok, denom, torch.ones_like(denom))
    u = (mx * rdx + my * rdy + mz * rdz) * inv
    v = (qx * rdx + qy * rdy + qz * rdz) * inv
    uc, vc, code = clamp_bary_uv(u, v)
    inside = (code == 0).to(torch.float32)

    ax0, ay0 = col(REC_AA + 0), col(REC_AA + 1)
    ax1, ay1 = col(REC_AA + 2), col(REC_AA + 3)
    ax2, ay2 = col(REC_AA + 4), col(REC_AA + 5)
    txmin = torch.minimum(torch.minimum(ax0, ax1), ax2)
    txmax = torch.maximum(torch.maximum(ax0, ax1), ax2)
    tymin = torch.minimum(torch.minimum(ay0, ay1), ay2)
    tymax = torch.maximum(torch.maximum(ay0, ay1), ay2)
    bbox_ok = (px1 >= txmin) & (px0 <= txmax) & (py1 >= tymin) & (py0 <= tymax)

    if tau > 0.0:
        oarea = tri_box_overlap_area_xy(ax0, ay0, ax1, ay1, ax2, ay2,
                                        px0, px1, py0, py1)
        aa_ok = oarea > 0.0
        ratio = (1.0 - tau) * inside + tau * oarea
    else:
        aa_ok = torch.ones_like(mt_ok)
        ratio = inside
    passes = mt_ok & aa_ok & bbox_ok & (ratio != 0.0)

    i0 = 1.0 - uc - vc
    m_r = i0 * col(REC_C + 0) + uc * col(REC_C + 3) + vc * col(REC_C + 6)
    m_g = i0 * col(REC_C + 1) + uc * col(REC_C + 4) + vc * col(REC_C + 7)
    m_b = i0 * col(REC_C + 2) + uc * col(REC_C + 5) + vc * col(REC_C + 8)
    i_d = i0 * col(REC_Z + 0) + uc * col(REC_Z + 1) + vc * col(REC_Z + 2)
    alpha = col(REC_OP) * ratio
    return PairQuantities(passes, bbox_ok, u, v, inv, code, uc, vc, ratio,
                          alpha, m_r, m_g, m_b, i_d)


def composite_forward_plain(records, tile_starts, tile_counts, ray_o_cam,
                            ray_d, background, patch_min, patch_width: int,
                            patch_height: int, aa_temperature: float,
                            work: dict | None = None):
    """Plain version of the tile compositor (any device).

    If ``work`` is a dict, it receives the work this input needs, as 0-d
    int64 tensors: ``records`` (entries walked until each tile's last pixel
    stops), ``pairs`` ((face, pixel) pairs a pixel still needs),
    ``bbox_pairs`` (of those, inside the face's bbox) and ``blend_pairs``.
    """
    b, h, w, _ = ray_d.shape
    gx, gy = tile_grid_size(patch_width, patch_height)
    dev = records.device
    tau = float(aa_temperature)
    r = records.shape[0]

    bt, x, y, in_patch, px0, py0 = tile_pixels(
        b, gx, gy, patch_width, patch_height, patch_min, dev)
    rdx, rdy, rdz = (tile_planes(ray_d[..., c], bt, y, x, in_patch)
                     for c in range(3))
    o = ray_o_cam[bt]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    px1, py1 = px0 + 1.0, py0 + 1.0

    starts = tile_starts.long()
    counts = tile_counts.long()
    t_run = torch.ones_like(px0)
    pt = torch.ones_like(px0)
    cr, cg, cb, cd = (torch.zeros_like(px0) for _ in range(4))
    nc = torch.zeros(px0.shape, dtype=torch.int32, device=dev)
    if work is not None:
        for key in ("records", "pairs", "bbox_pairs", "blend_pairs"):
            work[key] = torch.zeros((), dtype=torch.int64, device=dev)

    n_steps = int(counts.max()) if counts.numel() else 0
    for k in range(n_steps):
        live = (k < counts)[:, None] & in_patch & (t_run >= T_EPS)
        if k % _EXIT_CHECK == 0 and not bool(live.any()):
            break
        rec = records[torch.clamp(starts + k, max=max(r - 1, 0))]   # (T, 32)
        q = pair_quantities(rec, rdx, rdy, rdz, ox, oy, oz, px0, py0, px1,
                            py1, tau)
        blend = live & q.passes
        if work is not None:
            work["records"] += live.any(dim=1).sum()
            work["pairs"] += live.sum()
            work["bbox_pairs"] += (live & q.bbox_ok).sum()
            work["blend_pairs"] += blend.sum()

        intense = rec[:, REC_IN:REC_IN + 1]
        wgt = q.alpha * t_run
        cr = torch.where(blend, cr + (q.m_r * intense) * wgt, cr)
        cg = torch.where(blend, cg + (q.m_g * intense) * wgt, cg)
        cb = torch.where(blend, cb + (q.m_b * intense) * wgt, cb)
        cd = torch.where(blend, cd + q.i_d * wgt, cd)
        pt = torch.where(blend, t_run, pt)
        t_run = torch.where(blend, t_run * (1.0 - q.alpha), t_run)
        nc = torch.where(blend, torch.full_like(nc, k + 1), nc)

    def out(p):
        return _untile(p, b, h, w, gx, gy)

    color = torch.stack([out(cr + t_run * background[0]),
                         out(cg + t_run * background[1]),
                         out(cb + t_run * background[2])], dim=-1)
    return (color, out(cd + t_run * 1.0), out(t_run), out(pt), out(nc),
            nc.amax(dim=1) if nc.shape[0] else nc.new_zeros((0,)))


def composite_forward(records, tile_starts, tile_counts, ray_o_cam, ray_d,
                      background, patch_min, patch_width: int,
                      patch_height: int, aa_temperature: float):
    """Run the forward compositor.

    Args:
      records: (R, 32) f32 per-entry records (``binning.pack_stream``).
      tile_starts, tile_counts: (T,) int32 tile ranges into ``records``.
      ray_o_cam: (B, 3) camera origins; ray_d: (B, H, W, 3) unit rays.
      background: (3,); patch_min: (B, 2) int32 window origins.
    Returns (color (B,H,W,3), depth, final_t, prev_t, n_contrib (int32),
    nc_tile (T,) int32).
    """
    dev = records.device
    if dev.type == "cpu":
        return composite_forward_plain(
            records, tile_starts, tile_counts, ray_o_cam, ray_d, background,
            patch_min, patch_width, patch_height, aa_temperature)
    b, h, w, _ = ray_d.shape
    if (h, w) != (patch_height, patch_width):
        raise ValueError(f"ray_d is {h}x{w}, patch is {patch_height}x{patch_width}")
    gx, gy = tile_grid_size(patch_width, patch_height)
    n_tiles = b * gx * gy
    r = records.shape[0]
    f32, i32 = torch.float32, torch.int32
    _kernels.check_inputs(dev, [
        ("records", records, f32, (r, FACE_RECORD_WIDTH)),
        ("tile_starts", tile_starts, i32, (n_tiles,)),
        ("tile_counts", tile_counts, i32, (n_tiles,)),
        ("ray_o_cam", ray_o_cam, f32, (b, 3)),
        ("ray_d", ray_d, f32, (b, h, w, 3)),
        ("background", background, f32, (3,)),
        ("patch_min", patch_min, i32, (b, 2)),
    ])
    color = torch.empty((b, h, w, 3), dtype=f32, device=dev)
    depth, final_t, prev_t = (torch.empty((b, h, w), dtype=f32, device=dev)
                              for _ in range(3))
    n_contrib = torch.empty((b, h, w), dtype=i32, device=dev)
    nc_tile = torch.empty((n_tiles,), dtype=i32, device=dev)
    if n_tiles == 0:
        return color, depth, final_t, prev_t, n_contrib, nc_tile
    tau = float(aa_temperature)
    lib = _kernels.COMPOSITE_FWD.load()
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = lib.composite_fwd_launch(
            P(records.data_ptr()), r, P(tile_starts.data_ptr()),
            P(tile_counts.data_ptr()), P(ray_o_cam.data_ptr()),
            P(ray_d.data_ptr()), P(background.data_ptr()),
            P(patch_min.data_ptr()), b, h, w, gx, gy, tau, 1.0 - tau,
            P(color.data_ptr()), P(depth.data_ptr()), P(final_t.data_ptr()),
            P(prev_t.data_ptr()), P(n_contrib.data_ptr()),
            P(nc_tile.data_ptr()), _kernels.current_stream(dev),
        )
    _kernels.COMPOSITE_FWD.launched(err)
    return color, depth, final_t, prev_t, n_contrib, nc_tile
