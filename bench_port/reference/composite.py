"""Tile compositors of the plain reference, forward and analytic backward,
and the reduction of the backward's per-entry records.

A frozen copy of the renderer's plain compositors. Each walks every tile's
depth-sorted list one entry per step, all tiles' 256 pixels at once as
(T, 256) planes: Moeller-Trumbore, the 7-region barycentric clamp, the
exact AA area, ``alpha = opacity * ((1 - tau) * inside + tau * area)``,
front-to-back blending while the transmittance is >= 1e-4. The backward
replays the blend and writes per entry a 29-column gradient record summed
over the tile's pixels; its vertex gradients are the analytic ones (with
the Moeller-Trumbore dv fix), which depart from autograd of the forward at
the clamp's region boundaries.

With a ``work`` dict the walks count the (entry, pixel) pairs of each
class, which the kernels' roofline counts read.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bench_port.reference.aa import edge_weights, overlap_area
from bench_port.reference.binning import (
    REC_AA, REC_C, REC_IN, REC_OP, REC_V, REC_Z, RECORD_WIDTH, TILE, tile_grid_size,
    tile_lanes,
)
from bench_port.reference.geometry import clamp_bary_uv, clamp_bary_uv_grad

T_EPS = 1e-4
GRAD_COLUMNS = 29
_EXIT_CHECK = 16


def tile_pixels(b, gx, gy, width, height, device):
    """Per-(tile, lane) batch, x, y, in-frame mask and pixel-box corners."""
    bt, x, y, in_frame = tile_lanes(torch.arange(b * gx * gy, device=device),
                                    gx, gy, width, height)
    return bt, x, y, in_frame, x.to(torch.float32), y.to(torch.float32)


def untile(planes, b, h, w, gx, gy):
    """(T, 256) tile-major planes -> (B, H, W)."""
    x = planes.reshape(b, gy, gx, TILE, TILE).permute(0, 1, 3, 2, 4)
    return x.reshape(b, gy * TILE, gx * TILE)[:, :h, :w]


def tile_planes(x, bt, y, xx, in_frame):
    """(B, H, W) -> (T, 256) tile planes, zero outside the frame."""
    h, w = x.shape[1], x.shape[2]
    v = x[bt[:, None], y.clamp(max=h - 1), xx.clamp(max=w - 1)]
    return torch.where(in_frame, v, torch.zeros_like(v))


class Pair(NamedTuple):
    passes: torch.Tensor
    bbox_ok: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    inv: torch.Tensor
    code: torch.Tensor
    uc: torch.Tensor
    vc: torch.Tensor
    ratio: torch.Tensor
    alpha: torch.Tensor
    m_r: torch.Tensor
    m_g: torch.Tensor
    m_b: torch.Tensor
    i_d: torch.Tensor


def pair_quantities(rec, rdx, rdy, rdz, ox, oy, oz, px0, py0, px1, py1, tau: float) -> Pair:
    """One step of the walk: (T, 32) records against (T, 256) pixel planes."""
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
        oarea = overlap_area(ax0, ay0, ax1, ay1, ax2, ay2, px0, px1, py0, py1)
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
    return Pair(passes, bbox_ok, u, v, inv, code, uc, vc, ratio, alpha, m_r, m_g, m_b, i_d)


def _zero_work(work, keys, dev):
    if work is not None:
        for key in keys:
            work[key] = torch.zeros((), dtype=torch.int64, device=dev)


def composite_forward(records, tile_starts, tile_counts, ray_o_cam, ray_d, background,
                      width: int, height: int, tau: float, work: dict | None = None):
    """Returns (color (B,H,W,3), raw depth, final_t, prev_t, n_contrib,
    nc_tile (T,)). ``work`` receives ``records``, ``pairs``, ``bbox_pairs``
    and ``blend_pairs`` (0-d int64)."""
    b = ray_d.shape[0]
    gx, gy = tile_grid_size(width, height)
    dev = records.device
    r = records.shape[0]
    bt, x, y, in_frame, px0, py0 = tile_pixels(b, gx, gy, width, height, dev)
    rdx, rdy, rdz = (tile_planes(ray_d[..., c], bt, y, x, in_frame) for c in range(3))
    o = ray_o_cam[bt]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    px1, py1 = px0 + 1.0, py0 + 1.0
    starts, counts = tile_starts.long(), tile_counts.long()
    t_run = torch.ones_like(px0)
    pt = torch.ones_like(px0)
    cr, cg, cb, cd = (torch.zeros_like(px0) for _ in range(4))
    nc = torch.zeros(px0.shape, dtype=torch.int32, device=dev)
    _zero_work(work, ("records", "pairs", "bbox_pairs", "blend_pairs"), dev)
    n_steps = int(counts.max()) if counts.numel() else 0
    for k in range(n_steps):
        live = (k < counts)[:, None] & in_frame & (t_run >= T_EPS)
        if k % _EXIT_CHECK == 0 and not bool(live.any()):
            break
        rec = records[torch.clamp(starts + k, max=max(r - 1, 0))]
        q = pair_quantities(rec, rdx, rdy, rdz, ox, oy, oz, px0, py0, px1, py1, tau)
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
        return untile(p, b, height, width, gx, gy)

    color = torch.stack([out(cr + t_run * background[0]), out(cg + t_run * background[1]),
                         out(cb + t_run * background[2])], dim=-1)
    return (color, out(cd + t_run * 1.0), out(t_run), out(pt), out(nc),
            nc.amax(dim=1) if nc.shape[0] else nc.new_zeros((0,)))


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def grad_epilogue(red, rec, ox, oy, oz, tau: float):
    """29 pixel sums per entry -> the 29 record columns (N, 32)."""
    def col(i):
        return rec[:, i]

    m_ab, m_a3, m_b1 = red[0:3], red[3:6], red[6:9]
    v0 = [col(REC_V + k) for k in range(3)]
    e1 = [col(REC_V + 3 + k) - v0[k] for k in range(3)]
    e2 = [col(REC_V + 6 + k) - v0[k] for k in range(3)]
    t0 = [o - v0[k] for k, o in enumerate((ox, oy, oz))]
    c_ab_e2, c_t0_b1 = _cross(m_ab, e2), _cross(t0, m_b1)
    c_t0_a3, c_e1_ab = _cross(t0, m_a3), _cross(e1, m_ab)
    c_a3_e2, c_e1_b1 = _cross(m_a3, e2), _cross(e1, m_b1)
    dp1 = [-c_ab_e2[k] - c_t0_b1[k] for k in range(3)]
    dp2 = [c_t0_a3[k] - c_e1_ab[k] for k in range(3)]
    dp0 = [-dp1[k] - dp2[k] - c_a3_e2[k] - c_e1_b1[k] for k in range(3)]
    zero = torch.zeros_like(red[0])
    daa = [zero] * 6
    if tau > 0.0:
        ax = [col(REC_AA + 2 * k) for k in range(3)]
        ay = [col(REC_AA + 2 * k + 1) for k in range(3)]
        daa = []
        for k in range(3):
            e_in = (k + 2) % 3
            r1, r2 = red[23 + 2 * k], red[24 + 2 * e_in]
            dxo, dyo = ax[(k + 1) % 3] - ax[k], ay[(k + 1) % 3] - ay[k]
            dxi, dyi = ax[k] - ax[e_in], ay[k] - ay[e_in]
            daa += [dyo * r1 + dyi * r2, -dxo * r1 - dxi * r2]
    cols = dp0 + dp1 + dp2 + list(red[9:23]) + daa + [zero] * (RECORD_WIDTH - GRAD_COLUMNS)
    return torch.stack(cols, dim=1)


def composite_backward(records, tile_starts, tile_counts, nc_tile, ray_o_cam, ray_d,
                       background, color, depth, final_t, prev_t, g_color, g_depth,
                       g_final_t, width: int, height: int, tau: float,
                       work: dict | None = None):
    """The (R, 32) gradient records of the forward's blend under the
    cotangents ``g_*``. ``work`` receives ``records`` (entries walked),
    ``grad_records`` (with a blending pixel), ``pairs``, ``bbox_pairs`` and
    ``blend_pairs``."""
    b = ray_d.shape[0]
    gx, gy = tile_grid_size(width, height)
    dev = records.device
    r = records.shape[0]
    out = torch.zeros((r, RECORD_WIDTH), dtype=torch.float32, device=dev)
    bt, x, y, in_frame, px0, py0 = tile_pixels(b, gx, gy, width, height, dev)
    px1, py1 = px0 + 1.0, py0 + 1.0

    def plane(p):
        return tile_planes(p, bt, y, x, in_frame)

    rdx, rdy, rdz = (plane(ray_d[..., c]) for c in range(3))
    g_r, g_g, g_b = (plane(g_color[..., c]) for c in range(3))
    g_d, g_t = plane(g_depth), plane(g_final_t)
    cn = color - final_t[..., None] * background
    cn_r, cn_g, cn_b = (plane(cn[..., c]) for c in range(3))
    dn = plane(depth - final_t)
    t_fin, pt_fin = plane(final_t), plane(prev_t)
    bg_dot = background[0] * g_r + background[1] * g_g + background[2] * g_b + g_d + g_t
    o = ray_o_cam[bt]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    starts = tile_starts.long()
    n_loop = torch.minimum(tile_counts.long(), torch.clamp(nc_tile.long(), min=0))
    t_run = torch.ones_like(px0)
    p_r, p_g, p_b, p_d = (torch.zeros_like(px0) for _ in range(4))
    zero = torch.zeros_like(px0)
    _zero_work(work, ("records", "grad_records", "pairs", "bbox_pairs", "blend_pairs"), dev)

    n_steps = int(n_loop.max()) if n_loop.numel() else 0
    for k in range(n_steps):
        in_loop = k < n_loop
        live = in_loop[:, None] & in_frame & (t_run >= T_EPS)
        rows = torch.clamp(starts + k, max=max(r - 1, 0))
        rec = records[rows]
        q = pair_quantities(rec, rdx, rdy, rdz, ox, oy, oz, px0, py0, px1, py1, tau)
        active = live & q.passes
        if work is not None:
            work["records"] += in_loop.sum()
            work["grad_records"] += active.any(dim=1).sum()
            work["pairs"] += live.sum()
            work["bbox_pairs"] += (live & q.bbox_ok).sum()
            work["blend_pairs"] += active.sum()

        def col(i):
            return rec[:, i:i + 1]

        alpha = q.alpha
        intense = col(REC_IN)
        wgt = alpha * t_run
        ic_r, ic_g, ic_b = q.m_r * intense, q.m_g * intense, q.m_b * intense
        p_r = torch.where(active, p_r + ic_r * wgt, p_r)
        p_g = torch.where(active, p_g + ic_g * wgt, p_g)
        p_b = torch.where(active, p_b + ic_b * wgt, p_b)
        p_d = torch.where(active, p_d + q.i_d * wgt, p_d)
        t_before = t_run
        t_after = t_run * (1.0 - alpha)
        t_run = torch.where(active, t_after, t_run)

        pos = t_after > 0.0
        inv_after = torch.where(pos, 1.0 / torch.where(pos, t_after, 1.0), 0.0)
        ar_r = (cn_r - p_r) * inv_after
        ar_g = (cn_g - p_g) * inv_after
        ar_b = (cn_b - p_b) * inv_after
        ar_d = (dn - p_d) * inv_after
        dl_da = t_before * ((ic_r - ar_r) * g_r + (ic_g - ar_g) * g_g
                            + (ic_b - ar_b) * g_b + (q.i_d - ar_d) * g_d)
        below = alpha < 1.0
        bg_fac = torch.where(below, -t_fin / torch.where(below, 1.0 - alpha, 1.0), -pt_fin)
        dl_da = dl_da + bg_fac * bg_dot

        dic_r, dic_g, dic_b, did = g_r * wgt, g_g * wgt, g_b * wgt, g_d * wgt
        i0 = 1.0 - q.uc - q.vc
        fields = [None] * GRAD_COLUMNS
        for vi, ik in enumerate((i0, q.uc, q.vc)):
            fields[9 + 3 * vi + 0] = (ik * dic_r) * intense
            fields[9 + 3 * vi + 1] = (ik * dic_g) * intense
            fields[9 + 3 * vi + 2] = (ik * dic_b) * intense
            fields[20 + vi] = ik * did
        fields[18] = dl_da * q.ratio
        fields[19] = q.m_r * dic_r + q.m_g * dic_g + q.m_b * dic_b

        dl_di = [(col(REC_C + 3 * vi) * dic_r + col(REC_C + 3 * vi + 1) * dic_g
                  + col(REC_C + 3 * vi + 2) * dic_b) * intense + col(REC_Z + vi) * did
                 for vi in range(3)]
        duc_du, duc_dv, dvc_du, dvc_dv = clamp_bary_uv_grad(q.code)
        dl_duc = dl_di[1] - dl_di[0]
        dl_dvc = dl_di[2] - dl_di[0]
        dl_du = dl_duc * duc_du + dl_dvc * dvc_du
        dl_dv = dl_duc * duc_dv + dl_dvc * dvc_dv
        s_ab = (dl_du * q.u + dl_dv * q.v) * q.inv
        s_a3 = dl_du * q.inv
        s_b1 = dl_dv * q.inv
        for m, s in enumerate((s_ab, s_a3, s_b1)):
            fields[3 * m + 0] = s * rdx
            fields[3 * m + 1] = s * rdy
            fields[3 * m + 2] = s * rdz
        if tau > 0.0:
            dl_doarea = (dl_da * col(REC_OP)) * tau
            jw = edge_weights(col(REC_AA + 0), col(REC_AA + 1), col(REC_AA + 2),
                              col(REC_AA + 3), col(REC_AA + 4), col(REC_AA + 5),
                              px0, px1, py0, py1)
            for e in range(3):
                fields[23 + 2 * e] = dl_doarea * jw[e][0]
                fields[24 + 2 * e] = dl_doarea * jw[e][1]
        else:
            for c in range(23, 29):
                fields[c] = zero
        red = [torch.where(active, f, zero).sum(dim=1) for f in fields]
        row = grad_epilogue(red, rec, ox[:, 0], oy[:, 0], oz[:, 0], tau)
        out[rows[in_loop]] = row[in_loop]
    return out


def scatter_entry_grads(grad_records, entry_bf, faces, n_verts: int, n_batch: int, keep):
    """Sum the contributing rows per (batch, face), then per face and onto
    the vertices: (d_verts (P, 3), d_verts_color (P, 3), d_opacity (F,),
    d_ndc_z (B, P), d_intense (B, F), d_tris (B, F, 3, 2))."""
    f = faces.shape[0]
    bf = n_batch * f
    rows = ((entry_bf < bf) & keep).nonzero().squeeze(1)
    d_face = torch.zeros((bf, GRAD_COLUMNS), dtype=torch.float32, device=grad_records.device)
    d_face.index_add_(0, entry_bf[rows].long(), grad_records[rows, :GRAD_COLUMNS])
    d_face = d_face.reshape(n_batch, f, GRAD_COLUMNS)
    d_fsum = d_face.sum(dim=0)
    fl = faces.long()
    d_verts = d_face.new_zeros((n_verts, 3))
    d_vcolor = d_face.new_zeros((n_verts, 3))
    d_ndc_z = d_face.new_zeros((n_batch, n_verts))
    for k in range(3):
        d_verts.index_add_(0, fl[:, k], d_fsum[:, REC_V + 3 * k:REC_V + 3 * k + 3])
        d_vcolor.index_add_(0, fl[:, k], d_fsum[:, REC_C + 3 * k:REC_C + 3 * k + 3])
        d_ndc_z.index_add_(1, fl[:, k], d_face[:, :, REC_Z + k])
    return (d_verts, d_vcolor, d_fsum[:, REC_OP], d_ndc_z, d_face[:, :, REC_IN],
            d_face[:, :, REC_AA:REC_AA + 6].reshape(n_batch, f, 3, 2))
