"""Backward tile compositor and the reduction of its per-entry records.

Port of ``dmesh2_renderer_tpu/ops/pallas_bwd.py``. ``composite_backward``
replays each tile's forward blend front to back and writes, for every entry
of the tile's contributing prefix, a 29-column gradient record summed over
the tile's 256 pixels, into that entry's row of an (R, 32) table (the JAX
function's ``blocked=False`` layout; columns 29-31 are zero). On CUDA
tensors every row outside the contributing prefixes is left unset; the
plain version's are zero. The columns mirror the face record
(``REC_*``): 9 vertex-position, 9 vertex-colour, opacity, intensity, 3
vertex NDC-z and 6 AA-corner gradients.

``composite_backward`` runs ``csrc/composite_bwd.cu`` on CUDA tensors and
the plain version on CPU tensors. The plain version walks every tile's list
in step, like the plain forward, and shares its per-pair arithmetic
(``composite_fwd.pair_quantities``), so the replay takes the forward's blend
decisions.

``reduce_entry_grads`` reduces the records of the contributing prefixes to
the six input gradients: on CUDA tensors ``csrc/grad_reduce.cu`` adds each
record once, in place, to its destinations with atomics (no mask, no
compaction, no host sync), so the backward's table needs no zeros outside
the prefixes; on CPU tensors its plain version, ``contributing_mask`` and
then ``scatter_entry_grads``, the JAX function's counterpart, which sums
the rows a mask keeps with ``index_add_`` and sends the rest to a dropped
row (no compaction, no host sync). The JAX package's sorts and segmented
scans exist only because scatters are slow on the TPU.
"""

from __future__ import annotations

import ctypes

import torch

from dmesh2_renderer_tpu_torch.aa import tri_box_edge_weights_xy
from dmesh2_renderer_tpu_torch.geometry import clamp_bary_uv_grad
from dmesh2_renderer_tpu_torch.ops import _kernels
from dmesh2_renderer_tpu_torch.ops.binning import (
    REC_AA, REC_C, REC_IN, REC_OP, REC_V, REC_Z, contributing_mask,
    tile_grid_size,
)
from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
    pair_quantities, tile_pixels, tile_planes,
)
from dmesh2_renderer_tpu_torch.utils.config import (
    FACE_RECORD_WIDTH, GRAD_RECORD_WIDTH, T_EPS,
)

# Columns of a gradient record that carry values (the rest are zero).
GRAD_COLUMNS = 29

# Float operations that the backward kernel adds to the forward's replay
# (composite_fwd.OPS_PER_*, which it pays again), counted from
# csrc/composite_bwd.cu. A blending (entry, pixel) pair pays dL/dalpha with
# its suffix terms and the cotangent weights (32), the colour, depth,
# intensity and opacity fields (29), the barycentric chain with the clamp
# Jacobian (35) and the three Moeller-Trumbore moments (15); at tau > 0
# also the AA edge weights (3 x 45) and their fields (8). Each entry of a contributing prefix with a
# blending pixel pays the block sum of its 29 fields over 256 pixels (29 x
# 255 adds) and the cross-product and edge epilogue (84 + 33).
OPS_PER_GRAD_PAIR = 111
OPS_PER_AA_GRAD_PAIR = 143
OPS_PER_GRAD_ENTRY = GRAD_COLUMNS * 255 + 117


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def grad_epilogue(red, rec, ox, oy, oz, tau: float):
    """Per-entry epilogue: 29 pixel sums -> the 29 record columns.

    ``red``: list of 29 (N,) sums in the kernel's order -- the moments
    M_ab, M_a3, M_b1 (3 each), the 14 direct columns 9..22, then the AA
    edge weights r1_0, r2_0, r1_1, r2_1, r1_2, r2_2. ``rec``: (N, 32) face
    records; ``ox, oy, oz``: (N,) ray origins. Returns (N, 32).
    """
    def col(i):
        return rec[:, i]

    m_ab, m_a3, m_b1 = red[0:3], red[3:6], red[6:9]
    v0 = [col(REC_V + k) for k in range(3)]
    e1 = [col(REC_V + 3 + k) - v0[k] for k in range(3)]
    e2 = [col(REC_V + 6 + k) - v0[k] for k in range(3)]
    t0 = [o - v0[k] for k, o in enumerate((ox, oy, oz))]
    c_ab_e2 = _cross(m_ab, e2)
    c_t0_b1 = _cross(t0, m_b1)
    c_t0_a3 = _cross(t0, m_a3)
    c_e1_ab = _cross(e1, m_ab)
    c_a3_e2 = _cross(m_a3, e2)
    c_e1_b1 = _cross(e1, m_b1)
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
            e_in = (k + 2) % 3          # edges ending at / starting at k
            r1, r2 = red[23 + 2 * k], red[24 + 2 * e_in]
            dxo = ax[(k + 1) % 3] - ax[k]
            dyo = ay[(k + 1) % 3] - ay[k]
            dxi = ax[k] - ax[e_in]
            dyi = ay[k] - ay[e_in]
            daa += [dyo * r1 + dyi * r2, -dxo * r1 - dxi * r2]
    cols = dp0 + dp1 + dp2 + list(red[9:23]) + daa
    cols += [zero] * (GRAD_RECORD_WIDTH - GRAD_COLUMNS)
    return torch.stack(cols, dim=1)


def composite_backward_plain(records, tile_starts, tile_counts, nc_tile,
                             ray_o_cam, ray_d, background, patch_min, color,
                             depth, final_t, prev_t, g_color, g_depth,
                             g_final_t, patch_width: int, patch_height: int,
                             aa_temperature: float, work: dict | None = None):
    """Plain version of the backward compositor (any device).

    If ``work`` is a dict, it receives the work this input needs, as 0-d
    int64 tensors: ``records`` (entries walked: the contributing prefixes),
    ``grad_records`` (of those, entries with a blending pixel), ``pairs``
    ((entry, pixel) pairs a pixel still needs), ``bbox_pairs`` (of those,
    inside the face's bbox) and ``blend_pairs``.
    """
    b, h, w, _ = ray_d.shape
    gx, gy = tile_grid_size(patch_width, patch_height)
    dev = records.device
    tau = float(aa_temperature)
    r = records.shape[0]
    out = torch.zeros((r, GRAD_RECORD_WIDTH), dtype=torch.float32, device=dev)

    bt, x, y, in_patch, px0, py0 = tile_pixels(
        b, gx, gy, patch_width, patch_height, patch_min, dev)
    px1, py1 = px0 + 1.0, py0 + 1.0

    def plane(p):
        return tile_planes(p, bt, y, x, in_patch)

    rdx, rdy, rdz = (plane(ray_d[..., c]) for c in range(3))
    g_r, g_g, g_b = (plane(g_color[..., c]) for c in range(3))
    g_d, g_t = plane(g_depth), plane(g_final_t)
    cn = color - final_t[..., None] * background
    cn_r, cn_g, cn_b = (plane(cn[..., c]) for c in range(3))
    dn = plane(depth - final_t)
    t_fin, pt_fin = plane(final_t), plane(prev_t)
    bg_dot = (background[0] * g_r + background[1] * g_g + background[2] * g_b
              + g_d + g_t)
    o = ray_o_cam[bt]
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]

    starts = tile_starts.long()
    n_loop = torch.minimum(tile_counts.long(), torch.clamp(nc_tile.long(), min=0))
    t_run = torch.ones_like(px0)
    p_r, p_g, p_b, p_d = (torch.zeros_like(px0) for _ in range(4))
    zero = torch.zeros_like(px0)
    if work is not None:
        for key in ("records", "grad_records", "pairs", "bbox_pairs",
                    "blend_pairs"):
            work[key] = torch.zeros((), dtype=torch.int64, device=dev)

    n_steps = int(n_loop.max()) if n_loop.numel() else 0
    for k in range(n_steps):
        in_loop = k < n_loop                                      # (T,)
        live = in_loop[:, None] & in_patch & (t_run >= T_EPS)
        rows = torch.clamp(starts + k, max=max(r - 1, 0))
        rec = records[rows]                                       # (T, 32)
        q = pair_quantities(rec, rdx, rdy, rdz, ox, oy, oz, px0, py0, px1,
                            py1, tau)
        active = live & q.passes
        if work is not None:
            work["records"] += in_loop.sum()
            work["grad_records"] += active.any(dim=1).sum()
            work["pairs"] += live.sum()
            work["bbox_pairs"] += (live & q.bbox_ok).sum()
            work["blend_pairs"] += active.sum()

        def col(i):
            return rec[:, i:i + 1]

        def masked(v):
            return torch.where(active, v, zero)

        # Replay: the forward's blend, with its prefix sums.
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

        # dL/dalpha: colour and depth against the suffix behind the face,
        # plus the background / final_t term.
        pos = t_after > 0.0
        inv_after = torch.where(pos, 1.0 / torch.where(pos, t_after, 1.0), 0.0)
        ar_r = (cn_r - p_r) * inv_after
        ar_g = (cn_g - p_g) * inv_after
        ar_b = (cn_b - p_b) * inv_after
        ar_d = (dn - p_d) * inv_after
        dl_da = t_before * ((ic_r - ar_r) * g_r + (ic_g - ar_g) * g_g
                            + (ic_b - ar_b) * g_b + (q.i_d - ar_d) * g_d)
        below = alpha < 1.0
        bg_fac = torch.where(
            below, -t_fin / torch.where(below, 1.0 - alpha, 1.0), -pt_fin)
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
                  + col(REC_C + 3 * vi + 2) * dic_b) * intense
                 + col(REC_Z + vi) * did for vi in range(3)]
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
            jw = tri_box_edge_weights_xy(
                col(REC_AA + 0), col(REC_AA + 1), col(REC_AA + 2),
                col(REC_AA + 3), col(REC_AA + 4), col(REC_AA + 5),
                px0, px1, py0, py1)
            for e in range(3):
                fields[23 + 2 * e] = dl_doarea * jw[e][0]
                fields[24 + 2 * e] = dl_doarea * jw[e][1]
        else:
            for c in range(23, 29):
                fields[c] = zero

        red = [masked(f).sum(dim=1) for f in fields]
        row = grad_epilogue(red, rec, ox[:, 0], oy[:, 0], oz[:, 0], tau)
        out[rows[in_loop]] = row[in_loop]
    return out


def composite_backward(records, tile_starts, tile_counts, nc_tile, ray_o_cam,
                       ray_d, background, patch_min, color, depth, final_t,
                       prev_t, g_color, g_depth, g_final_t, patch_width: int,
                       patch_height: int, aa_temperature: float):
    """Run the backward compositor.

    Args:
      records: (R, 32) f32 face records; tile_starts, tile_counts,
        nc_tile: (T,) int32 tile ranges and the forward's per-tile largest
        contributor rank.
      ray_o_cam: (B, 3); ray_d: (B, H, W, 3); background: (3,);
        patch_min: (B, 2) int32.
      color (B, H, W, 3), depth, final_t, prev_t (B, H, W): forward outputs.
      g_color, g_depth, g_final_t: their cotangents, same shapes.
    Returns the (R, 32) f32 gradient records. On CUDA tensors the kernel
    writes each row of the contributing prefixes whole and leaves every
    other row unset, as the backward wants (``reduce_entry_grads`` never
    reads them): compare such tables through
    ``binning.contributing_mask``. On CPU tensors the plain version's rows
    outside the prefixes are zero.
    """
    dev = records.device
    args = (records, tile_starts, tile_counts, nc_tile, ray_o_cam, ray_d,
            background, patch_min, color, depth, final_t, prev_t, g_color,
            g_depth, g_final_t)
    if dev.type == "cpu":
        return composite_backward_plain(*args, patch_width, patch_height,
                                        aa_temperature)
    b, h, w, _ = ray_d.shape
    if (h, w) != (patch_height, patch_width):
        raise ValueError(f"ray_d is {h}x{w}, patch is {patch_height}x{patch_width}")
    gx, gy = tile_grid_size(patch_width, patch_height)
    n_tiles = b * gx * gy
    r = records.shape[0]
    f32, i32 = torch.float32, torch.int32
    pix = (b, h, w)
    _kernels.check_inputs(dev, [
        ("records", records, f32, (r, FACE_RECORD_WIDTH)),
        ("tile_starts", tile_starts, i32, (n_tiles,)),
        ("tile_counts", tile_counts, i32, (n_tiles,)),
        ("nc_tile", nc_tile, i32, (n_tiles,)),
        ("ray_o_cam", ray_o_cam, f32, (b, 3)),
        ("ray_d", ray_d, f32, (b, h, w, 3)),
        ("background", background, f32, (3,)),
        ("patch_min", patch_min, i32, (b, 2)),
        ("color", color, f32, (b, h, w, 3)),
        ("depth", depth, f32, pix),
        ("final_t", final_t, f32, pix),
        ("prev_t", prev_t, f32, pix),
        ("g_color", g_color, f32, (b, h, w, 3)),
        ("g_depth", g_depth, f32, pix),
        ("g_final_t", g_final_t, f32, pix),
    ])
    _kernels.check_aligned("records", records)
    out = torch.empty((r, GRAD_RECORD_WIDTH), dtype=f32, device=dev)
    if n_tiles == 0 or r == 0:
        return out
    tau = float(aa_temperature)
    lib = _kernels.COMPOSITE_BWD.load()
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = lib.composite_bwd_launch(
            P(records.data_ptr()), r, P(tile_starts.data_ptr()),
            P(tile_counts.data_ptr()), P(nc_tile.data_ptr()),
            P(ray_o_cam.data_ptr()), P(ray_d.data_ptr()),
            P(background.data_ptr()), P(patch_min.data_ptr()),
            P(color.data_ptr()), P(depth.data_ptr()), P(final_t.data_ptr()),
            P(prev_t.data_ptr()), P(g_color.data_ptr()), P(g_depth.data_ptr()),
            P(g_final_t.data_ptr()), b, h, w, gx, gy, tau, 1.0 - tau,
            P(out.data_ptr()), _kernels.current_stream(dev),
        )
    _kernels.COMPOSITE_BWD.launched(err)
    return out


def scatter_entry_grads(grad_records, entry_bf, faces, n_verts: int,
                        n_batch: int, keep=None):
    """Reduce per-entry gradient records to the six input gradients (plain).

    Rows outside ``keep`` (the contributing mask of
    ``binning.contributing_mask``; None keeps every row) and sentinel rows
    (``entry_bf == B*F``) are sent to one extra row that is dropped; the
    rest are summed per (batch, face) with ``index_add_``, then per face
    over the batch and onto the shared vertices. No compaction, so no host
    sync; a dropped row is read but never reaches an output. Every kept row
    is reduced: nothing is dropped for capacity. On CUDA ``index_add_``
    sums with atomics, so the order of the additions, and so the last bits
    of a sum, change from run to run.

    Returns (d_verts (P, 3), d_verts_color (P, 3), d_faces_opacity (F,),
    d_verts_ndc_z (B, P), d_faces_intense (B, F), d_aa_face_verts
    (B, F, 3, 2)).
    """
    f = faces.shape[0]
    bf = n_batch * f
    valid = entry_bf < bf
    if keep is not None:
        valid = valid & keep
    target = torch.where(valid, entry_bf.long(), bf)
    d_face = torch.zeros((bf + 1, GRAD_COLUMNS), dtype=torch.float32,
                         device=grad_records.device)
    d_face.index_add_(0, target, grad_records[:, :GRAD_COLUMNS])
    d_face = d_face[:bf].reshape(n_batch, f, GRAD_COLUMNS)
    d_fsum = d_face.sum(dim=0)                                  # (F, 29)

    fl = faces.long()
    d_verts = d_face.new_zeros((n_verts, 3))
    d_vcolor = d_face.new_zeros((n_verts, 3))
    d_vndc_z = d_face.new_zeros((n_batch, n_verts))
    for k in range(3):
        d_verts.index_add_(0, fl[:, k], d_fsum[:, REC_V + 3 * k:REC_V + 3 * k + 3])
        d_vcolor.index_add_(0, fl[:, k], d_fsum[:, REC_C + 3 * k:REC_C + 3 * k + 3])
        d_vndc_z.index_add_(1, fl[:, k], d_face[:, :, REC_Z + k])
    d_op = d_fsum[:, REC_OP]
    d_int = d_face[:, :, REC_IN]
    d_aa = d_face[:, :, REC_AA:REC_AA + 6].reshape(n_batch, f, 3, 2)
    return d_verts, d_vcolor, d_op, d_vndc_z, d_int, d_aa


def reduce_entry_grads_plain(grad_records, entry_bf, tile_starts, tile_counts,
                             nc_tile, faces, n_verts: int, n_batch: int):
    """Plain version of ``reduce_entry_grads`` (any device):
    ``contributing_mask``, then ``scatter_entry_grads``. No host sync."""
    keep, _ = contributing_mask(tile_starts, tile_counts, nc_tile,
                                grad_records.shape[0])
    d_verts, d_vcolor, d_op, d_vndc_z, d_int, d_aa = scatter_entry_grads(
        grad_records, entry_bf, faces, n_verts, n_batch, keep)
    d_vndc = d_vndc_z.new_zeros((n_batch, n_verts, 3))
    d_vndc[..., 2] = d_vndc_z
    return d_verts, d_vcolor, d_op, d_vndc, d_int, d_aa


def reduce_entry_grads(grad_records, entry_bf, tile_starts, tile_counts, nc_tile,
                       faces, n_verts: int, n_batch: int):
    """Reduce the contributing prefixes' gradient records to the six input
    gradients.

    Each tile's first min(count, nc_tile) rows (composite_backward's
    prefix) are summed onto their (batch, face), the face's vertices and
    its NDC z; sentinel rows and every row outside the prefixes add
    nothing, and are never read on CUDA. Every contributing row is reduced:
    nothing is dropped for capacity. On CUDA tensors ``csrc/grad_reduce.cu``
    adds with atomics, in an order, and so with last bits, that change from
    run to run; on CPU tensors ``reduce_entry_grads_plain``.

    Args:
      grad_records: (R, 32) f32; entry_bf: (R,) int32; tile_starts,
        tile_counts, nc_tile: (T,) int32; faces: (F, 3) int32.
    Returns (d_verts (P, 3), d_verts_color (P, 3), d_faces_opacity (F,),
    d_verts_ndc (B, P, 3) (x and y zero), d_faces_intense (B, F),
    d_aa_face_verts (B, F, 3, 2)).
    """
    dev = grad_records.device
    args = (grad_records, entry_bf, tile_starts, tile_counts, nc_tile, faces)
    if dev.type == "cpu":
        return reduce_entry_grads_plain(*args, n_verts, n_batch)
    r = grad_records.shape[0]
    n_tiles = tile_starts.shape[0]
    f = faces.shape[0]
    f32, i32 = torch.float32, torch.int32
    _kernels.check_inputs(dev, [
        ("grad_records", grad_records, f32, (r, GRAD_RECORD_WIDTH)),
        ("entry_bf", entry_bf, i32, (r,)),
        ("tile_starts", tile_starts, i32, (n_tiles,)),
        ("tile_counts", tile_counts, i32, (n_tiles,)),
        ("nc_tile", nc_tile, i32, (n_tiles,)),
        ("faces", faces, i32, (f, 3)),
    ])
    _kernels.check_aligned("grad_records", grad_records)
    kw = dict(dtype=f32, device=dev)
    # Each vertex's position and colour gradients, each padded to a float4:
    # the kernel adds them with vector atomics.
    d_vert8 = torch.zeros((n_verts, 8), **kw)
    d_op = torch.zeros((f,), **kw)
    d_vndc = torch.zeros((n_batch, n_verts, 3), **kw)
    d_int = torch.zeros((n_batch, f), **kw)
    d_aa = torch.zeros((n_batch, f, 3, 2), **kw)
    if n_tiles and r and f:
        lib = _kernels.GRAD_REDUCE.load()
        P = ctypes.c_void_p
        with torch.cuda.device(dev):
            err = lib.grad_reduce_launch(
                P(grad_records.data_ptr()), r, P(entry_bf.data_ptr()),
                P(tile_starts.data_ptr()), P(tile_counts.data_ptr()),
                P(nc_tile.data_ptr()), n_tiles, P(faces.data_ptr()), n_batch, f,
                n_verts, *(P(t.data_ptr()) for t in (d_vert8, d_op, d_vndc, d_int, d_aa)),
                _kernels.current_stream(dev),
            )
        _kernels.GRAD_REDUCE.launched(err)
    return (d_vert8[:, 0:3].contiguous(), d_vert8[:, 4:7].contiguous(), d_op, d_vndc,
            d_int, d_aa)
