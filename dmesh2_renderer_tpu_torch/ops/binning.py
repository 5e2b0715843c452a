"""Static-capacity tile binning and the per-entry record pack.

Port of ``dmesh2_renderer_tpu/ops/binning.py``. Binning stays plain
PyTorch, as it was plain XLA in the JAX package, and reproduces its result
bit for bit:

  * touched-tile rects per (batch, face), floor/ceil clamped into the grid;
  * a dense (BF, Kt) emission grid in y-major order, plus the giant tier
    for faces touching more than Kt tiles, optionally culled by an exact
    triangle-vs-tile test;
  * ONE stable sort of packed int31 keys ``tile << bits_d | quantized depth``
    with the (b*F + f) entry id as payload; empty slots carry the sentinel
    key 0x7FFFFFFF and sort to the end;
  * tile ranges by ``searchsorted`` of the T tile boundaries;
  * a static capacity (rounded up to 128), with dropped entries reported.

The record pack turns the sorted entries into the compositor's input: one
128-byte record per entry, row-major (R, 32) f32, in the ``REC_*`` layout.
On the card it is the hand-written kernel ``csrc/pack_stream.cu``; on the
CPU its plain version below.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from dmesh2_renderer_tpu_torch.ops import _kernels
from dmesh2_renderer_tpu_torch.utils.config import (
    FACE_RECORD_WIDTH,
    STREAM_BLOCK,
    TILE_X,
    TILE_Y,
)

SENTINEL = 0x7FFFFFFF


class Binning(NamedTuple):
    entry_bf: torch.Tensor      # (R,) int32, b*F+f per sorted entry (sentinel
                                # BF); tile segments contiguous
    tile_starts: torch.Tensor   # (T_total,) int32 offsets into entry_bf
    tile_counts: torch.Tensor   # (T_total,) int32
    num_rendered: torch.Tensor  # () int64: true duplicated-instance count
    num_truncated: torch.Tensor  # () int64: instances dropped by Kt / capacity
    giant_ids: torch.Tensor     # (M2,) int32 b*F+f of giant-tier faces,
                                # sentinel BF; empty when the tier is disabled


def tile_grid_size(patch_width: int, patch_height: int):
    gx = -(-patch_width // TILE_X)
    gy = -(-patch_height // TILE_Y)
    return gx, gy


def face_tile_rects(aa_face_verts, patch_min, gx: int, gy: int):
    """Clamped tile rectangles per (batch, face).

    Floor on the min corner, ceil on the max corner (exclusive), clamped
    into [0, grid]. The clamp runs in the float domain before the integer
    conversion, which gives the saturating conversion's result for any
    finite coordinate.

    Returns rx0, ry0, rw, rh (each (B, F) int32; rw/rh may be 0).
    """
    mn = aa_face_verts.amin(dim=2)  # (B, F, 2)
    mx = aa_face_verts.amax(dim=2)
    pm = patch_min.to(aa_face_verts.dtype)[:, None, :]

    def cell(x, hi):
        return torch.clamp(x, 0.0, float(hi)).to(torch.int32)

    rx0 = cell(torch.floor((mn[..., 0] - pm[..., 0]) / TILE_X), gx)
    ry0 = cell(torch.floor((mn[..., 1] - pm[..., 1]) / TILE_Y), gy)
    rx1 = cell(torch.ceil((mx[..., 0] - pm[..., 0]) / TILE_X), gx)
    ry1 = cell(torch.ceil((mx[..., 1] - pm[..., 1]) / TILE_Y), gy)
    return (rx0, ry0, torch.clamp(rx1 - rx0, min=0),
            torch.clamp(ry1 - ry0, min=0))


def _ceil_log2(n: int) -> int:
    return max(1, (n - 1).bit_length())


def _tri_tile_overlaps(aa_flat, patch_min_flat, tile_x, tile_y):
    """Exact triangle-vs-tile-box overlap test for emitted (entry, slot)s.

    A convex polygon misses an AABB iff the box lies entirely outside one
    edge half-plane, i.e. the box corner maximizing the (orientation-
    corrected) edge function is still negative. Conservative on boundaries
    (>= -slack keeps) and orientation-safe.

    Args: aa_flat (BF, 3, 2) screen triangles, patch_min_flat (BF, 2),
    tile_x/tile_y (BF, K) tile indices. Returns (BF, K) bool.
    """
    ax = [aa_flat[:, k, 0:1] for k in range(3)]
    ay = [aa_flat[:, k, 1:2] for k in range(3)]
    sgn = torch.sign(
        (ax[1] - ax[0]) * (ay[2] - ay[0]) - (ay[1] - ay[0]) * (ax[2] - ax[0])
    )
    x0 = tile_x.to(aa_flat.dtype) * TILE_X + patch_min_flat[:, 0:1]
    y0 = tile_y.to(aa_flat.dtype) * TILE_Y + patch_min_flat[:, 1:2]
    ok = None
    for e in range(3):
        j = (e + 1) % 3
        ex = sgn * (ax[j] - ax[e])          # scaled edge vector (BF, 1)
        ey = sgn * (ay[j] - ay[e])
        # corner of the box maximizing ex*(cy - ay) - ey*(cx - ax)
        cy = y0 + torch.where(ex > 0, float(TILE_Y), 0.0)
        cx = x0 + torch.where(ey > 0, 0.0, float(TILE_X))
        smax = ex * (cy - ay[e]) - ey * (cx - ax[e])
        # A slack of 1e-3 px * |edge| dwarfs the f32 rounding of the edge
        # function while staying far below any slot with pixel coverage.
        slack = -1e-3 * (torch.abs(ex) + torch.abs(ey))
        ok = smax >= slack if ok is None else ok & (smax >= slack)
    return ok


class EmissionKeys(NamedTuple):
    keys: torch.Tensor          # (S,) int32 packed keys (sentinel-padded)
    payload: torch.Tensor       # (S,) int32 b*F+f per slot
    bits_d: int
    t_total: int
    num_rendered: torch.Tensor  # () int64
    num_emitted: torch.Tensor   # () int64
    num_culled: torch.Tensor    # () int64
    giant_ids: torch.Tensor     # (M2,) int32


def emission_keys(aa_face_verts, depth01, alive, patch_min, patch_width: int,
                  patch_height: int, capacity: int, max_tiles_per_face: int,
                  num_giant_faces: int = 0, giant_tiles: int | None = None,
                  exact_tile_cull: bool = False) -> EmissionKeys:
    """Every emission slot's packed sort key and payload (before the sort).

    ``capacity`` must already be rounded to STREAM_BLOCK; the slots are
    padded with sentinels up to it.
    """
    b, f = depth01.shape
    bf = b * f
    dev = depth01.device
    gx, gy = tile_grid_size(patch_width, patch_height)
    t_total = b * gx * gy
    kt = max_tiles_per_face

    rx0, ry0, rw, rh = face_tile_rects(aa_face_verts, patch_min, gx, gy)
    touched = torch.where(alive, rw * rh, 0).reshape(bf).long()     # (BF,)
    emit = torch.clamp(touched, max=kt)
    num_rendered = touched.sum()

    # Emission grid (BF, Kt): k-th touched tile of each face, y-major order.
    k = torch.arange(kt, dtype=torch.int64, device=dev)[None, :]
    rx0_f, ry0_f = rx0.reshape(bf, 1).long(), ry0.reshape(bf, 1).long()
    rw_f = torch.clamp(rw.reshape(bf, 1).long(), min=1)
    dy = k // rw_f
    dx = k - dy * rw_f
    tile_x = rx0_f + dx
    tile_y = ry0_f + dy
    batch_of = (torch.arange(bf, dtype=torch.int64, device=dev) // f)[:, None]
    tile_id = batch_of * (gx * gy) + tile_y * gx + tile_x             # (BF, Kt)
    valid = k < emit[:, None]
    aa_flat = aa_face_verts.reshape(bf, 3, 2)
    pm_flat = patch_min.to(aa_face_verts.dtype)[:, None, :].expand(b, f, 2) \
        .reshape(bf, 2)
    num_culled = torch.zeros((), dtype=torch.int64, device=dev)
    if exact_tile_cull:
        overlap1 = _tri_tile_overlaps(aa_flat, pm_flat, tile_x, tile_y)
        num_culled = (valid & ~overlap1).sum()
        valid = valid & overlap1
    num_emitted = valid.sum()

    # Packed int31 sort key: tile in the high bits, quantized depth below.
    bits_t = _ceil_log2(t_total + 1)
    bits_d = 31 - bits_t
    if bits_d < 10:
        raise ValueError(
            f"tile grid too large for packed int31 sort keys: {t_total} "
            f"(batch x tiles) needs {bits_t} bits, leaving {bits_d} < 10 "
            "depth bits. Render fewer views per call or use smaller patches."
        )
    # Quantize depth in the INTEGER domain: for bits_d >= 25 the float32
    # value (2^bits_d - 1) rounds up to 2^bits_d, so a float-side clip can
    # still yield dq == 2^bits_d at depth01 == 1.0 and overflow into the
    # tile bits.
    dmax = (1 << bits_d) - 1
    dq = (depth01.reshape(bf, 1) * float(dmax)).to(torch.int32).long()
    dq = torch.clamp(dq, 0, dmax)
    key = torch.where(valid, (tile_id << bits_d) | dq, SENTINEL)
    keys_flat = [key.reshape(-1)]
    payloads_flat = [torch.arange(bf, dtype=torch.int64, device=dev)[:, None]
                     .expand(bf, kt).reshape(-1)]

    # Giant tier: faces with touched > Kt emit their REMAINING tiles from a
    # compacted (M2, Kt2) grid. Selection = the M2 most-oversized faces
    # (ascending Kt - touched, ties by entry id through the stable sort).
    m2 = min(num_giant_faces, bf)
    if m2 > 0:
        kt2 = gx * gy if giant_tiles is None else min(giant_tiles, gx * gy)
        big = touched > kt
        sel_key = torch.where(big, kt - touched, SENTINEL)
        sk_g, giant_ids = torch.sort(sel_key, stable=True)
        sk_g, giant_ids = sk_g[:m2], giant_ids[:m2]
        valid_g = sk_g != SENTINEL
        safe_g = torch.where(valid_g, giant_ids, 0)
        rx0_g = rx0_f[safe_g]                                         # (M2, 1)
        ry0_g = ry0_f[safe_g]
        rw_g = rw_f[safe_g]
        touched_g = touched[safe_g]
        dq_g = dq[safe_g]
        batch_g = (safe_g // f)[:, None]
        k2 = torch.arange(kt2, dtype=torch.int64, device=dev)[None, :] + kt
        dy2 = k2 // rw_g
        dx2 = k2 - dy2 * rw_g
        tile2 = batch_g * (gx * gy) + (ry0_g + dy2) * gx + (rx0_g + dx2)
        valid2 = valid_g[:, None] & (k2 < touched_g[:, None])
        if exact_tile_cull:
            overlap2 = _tri_tile_overlaps(
                aa_flat[safe_g], pm_flat[safe_g], rx0_g + dx2, ry0_g + dy2,
            )
            num_culled = num_culled + (valid2 & ~overlap2).sum()
            valid2 = valid2 & overlap2
        keys_flat.append(
            torch.where(valid2, (tile2 << bits_d) | dq_g, SENTINEL).reshape(-1))
        payloads_flat.append(safe_g[:, None].expand(m2, kt2).reshape(-1))
        num_emitted = num_emitted + valid2.sum()
        giant_ids = torch.where(valid_g, giant_ids, bf).to(torch.int32)
    else:
        giant_ids = torch.zeros((0,), dtype=torch.int32, device=dev)

    # Small scenes can have fewer emission slots than the capacity; pad with
    # sentinels so the sorted stream is exactly capacity.
    total_slots = sum(x.shape[0] for x in keys_flat)
    if total_slots < capacity:
        pad_n = capacity - total_slots
        keys_flat.append(torch.full((pad_n,), SENTINEL, dtype=torch.int64, device=dev))
        payloads_flat.append(torch.zeros((pad_n,), dtype=torch.int64, device=dev))
    return EmissionKeys(
        torch.cat(keys_flat).to(torch.int32),
        torch.cat(payloads_flat).to(torch.int32),
        bits_d, t_total, num_rendered, num_emitted, num_culled, giant_ids)


def bin_faces(
    aa_face_verts,   # (B, F, 3, 2) screen-space triangles
    depth01,         # (B, F) sort depth in [0, 1]
    alive,           # (B, F) bool cull mask
    patch_min,       # (B, 2) int
    patch_width: int,
    patch_height: int,
    capacity: int,
    max_tiles_per_face: int,
    num_giant_faces: int = 0,
    giant_tiles: int | None = None,
    exact_tile_cull: bool = False,
) -> Binning:
    """Static-capacity tile binning (the module docstring has the design).

    ``max_tiles_per_face`` (Kt) caps the dense per-face emission grid; faces
    touching more tiles spill into the giant tier: up to ``num_giant_faces``
    of them additionally emit tiles [Kt, Kt + giant_tiles), where
    ``giant_tiles`` defaults to the full tile grid. Anything beyond both
    tiers is truncated and reported. ``exact_tile_cull`` drops rect slots
    whose tile box the triangle does not intersect; culled slots are not
    truncation, and ``num_rendered`` stays the rect-duplication count.
    """
    bf = depth01.shape[0] * depth01.shape[1]
    capacity = ((capacity + STREAM_BLOCK - 1) // STREAM_BLOCK) * STREAM_BLOCK
    em = emission_keys(aa_face_verts, depth01, alive, patch_min, patch_width,
                       patch_height, capacity, max_tiles_per_face,
                       num_giant_faces, giant_tiles, exact_tile_cull)
    num_truncated = (em.num_rendered - em.num_emitted - em.num_culled
                     + torch.clamp(em.num_emitted - capacity, min=0))

    key_sorted, order = torch.sort(em.keys, stable=True)
    key_sorted = key_sorted[:capacity]
    entry_bf = torch.where(key_sorted != SENTINEL, em.payload[order[:capacity]],
                           bf).to(torch.int32)

    # Tile ranges: T boundary queries into the sorted keys.
    bounds = (torch.arange(em.t_total + 1, dtype=torch.int64,
                           device=key_sorted.device) << em.bits_d).to(torch.int32)
    edges = torch.searchsorted(key_sorted, bounds, side="left").to(torch.int32)
    starts = edges[:-1]
    counts = edges[1:] - starts
    return Binning(entry_bf, starts, counts, em.num_rendered,
                   num_truncated, em.giant_ids)


def contributing_mask(tile_starts, tile_counts, nc_tile, r: int):
    """(R,) bool: stream positions inside some tile's contributing prefix.

    ``nc_tile`` (from the forward compositor) is each tile's largest 1-based
    rank of a face that blended into any of its pixels. Every later entry of
    the tile has an all-zero gradient record, so the contributing set is a
    per-tile prefix of ``min(count, nc_tile)`` entries. Built as +1 at each
    tile start and -1 at its cut, then a cumulative sum.

    Returns (keep (R,) bool, contributing count () int64).
    """
    counts2 = torch.minimum(tile_counts, torch.clamp(nc_tile, min=0)).long()
    starts = tile_starts.long()
    delta = torch.zeros((r + 1,), dtype=torch.int64, device=tile_starts.device)
    delta.index_add_(0, starts, torch.ones_like(starts))
    delta.index_add_(0, starts + counts2, -torch.ones_like(starts))
    keep = torch.cumsum(delta[:r], dim=0) > 0
    return keep, counts2.sum()


# Face-stream record layout (FACE_RECORD_WIDTH = 32 f32 words per entry):
#   [0:9)   v0.xyz v1.xyz v2.xyz      world-space triangle
#   [9:18)  c0.rgb c1.rgb c2.rgb      vertex colors
#   [18]    opacity
#   [19]    intensity (per batch)
#   [20:23) z0 z1 z2                  per-batch NDC depths
#   [23:29) aa x0 y0 x1 y1 x2 y2      CCW screen-space triangle
#   [29:32) zeros
REC_V = 0
REC_C = 9
REC_OP = 18
REC_IN = 19
REC_Z = 20
REC_AA = 23


def gather_face_corners(verts, verts_color, verts_ndc, faces):
    """Per-face corner rows: (v9 (F, 9), c9 (F, 9), z (B, F, 3))."""
    fl = faces.long()
    f = fl.shape[0]
    return (verts[fl].reshape(f, 9), verts_color[fl].reshape(f, 9),
            verts_ndc[:, fl, 2])


def pack_stream_plain(entry_bf, faces, verts, verts_color, verts_ndc,
                      faces_opacity, faces_intense, aa_face_verts):
    """Plain version of the record pack: (R,) entries -> (R, 32) records.

    Sentinel entries (== B*F) read the last row, B*F - 1; the compositor
    never reads them (they lie outside every tile's range).
    """
    b, f = faces_intense.shape
    r = entry_bf.shape[0]
    safe = torch.clamp(entry_bf.long(), max=b * f - 1)
    fi = safe % f
    v9, c9, z = gather_face_corners(verts, verts_color, verts_ndc, faces)
    return torch.cat([
        v9[fi],
        c9[fi],
        faces_opacity[fi][:, None],
        faces_intense.reshape(b * f)[safe][:, None],
        z.reshape(b * f, 3)[safe],
        aa_face_verts.reshape(b * f, 6)[safe],
        torch.zeros((r, FACE_RECORD_WIDTH - 29), dtype=verts.dtype,
                    device=verts.device),
    ], dim=1)


_F32 = torch.float32
_I32 = torch.int32


def pack_stream(entry_bf, faces, verts, verts_color, verts_ndc, faces_opacity,
                faces_intense, aa_face_verts):
    """Record pack: sorted entries -> (R, 32) f32 row-major records.

    Computes ``unblock_stream(gather_stream(build_face_table_from_corners(
    ...), entry_bf))`` of the JAX package. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/pack_stream.cu``.
    """
    dev = entry_bf.device
    if dev.type == "cpu":
        return pack_stream_plain(entry_bf, faces, verts, verts_color, verts_ndc,
                                 faces_opacity, faces_intense, aa_face_verts)
    b, f = faces_intense.shape
    p = verts.shape[0]
    r = entry_bf.shape[0]
    _kernels.check_inputs(dev, [
        ("entry_bf", entry_bf, _I32, (r,)),
        ("faces", faces, _I32, (f, 3)),
        ("verts", verts, _F32, (p, 3)),
        ("verts_color", verts_color, _F32, (p, 3)),
        ("verts_ndc", verts_ndc, _F32, (b, p, 3)),
        ("faces_opacity", faces_opacity, _F32, (f,)),
        ("faces_intense", faces_intense, _F32, (b, f)),
        ("aa_face_verts", aa_face_verts, _F32, (b, f, 3, 2)),
    ])
    if b * f == 0:
        raise ValueError("pack_stream needs at least one face")
    out = torch.empty((r, FACE_RECORD_WIDTH), dtype=_F32, device=dev)
    if r == 0:
        return out
    lib = _kernels.PACK_STREAM.load()
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = lib.pack_stream_launch(
            P(entry_bf.data_ptr()), r, P(faces.data_ptr()),
            P(verts.data_ptr()), P(verts_color.data_ptr()),
            P(verts_ndc.data_ptr()), P(faces_opacity.data_ptr()),
            P(faces_intense.data_ptr()), P(aa_face_verts.data_ptr()), b, f, p,
            P(out.data_ptr()), _kernels.current_stream(dev),
        )
    _kernels.PACK_STREAM.launched(err)
    return out
