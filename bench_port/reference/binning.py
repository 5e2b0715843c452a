"""Static-capacity tile binning and the record table of the plain reference.

A frozen copy of the renderer's binning: per (batch, face) the touched
16x16-tile rectangle (floor / ceil, clamped into the grid); a dense
(BF, Kt) emission grid in y-major order plus the giant tier, optionally
culled by an exact triangle-vs-tile test; one stable sort of packed int31
keys ``tile << bits_d | quantized depth``; tile ranges by ``searchsorted``;
a capacity rounded up to 128, with what it drops reported as truncated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16
TILE_PIXELS = TILE * TILE
STREAM_BLOCK = 128
SENTINEL = 0x7FFFFFFF
RECORD_WIDTH = 32
# Record columns: world corners, corner colours, opacity, intensity, NDC z
# of the corners, CCW screen corners; 29-31 are zero.
REC_V, REC_C, REC_OP, REC_IN, REC_Z, REC_AA = 0, 9, 18, 19, 20, 23


class Binned(NamedTuple):
    entry_bf: torch.Tensor       # (R,) int32 b*F + f per sorted entry; B*F past the end
    tile_starts: torch.Tensor    # (T,) int32
    tile_counts: torch.Tensor    # (T,) int32
    num_rendered: torch.Tensor   # () int64 rectangle-duplicated instances
    num_truncated: torch.Tensor  # () int64 instances dropped


def tile_grid_size(width: int, height: int):
    return -(-width // TILE), -(-height // TILE)


def tile_lanes(tile_ids, gx: int, gy: int, width: int, height: int):
    """Pixels of tiles (tile-major over B x gy x gx, lane = row-major index
    in the tile): batch (G,), x, y and the in-frame mask, each (G, 256)."""
    per_batch = gx * gy
    bt = tile_ids // per_batch
    rem = tile_ids - bt * per_batch
    ty = rem // gx
    tx = rem - ty * gx
    lane = torch.arange(TILE_PIXELS, device=tile_ids.device)
    x = tx[:, None] * TILE + (lane % TILE)[None, :]
    y = ty[:, None] * TILE + (lane // TILE)[None, :]
    return bt, x, y, (x < width) & (y < height)


def _tile_rects(tris, gx: int, gy: int):
    mn, mx = tris.amin(dim=2), tris.amax(dim=2)

    def cell(v, hi):
        return torch.clamp(v, 0.0, float(hi)).to(torch.int32)

    rx0 = cell(torch.floor(mn[..., 0] / TILE), gx)
    ry0 = cell(torch.floor(mn[..., 1] / TILE), gy)
    rx1 = cell(torch.ceil(mx[..., 0] / TILE), gx)
    ry1 = cell(torch.ceil(mx[..., 1] / TILE), gy)
    return rx0, ry0, torch.clamp(rx1 - rx0, min=0), torch.clamp(ry1 - ry0, min=0)


def _tri_tile_overlaps(tris_flat, tile_x, tile_y):
    """(BF, K) bool: the tile box is not wholly outside one edge half-plane
    of the triangle (orientation-safe, a slack of 1e-3 px x |edge|)."""
    ax = [tris_flat[:, k, 0:1] for k in range(3)]
    ay = [tris_flat[:, k, 1:2] for k in range(3)]
    sgn = torch.sign((ax[1] - ax[0]) * (ay[2] - ay[0]) - (ay[1] - ay[0]) * (ax[2] - ax[0]))
    x0 = tile_x.to(tris_flat.dtype) * TILE
    y0 = tile_y.to(tris_flat.dtype) * TILE
    ok = None
    for e in range(3):
        j = (e + 1) % 3
        ex = sgn * (ax[j] - ax[e])
        ey = sgn * (ay[j] - ay[e])
        cy = y0 + torch.where(ex > 0, float(TILE), 0.0)
        cx = x0 + torch.where(ey > 0, 0.0, float(TILE))
        smax = ex * (cy - ay[e]) - ey * (cx - ax[e])
        slack = -1e-3 * (torch.abs(ex) + torch.abs(ey))
        ok = smax >= slack if ok is None else ok & (smax >= slack)
    return ok


def bin_faces(tris, depth01, alive, width: int, height: int, capacity: int,
              max_tiles_per_face: int, num_giant_faces: int = 0,
              giant_tiles: int | None = None, exact_tile_cull: bool = False) -> Binned:
    """Bin (B, F) screen triangles ``tris`` (B, F, 3, 2) over full frames."""
    b, f = depth01.shape
    bf = b * f
    dev = depth01.device
    capacity = -(-capacity // STREAM_BLOCK) * STREAM_BLOCK
    gx, gy = tile_grid_size(width, height)
    t_total = b * gx * gy
    kt = max_tiles_per_face

    rx0, ry0, rw, rh = _tile_rects(tris, gx, gy)
    touched = torch.where(alive, rw * rh, 0).reshape(bf).long()
    emit = torch.clamp(touched, max=kt)
    num_rendered = touched.sum()

    k = torch.arange(kt, dtype=torch.int64, device=dev)[None, :]
    rx0_f, ry0_f = rx0.reshape(bf, 1).long(), ry0.reshape(bf, 1).long()
    rw_f = torch.clamp(rw.reshape(bf, 1).long(), min=1)
    dy = k // rw_f
    dx = k - dy * rw_f
    tile_x, tile_y = rx0_f + dx, ry0_f + dy
    batch_of = (torch.arange(bf, dtype=torch.int64, device=dev) // f)[:, None]
    tile_id = batch_of * (gx * gy) + tile_y * gx + tile_x
    valid = k < emit[:, None]
    tris_flat = tris.reshape(bf, 3, 2)
    num_culled = torch.zeros((), dtype=torch.int64, device=dev)
    if exact_tile_cull:
        over = _tri_tile_overlaps(tris_flat, tile_x, tile_y)
        num_culled = (valid & ~over).sum()
        valid = valid & over
    num_emitted = valid.sum()

    bits_t = max(1, t_total.bit_length())
    bits_d = 31 - bits_t
    if bits_d < 10:
        raise ValueError(f"{t_total} tiles leave {bits_d} < 10 depth bits")
    dmax = (1 << bits_d) - 1
    dq = torch.clamp((depth01.reshape(bf, 1) * float(dmax)).to(torch.int32).long(), 0, dmax)
    keys = [torch.where(valid, (tile_id << bits_d) | dq, SENTINEL).reshape(-1)]
    payloads = [torch.arange(bf, dtype=torch.int64, device=dev)[:, None]
                .expand(bf, kt).reshape(-1)]

    m2 = min(num_giant_faces, bf)
    if m2 > 0:
        kt2 = gx * gy if giant_tiles is None else min(giant_tiles, gx * gy)
        sel_key = torch.where(touched > kt, kt - touched, SENTINEL)
        sk_g, giant_ids = torch.sort(sel_key, stable=True)
        sk_g, giant_ids = sk_g[:m2], giant_ids[:m2]
        valid_g = sk_g != SENTINEL
        safe_g = torch.where(valid_g, giant_ids, 0)
        rw_g = rw_f[safe_g]
        k2 = torch.arange(kt2, dtype=torch.int64, device=dev)[None, :] + kt
        dy2 = k2 // rw_g
        dx2 = k2 - dy2 * rw_g
        tx2, ty2 = rx0_f[safe_g] + dx2, ry0_f[safe_g] + dy2
        tile2 = (safe_g // f)[:, None] * (gx * gy) + ty2 * gx + tx2
        valid2 = valid_g[:, None] & (k2 < touched[safe_g][:, None])
        if exact_tile_cull:
            over2 = _tri_tile_overlaps(tris_flat[safe_g], tx2, ty2)
            num_culled = num_culled + (valid2 & ~over2).sum()
            valid2 = valid2 & over2
        keys.append(torch.where(valid2, (tile2 << bits_d) | dq[safe_g], SENTINEL).reshape(-1))
        payloads.append(safe_g[:, None].expand(m2, kt2).reshape(-1))
        num_emitted = num_emitted + valid2.sum()

    total = sum(x.shape[0] for x in keys)
    if total < capacity:
        keys.append(torch.full((capacity - total,), SENTINEL, dtype=torch.int64, device=dev))
        payloads.append(torch.zeros((capacity - total,), dtype=torch.int64, device=dev))
    key_all = torch.cat(keys).to(torch.int32)
    payload = torch.cat(payloads).to(torch.int32)
    num_truncated = (num_rendered - num_emitted - num_culled
                     + torch.clamp(num_emitted - capacity, min=0))

    key_sorted, order = torch.sort(key_all, stable=True)
    key_sorted = key_sorted[:capacity]
    entry_bf = torch.where(key_sorted != SENTINEL, payload[order[:capacity]], bf).to(torch.int32)
    bounds = (torch.arange(t_total + 1, dtype=torch.int64, device=dev) << bits_d).to(torch.int32)
    edges = torch.searchsorted(key_sorted, bounds, side="left").to(torch.int32)
    return Binned(entry_bf, edges[:-1], edges[1:] - edges[:-1], num_rendered, num_truncated)


def contributing_mask(tile_starts, tile_counts, nc_tile, r: int):
    """(R,) bool: entries inside a tile's contributing prefix, the first
    ``min(count, nc_tile)`` entries of each tile."""
    counts2 = torch.minimum(tile_counts, torch.clamp(nc_tile, min=0)).long()
    starts = tile_starts.long()
    delta = torch.zeros((r + 1,), dtype=torch.int64, device=tile_starts.device)
    delta.index_add_(0, starts, torch.ones_like(starts))
    delta.index_add_(0, starts + counts2, -torch.ones_like(starts))
    return torch.cumsum(delta[:r], dim=0) > 0


def pack_records(entry_bf, faces, verts, verts_color, verts_ndc, faces_opacity,
                 faces_intense, tris):
    """(R, 32) float32 records of the sorted entries (entries past the end
    read the last (batch, face) row; no tile range reaches them)."""
    b, f = faces_intense.shape
    r = entry_bf.shape[0]
    fl = faces.long()
    safe = torch.clamp(entry_bf.long(), max=b * f - 1)
    fi = safe % f
    return torch.cat([
        verts[fl].reshape(f, 9)[fi],
        verts_color[fl].reshape(f, 9)[fi],
        faces_opacity[fi][:, None],
        faces_intense.reshape(b * f)[safe][:, None],
        verts_ndc[:, fl, 2].reshape(b * f, 3)[safe],
        tris.reshape(b * f, 6)[safe],
        torch.zeros((r, RECORD_WIDTH - 29), dtype=verts.dtype, device=verts.device),
    ], dim=1)
