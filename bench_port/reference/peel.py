"""Depth peel of the plain reference: per pixel ray, the L nearest existing
faces it crosses, by the JAX package's contract.

A frozen copy of the renderer's plain peel, as a full scan. A hit is exact
(``denom != 0``, ``t >= 0``, ``u >= 0``, ``v >= 0``, ``u + v <= 1``, the
face exists, its entry lies in the tile's range), with no ray divide and no
clamp. Each tile's min-depth list is read in 128-entry blocks at absolute
stream offsets; each block gives its L smallest distinct t (a tie inside a
block keeps the larger face id), merged into the L carried slots by strict
insertion, so the merge is not stable at ties: a tie with an earlier
block's slot lands after it, and a displaced slot moves past the slots
equal to it. Layers are face ids, -1 padded; counts are the filled slots.
"""

from __future__ import annotations

import torch

from bench_port.reference.binning import STREAM_BLOCK, TILE_PIXELS, tile_grid_size, tile_lanes

_INF = 3.0e38


def _peel_group(verts9, exist, fid, starts, counts, ro, rdx, rdy, rdz, num_layers: int):
    """Peel G tiles together: ``verts9`` (R, 9), ``exist`` and ``fid`` (R,)
    per stream entry; rays (G, 1, 256), zero off the frame. Returns slot ids
    (G, L, 256) float and counts (G, 256) float."""
    g = starts.shape[0]
    dev = verts9.device
    r = verts9.shape[0]
    blk0 = torch.div(starts, STREAM_BLOCK, rounding_mode="floor")
    h0 = starts - blk0 * STREAM_BLOCK
    nblocks = torch.div(counts + h0 + STREAM_BLOCK - 1, STREAM_BLOCK, rounding_mode="floor")
    n_steps = int(nblocks.max()) if g else 0
    lane = torch.arange(STREAM_BLOCK, device=dev)
    ox, oy, oz = (ro[:, c].reshape(g, 1, 1) for c in range(3))
    inf = torch.full((g, 1, TILE_PIXELS), _INF, device=dev)
    neg1 = torch.full((g, 1, TILE_PIXELS), -1.0, device=dev)
    slot_t = [inf] * num_layers
    slot_id = [neg1] * num_layers
    for i in range(n_steps):
        rows = (blk0 + i)[:, None] * STREAM_BLOCK + lane[None, :]
        rank = lane[None, :] + (i * STREAM_BLOCK - h0)[:, None]
        safe = torch.clamp(rows, max=max(r - 1, 0))
        v9 = verts9[safe]

        def col(k):
            return v9[:, :, k:k + 1]

        v0x, v0y, v0z = col(0), col(1), col(2)
        e1x, e1y, e1z = col(3) - v0x, col(4) - v0y, col(5) - v0z
        e2x, e2y, e2z = col(6) - v0x, col(7) - v0y, col(8) - v0z
        t0x, t0y, t0z = ox - v0x, oy - v0y, oz - v0z
        live = (((rank >= 0) & (rank < counts[:, None]))[:, :, None]
                & (exist[safe][:, :, None] > 0.0))
        pvx = rdy * e2z - rdz * e2y
        pvy = rdz * e2x - rdx * e2z
        pvz = rdx * e2y - rdy * e2x
        qvx = t0y * e1z - t0z * e1y
        qvy = t0z * e1x - t0x * e1z
        qvz = t0x * e1y - t0y * e1x
        denom = pvx * e1x + pvy * e1y + pvz * e1z
        ok = denom != 0.0
        inv = 1.0 / torch.where(ok, denom, torch.ones_like(denom))
        tt = (qvx * e2x + qvy * e2y + qvz * e2z) * inv
        u = (pvx * t0x + pvy * t0y + pvz * t0z) * inv
        v = (qvx * rdx + qvy * rdy + qvz * rdz) * inv
        valid = ok & (tt >= 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & live
        tt = torch.where(valid, tt, _INF)
        fidb = fid[safe][:, :, None].expand_as(tt)
        thresh = neg1
        for _ in range(num_layers):
            cand = torch.where(tt > thresh, tt, _INF)
            m = cand.amin(dim=1, keepdim=True)
            hit = m < _INF
            mid = torch.where((cand == m) & hit, fidb, -1.0).amax(dim=1, keepdim=True)
            thresh = torch.where(hit, m, thresh)
            carry_t = torch.where(hit, m, inf)
            carry_id = torch.where(hit, mid, neg1)
            for k in range(num_layers):
                take = carry_t < slot_t[k]
                slot_t[k], carry_t = (torch.where(take, carry_t, slot_t[k]),
                                      torch.where(take, slot_t[k], carry_t))
                slot_id[k], carry_id = (torch.where(take, carry_id, slot_id[k]),
                                        torch.where(take, slot_id[k], carry_id))
    cnt = sum((t < _INF).float() for t in slot_t)
    return torch.cat(slot_id, dim=1), cnt[:, 0, :]


def peel_tiles(entry_bf, faces, verts, faces_existence, tile_starts, tile_counts,
               ray_o_cam, ray_d, num_layers: int, tiles, group: int = 1024):
    """Peel the tiles ``tiles`` (int64 tile ids) of the binned stream.

    Returns (layers (N, L) int32, counts (N,) int32, pixels (N, 3) int64
    (batch, y, x)) for the N in-frame pixels of those tiles, tile by tile.
    """
    b, height, width, _ = ray_d.shape
    dev = ray_d.device
    gx, gy = tile_grid_size(width, height)
    f = faces.shape[0]
    fi = entry_bf.long() % f
    verts9 = verts[faces.long()[fi]].reshape(-1, 9)
    exist = faces_existence[fi].to(torch.float32)
    fid = fi.to(torch.float32)
    layers, counts, pixels = [], [], []
    for g0 in range(0, tiles.shape[0], group):
        tg = tiles[g0:g0 + group]
        bt, x, y, in_frame = tile_lanes(tg, gx, gy, width, height)
        xc, yc = x.clamp(max=width - 1), y.clamp(max=height - 1)
        rd = torch.where(in_frame[..., None], ray_d[bt[:, None], yc, xc],
                         torch.zeros((), device=dev))
        ids, cnt = _peel_group(verts9, exist, fid, tile_starts.long()[tg],
                               tile_counts.long()[tg], ray_o_cam[bt],
                               *(rd[:, None, :, c] for c in range(3)), num_layers)
        sel = in_frame.nonzero(as_tuple=True)
        layers.append(ids.permute(0, 2, 1)[sel].to(torch.int32))
        counts.append(cnt[sel].to(torch.int32))
        pixels.append(torch.stack([bt[:, None].expand_as(x)[sel], y[sel], x[sel]], dim=1))
    return torch.cat(layers), torch.cat(counts), torch.cat(pixels)
