"""Work counts of the port's hand-written kernels, for their rooflines.

Frozen arithmetic: each kernel's float operations and bytes are counted
from the cell's inputs as the benchmark's reference bins and walks them,
so the count stays the same whatever implements the kernel. Each input
byte is counted as read once and each output byte as written once.

The compositors' counts are the (entry, pixel) pairs of each class up to
the T < 1e-4 stop, as the reference's walks count them; the float
operations per pair were counted from ``csrc/composite_fwd.cu`` and
``csrc/composite_bwd.cu`` (per-face terms not counted). The peel's is a
full scan: every existing-face entry of a tile against every in-frame pixel
of the tile, and one per-hit charge whatever the number of layers. The
kernel's skip rule is an implementation choice and lowers nothing here.
"""

from __future__ import annotations

import torch

from bench_port.reference.binning import tile_grid_size, tile_lanes

# Per (face, pixel) pair of a compositor walk: the bbox test (6); inside
# the bbox, Moeller-Trumbore, the clamp, the ratio and pass tests (50) and
# at tau > 0 the AA area (176); a blending pair's interpolation and blend
# (37).
OPS_PER_PAIR = 6
OPS_PER_BBOX_PAIR = 50
OPS_PER_AA_PAIR = 176
OPS_PER_BLEND_PAIR = 37
# The backward adds per blending pair the cotangent chain (111) and at tau
# > 0 the AA edge weights (143); per entry with a blending pixel the block
# sum of 29 fields over 256 pixels and the epilogue.
OPS_PER_GRAD_PAIR = 111
OPS_PER_AA_GRAD_PAIR = 143
OPS_PER_GRAD_ENTRY = 29 * 255 + 117
# The peel: per existing-face entry (23), per (entry, in-frame pixel) pair
# (35), per hit (32).
PEEL_OPS_PER_ENTRY = 23
PEEL_OPS_PER_PAIR = 35
PEEL_OPS_PER_HIT = 32

F32 = 4
RECORD_BYTES = 32 * F32


def _frame(run):
    cfg = run.config
    return cfg["width"], cfg["height"], run.scene.views


def composite_forward(run) -> dict | None:
    """The forward compositor's ops and bytes at this cell's inputs."""
    w = run.reference.get("work", {}).get("forward")
    if not w:
        return None
    width, height, b = _frame(run)
    tau = float(run.config["aa_temperature"])
    n_pix = b * height * width
    tiles = run.reference["work"]["tiles"]
    nbytes = (w["records"] * RECORD_BYTES + (n_pix * 3 + b * 3 + 3 + b * 2) * F32
              + 3 * tiles * F32 + n_pix * (3 + 4) * F32)
    ops = (w["pairs"] * OPS_PER_PAIR
           + w["bbox_pairs"] * (OPS_PER_BBOX_PAIR + (OPS_PER_AA_PAIR if tau > 0 else 0))
           + w["blend_pairs"] * OPS_PER_BLEND_PAIR)
    return dict(ops=ops, bytes=nbytes)


def composite_backward(run) -> dict | None:
    """The backward compositor's: the contributing records walked, the
    (R, 32) output, 14 floats per pixel and the tile arrays read."""
    w = run.reference.get("work", {}).get("backward")
    if not w:
        return None
    width, height, b = _frame(run)
    aa = float(run.config["aa_temperature"]) > 0
    n_pix = b * height * width
    tiles = run.reference["work"]["tiles"]
    records = run.reference["work"]["records"]
    nbytes = (w["records"] * RECORD_BYTES + records * RECORD_BYTES + n_pix * 14 * F32
              + 3 * tiles * F32)
    ops = (w["pairs"] * OPS_PER_PAIR
           + w["bbox_pairs"] * (OPS_PER_BBOX_PAIR + (OPS_PER_AA_PAIR if aa else 0))
           + w["blend_pairs"] * (OPS_PER_BLEND_PAIR + OPS_PER_GRAD_PAIR
                                 + (OPS_PER_AA_GRAD_PAIR if aa else 0))
           + w["grad_records"] * OPS_PER_GRAD_ENTRY)
    return dict(ops=ops, bytes=nbytes)


def record_pack(run) -> dict | None:
    """The record pack's bytes: the (R, 32) table written, the R entries
    and every face and vertex table read once. No float operations."""
    work = run.reference.get("work")
    if not work or "records" not in work:
        return None
    s = run.scene
    r = work["records"]
    p, f, b = s.verts.shape[0], s.faces.shape[0], s.views
    nbytes = (r * RECORD_BYTES + r * F32 + f * 3 * F32
              + (p * 3 + p * 3 + b * p * 3 + f + b * f + b * f * 6) * F32)
    return dict(ops=0, bytes=nbytes)


def peel_scan(binned, faces, verts, exist, ray_o_cam, ray_d, chunk: int = 1 << 14) -> dict:
    """Entries (existing-face entries in some tile's range), pairs (those
    against their tile's in-frame pixels) and hits of a full scan."""
    b, height, width, _ = ray_d.shape
    dev = ray_d.device
    gx, gy = tile_grid_size(width, height)
    starts, counts = binned.tile_starts.long(), binned.tile_counts.long()
    n_tiles = counts.numel()
    tile_of = torch.repeat_interleave(torch.arange(n_tiles, device=dev), counts)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tile_of.numel(), device=dev) - first[tile_of] + starts[tile_of]
    fi = binned.entry_bf[pos].long() % faces.shape[0]
    live = exist[fi] > 0
    tile_l, fi_l = tile_of[live], fi[live]
    in_frame_all = tile_lanes(torch.arange(n_tiles, device=dev), gx, gy, width, height)[3]
    pairs = int(in_frame_all.sum(dim=1)[tile_l].sum())
    hits = 0
    fl = faces.long()
    for c0 in range(0, tile_l.numel(), chunk):
        tl, f = tile_l[c0:c0 + chunk], fi_l[c0:c0 + chunk]
        bt, x, y, in_frame = tile_lanes(tl, gx, gy, width, height)
        rd = ray_d[bt[:, None], y.clamp(max=height - 1), x.clamp(max=width - 1)]
        rd = torch.where(in_frame[..., None], rd, torch.zeros((), device=dev))
        rdx, rdy, rdz = rd[..., 0], rd[..., 1], rd[..., 2]
        v = verts[fl[f]]
        o = ray_o_cam[bt]
        v0x, v0y, v0z = v[:, 0, 0:1], v[:, 0, 1:2], v[:, 0, 2:3]
        e1x, e1y, e1z = v[:, 1, 0:1] - v0x, v[:, 1, 1:2] - v0y, v[:, 1, 2:3] - v0z
        e2x, e2y, e2z = v[:, 2, 0:1] - v0x, v[:, 2, 1:2] - v0y, v[:, 2, 2:3] - v0z
        t0x, t0y, t0z = o[:, 0:1] - v0x, o[:, 1:2] - v0y, o[:, 2:3] - v0z
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
        vv = (qvx * rdx + qvy * rdy + qvz * rdz) * inv
        hit = (ok & (tt >= 0.0) & (tt < 3.0e38) & (u >= 0.0) & (vv >= 0.0)
               & (u + vv <= 1.0) & in_frame)
        hits += int(hit.sum())
    return dict(entries=int(live.sum()), pairs=pairs, hits=hits)


def peel(run) -> dict | None:
    """The peel's ops (full scan) and bytes at this cell's inputs and L:
    the entries walked, the face tables, tile ranges and rays read once,
    the (B, H, W, L) layers and (B, H, W) counts written once."""
    ref = run.reference
    if not ref or "binned" not in ref:
        return None
    w = run.cached("peel_scan", lambda: peel_scan(
        ref["binned"], run.scene.faces, run.scene.verts, ref["exist"], ref["ray_o_cam"],
        ref["ray_d"]))
    width, height, b = _frame(run)
    n_layers = int(run.mix["num_layers"])
    n_pix = b * height * width
    counts = ref["binned"].tile_counts
    s = run.scene
    nbytes = (int(counts.sum()) * F32 + s.faces.numel() * F32 + s.verts.numel() * F32
              + s.exist.numel() * F32 + 2 * counts.numel() * F32 + b * 3 * F32
              + n_pix * 3 * F32 + n_pix * (n_layers + 1) * F32)
    ops = (w["entries"] * PEEL_OPS_PER_ENTRY + w["pairs"] * PEEL_OPS_PER_PAIR
           + w["hits"] * PEEL_OPS_PER_HIT)
    return dict(ops=ops, bytes=nbytes)
