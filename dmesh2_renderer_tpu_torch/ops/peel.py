"""Depth peel: per pixel ray, the L nearest existing faces it crosses.

Port of ``dmesh2_renderer_tpu/ops/peel.py`` (the ``LayeredRenderer``
backend). The JAX package replaces the reference's tet walk by one pass
over each tile's min-depth-sorted face list: Moeller-Trumbore on every
(face, pixel) pair, then the L smallest hit parameters t. Its output
contract, kept here exactly:

  * a hit is exact: ``denom != 0``, ``t >= 0``, ``u >= 0``, ``v >= 0``,
    ``u + v <= 1``, the face exists (``faces_existence > 0``) and its entry
    lies in the tile's range. No ray divide, no barycentric clamp (unlike
    the compositors);
  * the tile's list is read in 128-entry blocks at absolute stream offsets
    that are multiples of 128 (a tile's first block starts at
    ``start // 128``). Each block contributes its L smallest DISTINCT t
    values; a tie inside a block collapses to the larger face id. They are
    merged into the L carried slots by strict insertion
    (``carry_t < slot_t``), so a tie with a slot from an earlier block is
    kept as a second layer, after it; a slot the insertion displaces is
    carried past the slots equal to it;
  * layers are face ids, -1 padded, and counts the filled slots.

``peel_layers`` runs ``csrc/peel.cu`` on CUDA tensors and the plain version
on CPU tensors. The kernel gathers each entry's face straight from
``verts``/``faces``/``faces_existence`` by ``entry_bf``; the plain version
reads the same values from the (R, 16) table of :func:`pack_peel_stream`,
the JAX package's record layout. Both compute every float in the same
operation order, so they agree bit for bit. The kernel leaves out the pairs
that provably cannot change the output (:func:`skip_bound`); the plain
version scans them all, counts them, and drops them too with
``prune=True``.
"""

from __future__ import annotations

import ctypes

import torch

from dmesh2_renderer_tpu_torch.ops import _kernels
from dmesh2_renderer_tpu_torch.ops.binning import tile_grid_size, tile_lanes
from dmesh2_renderer_tpu_torch.utils.config import STREAM_BLOCK, TILE_PIXELS

# Peel face-record layout (16 f32 words).
PREC_V = 0       # [0:9) v0 v1 v2 xyz
PREC_EXIST = 9   # existence flag
PREC_FID = 10    # face id (exact in f32 for F < 2^24)
PREC_WIDTH = 16

_INF = 3.0e38

# Slot counts the kernel is compiled for. A call with num_layers = L runs
# the smallest one >= L and keeps the first L slots: the carried top-L is a
# prefix of the top-L' (every entry a block adds past its L-th is preceded
# by L smaller ones), and the count is min(count', L).
LAYER_INSTANCES = (1, 2, 4, 8, 16)
# Above 16 the kernel's wide instance runs with exactly L slots, kept with
# the block's list in shared memory (2 KiB per slot for the 128 pixels of a
# half tile); this many fit beside its face staging in the 227 KiB a block
# may opt in to on sm_90.
MAX_LAYERS = 96

# Float operations counted from csrc/peel.cu. Per entry (one thread per
# face of a block): edges, origin offset, q = t0 x e1 and q . e2 (23). Per
# (existing-face entry, in-frame pixel) pair: p = d x e2, the determinant,
# its test and reciprocal, t, u, v and the hit tests (35). Per hit, one
# charge for every L (32): the 8-slot block list's tie test, order test
# and two selects per slot; the wide instance's two binary searches (5 + 5
# compares at L = 32), tie test and swap walk (~L/2 compares) come to as
# many. The merge of each block's list into the slots is not counted.
# These are the JAX kernel's work, a full scan: the full-scan bound, which
# does not depend on L.
OPS_PER_ENTRY = 23
OPS_PER_PAIR = 35
OPS_PER_HIT = 32
# The work left after the skip rule (the after-skip bound): per entry also
# the skip bound (two edge norms with their guards 16, the normal and its
# norm 16, the quotient, its scale, flush and clamp 8), per skipped pair
# its one comparison; the other pairs as above.
OPS_PER_ENTRY_BOUND = 40
OPS_PER_SKIPPED_PAIR = 1

# The skip bound of csrc/peel.cu (its header note derives it): constants
# and a float32 mirror in the kernel's operation order.
EDGE_MIN = 2.0 ** -40
EDGE_MAX = 2.0 ** 40
NORMAL_FLOOR = 2.0 ** -49
DET_SLACK = 2.0 ** -20
BOUND_SCALE = 1.0 - 2.0 ** -18
BOUND_FLUSH = 2.0 ** -100
RAY_NORM2_MAX = 1.0 + 2.0 ** -20


def _sqrt(x):
    # Correctly rounded float32 square root (as CUDA's sqrtf): through
    # float64, which rounds exactly once more; torch's float32 sqrt on the
    # CPU may differ in the last bit.
    return torch.sqrt(x.double()).float()


def skip_bound(e1x, e1y, e1z, e2x, e2y, e2z, qe2):
    """``lb`` of ``csrc/peel.cu::skip_bound``, bit for bit: every hit of the
    face (edges ``e1``, ``e2``, ``qe2 = (t0 x e1) . e2``, all float32) by a
    ray with ``|d|^2 <= RAY_NORM2_MAX`` has a computed t >= lb."""
    n1 = _sqrt(e1x * e1x + e1y * e1y + e1z * e1z)
    n2 = _sqrt(e2x * e2x + e2y * e2y + e2z * e2z)
    sane = (n1 >= EDGE_MIN) & (n1 <= EDGE_MAX) & (n2 >= EDGE_MIN) & (n2 <= EDGE_MAX)
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    nn = torch.fmax(_sqrt(nx * nx + ny * ny + nz * nz),
                    torch.tensor(NORMAL_FLOOR, dtype=nx.dtype, device=nx.device))
    lb = qe2.abs() / (nn + n1 * n2 * DET_SLACK) * BOUND_SCALE
    lb = torch.where(lb < BOUND_FLUSH, 0.0, lb)
    lb = torch.fmin(lb, torch.tensor(_INF, dtype=lb.dtype, device=lb.device))
    return torch.where(sane, lb, 0.0)


def pack_peel_stream(entry_bf, verts, faces, faces_existence):
    """Peel records, row-major (R, 16) f32, in the ``PREC_*`` layout.

    The JAX package's ``pack_peel_stream`` without its blocking: sentinel
    entries (== B*F) map to face ``entry_bf % F`` (face 0), never read
    because they lie outside every tile's range.
    """
    f = faces.shape[0]
    r = entry_bf.shape[0]
    fi = entry_bf.long() % f
    v = verts[faces.long()[fi]].reshape(r, 9)
    exist = faces_existence[fi].to(v.dtype)[:, None]
    fid = fi.to(v.dtype)[:, None]
    pad = torch.zeros((r, PREC_WIDTH - 11), dtype=v.dtype, device=v.device)
    return torch.cat([v, exist, fid, pad], dim=1)


def _peel_group(records, starts, counts, ro, rdx, rdy, rdz, in_frame,
                num_layers: int, work, prune: bool):
    """Peel G tiles together; every tensor has the tile axis first.

    ``ro``: (G, 3) origins; ``rdx, rdy, rdz``: (G, 1, 256) rays, zero for
    pixels outside the frame (they never hit: the determinant is 0).
    ``prune`` drops the pairs the kernel's skip rule drops and the hits its
    insertion gate keeps out of the block's list.
    Returns (slot ids (G, L, 256) f32, counts (G, 256) f32).
    """
    g = starts.shape[0]
    dev = records.device
    r = records.shape[0]
    blk0 = torch.div(starts, STREAM_BLOCK, rounding_mode="floor")
    h0 = starts - blk0 * STREAM_BLOCK
    nblocks = torch.div(counts + h0 + STREAM_BLOCK - 1, STREAM_BLOCK,
                        rounding_mode="floor")
    n_steps = int(nblocks.max()) if g else 0
    lane = torch.arange(STREAM_BLOCK, device=dev)
    ox, oy, oz = (ro[:, c].reshape(g, 1, 1) for c in range(3))
    inf = torch.full((g, 1, TILE_PIXELS), _INF, device=dev)
    neg1 = torch.full((g, 1, TILE_PIXELS), -1.0, device=dev)
    slot_t = [inf] * num_layers
    slot_id = [neg1] * num_layers
    # Pixels whose ray is longer than the skip bound assumes never skip.
    bounded = rdx * rdx + rdy * rdy + rdz * rdz <= RAY_NORM2_MAX

    for i in range(n_steps):
        rows = (blk0 + i)[:, None] * STREAM_BLOCK + lane[None, :]      # (G, C)
        rank = lane[None, :] + (i * STREAM_BLOCK - h0)[:, None]
        rec = records[torch.clamp(rows, max=max(r - 1, 0))]           # (G, C, 16)

        def col(k):
            return rec[:, :, k:k + 1]                                  # (G, C, 1)

        v0x, v0y, v0z = col(0), col(1), col(2)
        v1x, v1y, v1z = col(3), col(4), col(5)
        v2x, v2y, v2z = col(6), col(7), col(8)
        in_list = ((rank >= 0) & (rank < counts[:, None]))[:, :, None]
        live = in_list & (col(PREC_EXIST) > 0.0)
        fid = col(PREC_FID)

        e1x, e1y, e1z = v1x - v0x, v1y - v0y, v1z - v0z
        e2x, e2y, e2z = v2x - v0x, v2y - v0y, v2z - v0z
        t0x, t0y, t0z = ox - v0x, oy - v0y, oz - v0z
        pvx = rdy * e2z - rdz * e2y
        pvy = rdz * e2x - rdx * e2z
        pvz = rdx * e2y - rdy * e2x
        qvx = t0y * e1z - t0z * e1y
        qvy = t0z * e1x - t0x * e1z
        qvz = t0x * e1y - t0y * e1x
        denom = pvx * e1x + pvy * e1y + pvz * e1z
        ok = denom != 0.0
        inv = 1.0 / torch.where(ok, denom, torch.ones_like(denom))
        qe2 = qvx * e2x + qvy * e2y + qvz * e2z
        tt = qe2 * inv
        u = (pvx * t0x + pvy * t0y + pvz * t0z) * inv
        v = (qvx * rdx + qvy * rdy + qvz * rdz) * inv
        valid = (ok & (tt >= 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                 & live)
        # The kernel's skip rule (t >= lb >= the slot threshold the block
        # started with) and its insertion gate (t >= that threshold).
        thr = torch.where(bounded, slot_t[-1], float("inf"))
        skip = thr <= skip_bound(e1x, e1y, e1z, e2x, e2y, e2z, qe2)
        hit = valid & (tt < _INF)
        gated = hit & ~skip & (tt >= thr)
        if work is not None:
            pairs = live & in_frame
            work["entries"] += live.sum()
            work["pairs"] += pairs.sum()
            work["hits"] += hit.sum()
            work["skipped"] += (pairs & skip).sum()
            work["gated"] += gated.sum()
        if prune:
            valid = valid & ~skip & ~gated
        tt = torch.where(valid, tt, _INF)                              # (G, C, N)
        fidb = fid.expand_as(tt)

        # The block's L smallest distinct t (the larger id on a tie), each
        # merged into the carried slots by a branch-free insertion: the
        # carried entry swaps with the first slot it is strictly below, and
        # the slot it displaces is carried on the same way. A tie is not
        # below, so the inserted entry goes after the slots equal to it, and
        # so does each displaced one: a displaced slot moves to the end of
        # the run of slots equal to it.
        thresh = neg1
        for _ in range(num_layers):
            cand = torch.where(tt > thresh, tt, _INF)
            m = cand.amin(dim=1, keepdim=True)                        # (G, 1, N)
            hit = m < _INF
            sel = (cand == m) & hit
            mid = torch.where(sel, fidb, -1.0).amax(dim=1, keepdim=True)
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


def peel_layers_plain(entry_bf, faces, verts, faces_existence, tile_starts,
                      tile_counts, ray_o_cam, ray_d, width: int, height: int,
                      num_layers: int, tiles=None, group: int = 256,
                      work: dict | None = None, prune: bool = False):
    """Plain version of the peel kernel (any device).

    ``tiles`` (int tensor of tile indices) restricts the work to those
    tiles; the other pixels keep -1 layers and 0 counts. Tiles are peeled
    ``group`` at a time: each step of a group holds (G, 128, 256) float
    temporaries. If ``work`` is a dict it receives, as 0-d int64 tensors,
    the existing-face ``entries`` walked, the (entry, in-frame pixel)
    ``pairs`` of a full scan and the ``hits`` found, the pairs the kernel's
    skip rule ``skipped`` (the carried L-th slot at the block's start <=
    :func:`skip_bound`) and the hits of the other pairs that its insertion
    gate keeps out of the block's list (``gated``: t >= that slot).
    ``prune=True`` drops both, as the kernel does; the result is the same
    (the kernel's header note proves it).
    Returns (layers (B, H, W, L) int32, counts (B, H, W) int32).
    """
    b = ray_d.shape[0]
    dev = ray_d.device
    gx, gy = tile_grid_size(width, height)
    records = pack_peel_stream(entry_bf, verts, faces, faces_existence)
    layers = torch.full((b, height, width, num_layers), -1, dtype=torch.int32,
                        device=dev)
    counts = torch.zeros((b, height, width), dtype=torch.int32, device=dev)
    if work is not None:
        for key in ("entries", "pairs", "hits", "skipped", "gated"):
            work[key] = torch.zeros((), dtype=torch.int64, device=dev)
    tile_ids = (torch.arange(b * gx * gy, device=dev) if tiles is None
                else tiles.to(device=dev, dtype=torch.int64))
    for g0 in range(0, tile_ids.shape[0], group):
        tg = tile_ids[g0:g0 + group]
        bt, x, y, in_frame = tile_lanes(tg, gx, gy, width, height)
        xc, yc = x.clamp(max=width - 1), y.clamp(max=height - 1)
        rd = torch.where(in_frame[..., None], ray_d[bt[:, None], yc, xc],
                         torch.zeros((), device=dev))                 # (G, 256, 3)
        ids, cnt = _peel_group(
            records, tile_starts.long()[tg], tile_counts.long()[tg],
            ray_o_cam[bt], *(rd[:, None, :, c] for c in range(3)),
            in_frame[:, None, :], num_layers, work, prune)
        sel = in_frame.nonzero(as_tuple=True)
        pix = (bt[:, None].expand_as(x)[sel], y[sel], x[sel])
        layers[pix] = ids.permute(0, 2, 1)[sel].to(torch.int32)
        counts[pix] = cnt[sel].to(torch.int32)
    return layers, counts


def peel_instance(num_layers: int) -> int:
    """The kernel's slot count for ``num_layers``: the smallest register
    instance that covers it, else ``num_layers`` itself (the wide instance).
    Raises above ``MAX_LAYERS``."""
    for n in LAYER_INSTANCES:
        if n >= num_layers:
            return n
    if num_layers <= MAX_LAYERS:
        return num_layers
    raise ValueError(
        f"num_layers={num_layers} exceeds the peel kernel's largest slot "
        f"count MAX_LAYERS={MAX_LAYERS} (csrc/peel.cu keeps the slots of a "
        "tile's 256 pixels in shared memory); the CPU path takes any count")


def wide_occupancy(num_layers: int) -> dict:
    """The wide instance's resources at ``num_layers`` slots (17 ..
    ``MAX_LAYERS``): registers, static and dynamic shared memory, local
    (spill) bytes and resident 128-thread blocks (half tiles) per SM."""
    return _kernels.PEEL.occupancy("peel_wide_occupancy", num_layers)


def peel_layers(entry_bf, faces, verts, faces_existence, tile_starts,
                tile_counts, ray_o_cam, ray_d, width: int, height: int,
                num_layers: int, tiles=None):
    """Run the depth peel over the binned entries.

    Args:
      entry_bf: (R,) int32 sorted entries (b*F + f; sentinel B*F).
      faces: (F, 3) int32; verts: (P, 3) f32; faces_existence: (F,) — a
        face exists where its value is > 0 (int32 on the card).
      tile_starts, tile_counts: (T,) int32 tile ranges into ``entry_bf``.
      ray_o_cam: (B, 3) camera origins; ray_d: (B, height, width, 3) rays.
      tiles: optional int32 tile indices to peel; other pixels keep -1
        layers and 0 counts.
    Returns (layers (B, H, W, L) int32 face ids, -1 padded, counts
    (B, H, W) int32). CPU tensors take the plain version; CUDA tensors
    launch ``csrc/peel.cu`` (num_layers up to ``MAX_LAYERS``).
    """
    num_layers = int(num_layers)
    if num_layers < 1:
        raise ValueError(f"num_layers must be >= 1, got {num_layers}")
    f = faces.shape[0]
    if f == 0:
        raise ValueError("peel_layers needs at least one face")
    dev = entry_bf.device
    if dev.type == "cpu":
        return peel_layers_plain(entry_bf, faces, verts, faces_existence,
                                 tile_starts, tile_counts, ray_o_cam, ray_d,
                                 width, height, num_layers, tiles)
    inst = peel_instance(num_layers)
    b, h, w, _ = ray_d.shape
    if (h, w) != (height, width):
        raise ValueError(f"ray_d is {h}x{w}, frame is {height}x{width}")
    gx, gy = tile_grid_size(width, height)
    n_tiles = b * gx * gy
    r = entry_bf.shape[0]
    i32, f32 = torch.int32, torch.float32
    specs = [
        ("entry_bf", entry_bf, i32, (r,)),
        ("faces", faces, i32, (f, 3)),
        ("verts", verts, f32, (verts.shape[0], 3)),
        ("faces_existence", faces_existence, i32, (f,)),
        ("tile_starts", tile_starts, i32, (n_tiles,)),
        ("tile_counts", tile_counts, i32, (n_tiles,)),
        ("ray_o_cam", ray_o_cam, f32, (b, 3)),
        ("ray_d", ray_d, f32, (b, h, w, 3)),
    ]
    if tiles is not None:
        specs.append(("tiles", tiles, i32, (tiles.shape[0],)))
    _kernels.check_inputs(dev, specs)
    if tiles is None:
        n_blocks = n_tiles
        layers = torch.empty((b, h, w, num_layers), dtype=i32, device=dev)
        counts = torch.empty((b, h, w), dtype=i32, device=dev)
    else:
        n_blocks = tiles.shape[0]
        layers = torch.full((b, h, w, num_layers), -1, dtype=i32, device=dev)
        counts = torch.zeros((b, h, w), dtype=i32, device=dev)
    if n_blocks == 0:
        return layers, counts
    lib = _kernels.PEEL.load()
    P = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = lib.peel_launch(
            P(entry_bf.data_ptr()), r, P(faces.data_ptr()), P(verts.data_ptr()),
            P(faces_existence.data_ptr()), f, P(tile_starts.data_ptr()),
            P(tile_counts.data_ptr()),
            P(None if tiles is None else tiles.data_ptr()), n_blocks,
            P(ray_o_cam.data_ptr()), P(ray_d.data_ptr()), h, w, gx, gy, inst,
            num_layers, P(layers.data_ptr()), P(counts.data_ptr()),
            _kernels.current_stream(dev),
        )
    (_kernels.PEEL_WIDE if inst > LAYER_INSTANCES[-1] else _kernels.PEEL).launched(err)
    return layers, counts
