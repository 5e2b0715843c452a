"""The port's backward compositor and gradient reduction vs the JAX package.

Both sides get the same record stream, tile ranges, rays, forward residuals
(the JAX forward kernel's, in interpret mode) and cotangents, including a
non-zero ``g_final_t``. The scene is ``tests/test_pallas_bwd.py``'s:
icosphere(1) with 1e-3 jitter, 2 views, 32x16.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu import geometry as JG
from dmesh2_renderer_tpu.ops import binning as JB
from dmesh2_renderer_tpu.ops.pallas_bwd import composite_backward as jax_backward
from dmesh2_renderer_tpu.ops.pallas_bwd import scatter_entry_grads as jax_scatter
from dmesh2_renderer_tpu.ops.pallas_fwd import composite_forward as jax_forward
from dmesh2_renderer_tpu.ops.reference import face_depth01
from dmesh2_renderer_tpu.utils.meshes import icosphere, orbit_cameras
from dmesh2_renderer_tpu_torch.ops.binning import (
    REC_AA, REC_C, REC_IN, REC_OP, REC_V, REC_Z, contributing_mask,
)
from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
    composite_backward, composite_backward_plain, scatter_entry_grads,
)
from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward
from tests._torch_port import to_numpy

W, H, B = 32, 16, 2
# The record columns, by tolerance (tests/test_pallas_bwd.py:97-102):
# colour, opacity, intensity and z sums reassociate only; the
# Moeller-Trumbore and AA columns come out of epilogues that cancel.
TIGHT = [(9, 18, "verts_color"), (18, 19, "opacity"), (19, 20, "intensity"),
         (20, 23, "z")]
LOOSE = [(0, 9, "verts"), (23, 29, "aa")]


@functools.lru_cache(maxsize=1)
def _scene():
    verts, faces = icosphere(1)
    verts = verts + np.random.default_rng(12345).normal(
        scale=1e-3, size=verts.shape).astype(np.float32)
    mv, proj = orbit_cameras(B)
    rng = np.random.default_rng(0)
    f = faces.shape[0]
    s = dict(
        verts=verts, faces=faces,
        verts_color=rng.uniform(size=(verts.shape[0], 3)).astype(np.float32),
        faces_opacity=rng.uniform(0.3, 0.95, size=(f,)).astype(np.float32),
        faces_intense=rng.uniform(0.5, 1.0, size=(B, f)).astype(np.float32),
        background=np.asarray([0.1, 0.2, 0.3], np.float32),
        patch_min=np.zeros((B, 2), np.int32),
        g_color=rng.normal(size=(B, H, W, 3)).astype(np.float32),
        g_depth=rng.normal(size=(B, H, W)).astype(np.float32),
        g_final_t=rng.normal(size=(B, H, W)).astype(np.float32),
    )
    j = {k: jnp.asarray(v) for k, v in s.items()}
    ray_o, ray_d = JG.init_rays(jnp.asarray(mv), jnp.asarray(proj), W, H)
    ndc, img = JG.compute_verts_ndc_image(j["verts"], jnp.asarray(mv),
                                          jnp.asarray(proj), W, H)
    aa = JG.face_aa_triangles(img, j["faces"]).verts
    depth01, _, _, alive = face_depth01(ndc, j["faces"])
    bn = JB.bin_faces(aa, depth01, alive, j["patch_min"], W, H, capacity=1024,
                      max_tiles_per_face=64)
    stream = JB.pack_face_stream(bn.entry_bf, j["verts"], j["faces"],
                                 j["verts_color"], j["faces_opacity"], ndc,
                                 j["faces_intense"], aa, interpret=True)
    a = dict(stream=stream, starts=bn.tile_starts, counts=bn.tile_counts,
             entry_bf=bn.entry_bf, ray_o_cam=ray_o[:, 0, 0, :], ray_d=ray_d,
             records=JB.unblock_stream(stream))
    return s, {k: np.array(v) for k, v in a.items()}


@functools.lru_cache(maxsize=2)
def _jax_records(tau):
    """The forward residuals and the JAX backward kernel's records."""
    s, a = _scene()
    j = {k: jnp.asarray(v) for k, v in {**s, **a}.items()}
    fwd = jax_forward(j["stream"], j["starts"], j["counts"], j["ray_o_cam"],
                      j["ray_d"], j["background"], j["patch_min"], W, H, tau,
                      chunk=128, interpret=True)
    color, depth, final_t, prev_t, _, nc_tile = fwd
    rec = jax_backward(j["stream"], j["starts"], j["counts"], nc_tile,
                       j["ray_o_cam"], j["ray_d"], j["background"],
                       j["patch_min"], color, depth, final_t, prev_t,
                       j["g_color"], j["g_depth"], j["g_final_t"], W, H, tau,
                       chunk=128, interpret=True)
    residuals = [np.array(x) for x in (nc_tile, color, depth, final_t, prev_t)]
    return residuals, np.array(rec)


def _port_args(tau):
    """composite_backward's arguments, as CPU tensors."""
    s, a = _scene()
    (nc_tile, color, depth, final_t, prev_t), _ = _jax_records(tau)
    t = torch.as_tensor
    return (t(a["records"]), t(a["starts"]), t(a["counts"]), t(nc_tile),
            t(a["ray_o_cam"]), t(a["ray_d"]), t(s["background"]),
            t(s["patch_min"]), t(color), t(depth), t(final_t), t(prev_t),
            t(s["g_color"]), t(s["g_depth"]), t(s["g_final_t"]), W, H, tau)


def _check_columns(got, want, label):
    for cols, tol in ((TIGHT, 2e-5), (LOOSE, 5e-4)):
        for lo, hi, name in cols:
            g, w = got[:, lo:hi], want[:, lo:hi]
            scale = max(np.abs(w).max(), 1.0)
            err = np.abs(g - w).max()
            assert err < tol * scale, f"{label} {name}: {err:.3e} (scale {scale:.3e})"


@pytest.mark.parametrize("tau", [1.0, 0.0])
def test_plain_backward_matches_jax_kernel(tau):
    """Record by record, on every row of the tiles (the JAX kernel leaves
    the rows past the last tile unwritten)."""
    _, a = _scene()
    _, want = _jax_records(tau)
    got = to_numpy(composite_backward_plain(*_port_args(tau)))
    n = int(a["counts"].sum())
    assert got.shape == want.shape == (a["records"].shape[0], 32)
    _check_columns(got[:n], want[:n], f"tau={tau}")
    assert not got[:, 29:].any() and not got[n:].any()
    if tau == 0.0:
        assert not got[:, 23:29].any()
    # The records are not trivially zero: every column class is exercised.
    for lo, hi, name in TIGHT + (LOOSE if tau > 0 else LOOSE[:1]):
        assert np.abs(want[:n, lo:hi]).max() > 0.1, name


def test_wrapper_takes_the_plain_version_on_cpu():
    args = _port_args(1.0)
    torch.testing.assert_close(composite_backward(*args),
                               composite_backward_plain(*args), rtol=0, atol=0)


def test_final_t_cotangent_reaches_the_records():
    """g_final_t alone moves opacity through dL/dalpha's background term and
    leaves the colour columns zero; the records are linear in the
    cotangents (the JAX records with all three are held above)."""
    s, a = _scene()
    args = list(_port_args(1.0))
    only_t = [torch.zeros_like(args[12]), torch.zeros_like(args[13]), args[14]]
    got = to_numpy(composite_backward_plain(*args[:12], *only_t, *args[15:]))
    n = int(a["counts"].sum())
    assert np.abs(got[:n, 18]).max() > 0.1
    assert not got[:n, 9:18].any()      # colour sees no colour cotangent
    # Linearity: the full records minus these are the records without it.
    no_t = to_numpy(composite_backward_plain(
        *args[:14], torch.zeros_like(args[14]), *args[15:]))
    full = to_numpy(composite_backward_plain(*args))
    np.testing.assert_allclose(no_t + got, full, atol=2e-5 * max(np.abs(full).max(), 1))


@pytest.mark.parametrize("tau", [1.0, 0.0])
def test_contributing_mask_matches_jax(tau):
    _, a = _scene()
    (nc_tile, *_), _ = _jax_records(tau)
    r = a["records"].shape[0]
    want_keep, want_n = JB.contributing_mask(jnp.asarray(a["starts"]),
                                             jnp.asarray(a["counts"]),
                                             jnp.asarray(nc_tile), r)
    keep, n = contributing_mask(torch.as_tensor(a["starts"]),
                                torch.as_tensor(a["counts"]),
                                torch.as_tensor(nc_tile), r)
    np.testing.assert_array_equal(to_numpy(keep), np.asarray(want_keep))
    assert int(n) == int(want_n) == int(keep.sum()) > 0


def test_contributing_mask_cuts_prefixes_as_jax_does():
    """Tiles whose cut lies inside their range, past it, at 0, and empty
    tiles, including one at the very end of the stream."""
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 40, size=64).astype(np.int32)
    counts[-1] = 0
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    r = int(counts.sum()) + 128
    starts[-1] = r
    nc = rng.integers(-1, 50, size=64).astype(np.int32)
    want_keep, want_n = JB.contributing_mask(*(jnp.asarray(x) for x in (starts, counts, nc)), r)
    keep, n = contributing_mask(*(torch.as_tensor(x) for x in (starts, counts, nc)), r)
    np.testing.assert_array_equal(to_numpy(keep), np.asarray(want_keep))
    assert int(n) == int(want_n)
    assert 0 < int(n) < int(counts.sum())


def test_reduction_matches_scatter_entry_grads():
    """The port's index_add_ reduction vs the JAX sort + segmented-scan
    reduction, on the JAX kernel's records of the tiles' rows. Sums
    reassociate only: 2e-6 relative, the tolerance of the JAX package's own
    reduction-mode tests."""
    s, a = _scene()
    (nc_tile, *_), want_rec = _jax_records(1.0)
    n = int(a["counts"].sum())
    rec, entry = want_rec[:n], a["entry_bf"][:n]
    p = s["verts"].shape[0]
    want = jax_scatter(jnp.asarray(rec), jnp.asarray(entry), jnp.asarray(s["faces"]),
                       p, B)
    keep, _ = contributing_mask(torch.as_tensor(a["starts"]),
                                torch.as_tensor(a["counts"]),
                                torch.as_tensor(nc_tile), n)
    got = scatter_entry_grads(torch.as_tensor(rec), torch.as_tensor(entry),
                              torch.as_tensor(s["faces"]), p, B, keep)
    shapes = [(p, 3), (p, 3), (s["faces"].shape[0],), (B, p),
              (B, s["faces"].shape[0]), (B, s["faces"].shape[0], 3, 2)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape
        w = np.asarray(w)
        np.testing.assert_allclose(to_numpy(g), w, rtol=2e-6,
                                   atol=2e-6 * max(np.abs(w).max(), 1.0))
        assert np.abs(w).max() > 0.1


def test_one_face_counts_blending_warps_and_batches():
    """One face on the plane z = 1, seen from the origin through the pixel
    centres of one 16x16 tile at tau = 0, with corners (0, 0), (16.25, 0)
    and (0, 16.25): it blends the 136 pixels with x + y <= 15. The warps'
    8x4 blocks at (8 * half, 4 * quarter) meet them where 8 * half + 4 *
    quarter <= 15: all four of the left half, two of the right. Queued, the
    136 pairs make five batches of up to 32, one butterfly each."""
    corners = [(0.0, 0.0), (16.25, 0.0), (0.0, 16.25)]
    rec = torch.zeros((1, 32))
    for k, (cx, cy) in enumerate(corners):
        rec[0, REC_V + 3 * k:REC_V + 3 * k + 3] = torch.tensor([cx, cy, 1.0])
        rec[0, REC_AA + 2 * k:REC_AA + 2 * k + 2] = torch.tensor([cx, cy])
        rec[0, REC_C + 3 * k:REC_C + 3 * k + 3] = torch.tensor([0.2, 0.5, 0.8])
        rec[0, REC_Z + k] = 0.5
    rec[0, REC_OP], rec[0, REC_IN] = 0.5, 1.0
    ys, xs = torch.meshgrid(torch.arange(16.0), torch.arange(16.0), indexing="ij")
    ray_d = torch.stack([xs + 0.5, ys + 0.5, torch.ones_like(xs)], dim=-1)[None]
    starts, counts = torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32)
    ray_o, bg = torch.zeros((1, 3)), torch.tensor([0.1, 0.2, 0.3])
    patch_min = torch.zeros((1, 2), dtype=torch.int32)
    color, depth, final_t, prev_t, _, nc_tile = composite_forward(
        rec, starts, counts, ray_o, ray_d, bg, patch_min, 16, 16, 0.0)
    g = torch.ones_like(depth)
    args = (rec, starts, counts, nc_tile, ray_o, ray_d, bg, patch_min, color, depth,
            final_t, prev_t, torch.ones_like(color), g, g, 16, 16, 0.0)
    work = {}
    composite_backward_plain(*args, work=work)
    assert {k: int(v) for k, v in work.items()} == dict(
        records=1, grad_records=1, pairs=256, bbox_pairs=256, blend_pairs=136,
        blend_warp_entries=6, grad_batches=5)
    assert ((final_t[0] < 1.0) == (xs + ys <= 15)).all()
    tally = torch.full((3,), 7, dtype=torch.int64)
    composite_backward(*args, tally=tally)
    assert tally.tolist() == [7 + 136, 7 + 5, 7 + 5]


@pytest.mark.parametrize("tau", [1.0, 0.0])
def test_tally_is_the_plain_work_counts(tau):
    """On CPU tensors the tally adds the plain version's queued pairs and
    gradient batches (one butterfly each), and the records stay the same."""
    args = _port_args(tau)
    work, tally = {}, torch.zeros(3, dtype=torch.int64)
    want = composite_backward_plain(*args, work=work)
    torch.testing.assert_close(composite_backward(*args, tally=tally), want,
                               rtol=0, atol=0)
    assert tally.tolist() == [int(work[k]) for k in (
        "blend_pairs", "grad_batches", "grad_batches")]
    assert work["grad_batches"] < work["blend_warp_entries"]
