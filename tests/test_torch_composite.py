"""Port compositors vs the JAX package on identical inputs.

The port's plain tile compositor (the CPU side of ``composite_forward``)
against the JAX Pallas forward kernel in interpret mode on the same record
stream, tile ranges and rays; the port's reference compositor against the
JAX one; and the work counts of both plain compositors, from which the
kernels' bounds are computed, against counts taken independently of them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu import geometry as JG
from dmesh2_renderer_tpu.ops import binning as JB
from dmesh2_renderer_tpu.ops.pallas_fwd import composite_forward as jax_composite
from dmesh2_renderer_tpu.ops.reference import face_depth01
from dmesh2_renderer_tpu.ops.reference import render_reference as jax_reference
from dmesh2_renderer_tpu_torch.convert import scene_from_jax
from dmesh2_renderer_tpu_torch.ops.binning import REC_AA, REC_OP
from dmesh2_renderer_tpu_torch.ops.composite_bwd import composite_backward_plain
from dmesh2_renderer_tpu_torch.ops.composite_fwd import (
    composite_forward, composite_forward_plain,
)
from dmesh2_renderer_tpu_torch.ops.reference import render_reference
from tests._torch_port import assert_blend_counts_match, scene_arrays, to_numpy

W, H, B = 40, 36, 2          # ragged right and bottom tiles
PATCH_MIN = np.asarray([[0, 0], [4, 6]], np.int32)


@functools.lru_cache(maxsize=1)
def _inputs():
    """Record stream, tile ranges and rays, all as numpy."""
    s = scene_arrays(b=B)
    j = {k: jnp.asarray(v) for k, v in s.items()}
    verts_ndc, verts_image = JG.compute_verts_ndc_image(j["verts"], j["mv"],
                                                        j["proj"], 48, 48)
    aa = JG.face_aa_triangles(verts_image, j["faces"]).verts
    ray_o, ray_d = JG.init_rays(j["mv"], j["proj"], 48, 48)
    ray_o, ray_d = JG.select_rays(ray_o, ray_d, jnp.arange(B),
                                  jnp.asarray(PATCH_MIN), W, H)
    depth01, _, _, alive = face_depth01(verts_ndc, j["faces"])
    binning = JB.bin_faces(aa, depth01, alive, jnp.asarray(PATCH_MIN), W, H,
                           capacity=1024, max_tiles_per_face=64)
    stream = JB.pack_face_stream(binning.entry_bf, j["verts"], j["faces"],
                                 j["verts_color"], j["faces_opacity"], verts_ndc,
                                 j["faces_intense"], aa, interpret=True)
    assert int(binning.num_truncated) == 0
    arrays = dict(stream=stream, starts=binning.tile_starts,
                  counts=binning.tile_counts, entry_bf=binning.entry_bf,
                  ray_o=ray_o, ray_d=ray_d, verts_ndc=verts_ndc, aa=aa)
    return s, {k: np.array(v) for k, v in arrays.items()}


@functools.lru_cache(maxsize=2)
def _jax_composite(tau):
    s, a = _inputs()
    out = jax_composite(
        jnp.asarray(a["stream"]), jnp.asarray(a["starts"]), jnp.asarray(a["counts"]),
        jnp.asarray(a["ray_o"][:, 0, 0, :]), jnp.asarray(a["ray_d"]),
        jnp.asarray(s["background"]), jnp.asarray(PATCH_MIN), W, H, tau,
        chunk=128, interpret=True)
    return [np.asarray(x) for x in out]


def _tile_max(n_contrib):
    """(B, H, W) -> (B * gy * gx,) per-tile maxima (ragged tiles padded)."""
    b, h, w = n_contrib.shape
    gy, gx = -(-h // 16), -(-w // 16)
    pad = np.zeros((b, gy * 16, gx * 16), n_contrib.dtype)
    pad[:, :h, :w] = n_contrib
    return pad.reshape(b, gy, 16, gx, 16).max(axis=(2, 4)).reshape(-1)


@pytest.mark.parametrize("tau", [0.0, 0.5])
def test_plain_compositor_matches_jax_kernel(tau):
    s, a = _inputs()
    want = _jax_composite(tau)
    records = np.array(JB.unblock_stream(jnp.asarray(a["stream"])))
    got = composite_forward(
        torch.as_tensor(records), torch.as_tensor(a["starts"]),
        torch.as_tensor(a["counts"]), torch.as_tensor(a["ray_o"][:, 0, 0, :]),
        torch.as_tensor(a["ray_d"]), torch.as_tensor(s["background"]),
        torch.as_tensor(PATCH_MIN), W, H, tau)
    got = [to_numpy(x) for x in got]
    # The serial blend differs from the kernel's prefix-product scan only
    # by float rounding.
    for name, g, w in zip(("color", "depth", "final_t"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=1e-5, err_msg=name)
    assert_blend_counts_match((got[4], got[3], got[2]), (want[4], want[3], want[2]), tau)
    # nc_tile is the largest n_contrib of each tile on both sides.
    np.testing.assert_array_equal(got[5], _tile_max(got[4]))
    np.testing.assert_array_equal(want[5], _tile_max(want[4]))
    if tau == 0.0:
        np.testing.assert_array_equal(got[5], want[5])
    assert got[4].dtype == np.int32 and got[5].dtype == np.int32
    assert (got[4] > 0).mean() > 0.3 and got[5].max() > 1


@pytest.mark.parametrize("tau", [0.0, 0.5])
def test_reference_compositor_matches_jax(tau):
    s, a = _inputs()
    want_c, want_d, want_aux = jax_reference(
        *(jnp.asarray(s[k]) for k in ("verts", "faces", "verts_color",
                                      "faces_opacity")),
        jnp.asarray(a["verts_ndc"]), jnp.asarray(s["faces_intense"]),
        jnp.asarray(a["aa"]), jnp.asarray(s["background"]), jnp.asarray(PATCH_MIN),
        jnp.asarray(a["ray_o"]), jnp.asarray(a["ray_d"]), tau)
    t = scene_from_jax({k: s[k] for k in ("verts", "faces", "verts_color",
                                          "faces_opacity", "faces_intense",
                                          "background")}, "cpu")
    got_c, got_d, got_aux = render_reference(
        t["verts"], t["faces"], t["verts_color"], t["faces_opacity"],
        torch.as_tensor(a["verts_ndc"]), t["faces_intense"], torch.as_tensor(a["aa"]),
        t["background"], torch.as_tensor(PATCH_MIN), torch.as_tensor(a["ray_o"]),
        torch.as_tensor(a["ray_d"]), tau)
    np.testing.assert_allclose(to_numpy(got_c), np.asarray(want_c), atol=1e-5)
    np.testing.assert_allclose(to_numpy(got_d), np.asarray(want_d), atol=1e-5)
    np.testing.assert_allclose(to_numpy(got_aux.final_t),
                               np.asarray(want_aux.final_t), atol=1e-5)
    assert_blend_counts_match(
        tuple(to_numpy(x) for x in (got_aux.n_contrib, got_aux.final_prev_t,
                                    got_aux.final_t)),
        tuple(np.asarray(x) for x in (want_aux.n_contrib, want_aux.final_prev_t,
                                      want_aux.final_t)), tau)


# Scale of the records' opacities in the work-count tests: low enough that
# no pixel reaches T < T_EPS, so every listed entry is walked and a pair's
# blend does not depend on the faces in front of it.
FAINT = 0.05


@functools.lru_cache(maxsize=2)
def _jax_blend_masks(tau):
    """(F, B, H, W) bool: the pixels the JAX reference compositor blends with
    each face rendered alone (at T = 1, so the transmittance test passes),
    run op by op."""
    s, a = _inputs()
    j = {k: jnp.asarray(s[k]) for k in ("verts", "faces", "verts_color",
                                        "faces_opacity", "faces_intense",
                                        "background")}

    def alone(f):
        _, _, aux = jax_reference(
            j["verts"], j["faces"][f][None], j["verts_color"],
            j["faces_opacity"][f][None], jnp.asarray(a["verts_ndc"]),
            j["faces_intense"][:, f][:, None], jnp.asarray(a["aa"])[:, f][:, None],
            j["background"], jnp.asarray(PATCH_MIN), jnp.asarray(a["ray_o"]),
            jnp.asarray(a["ray_d"]), tau)
        return aux.n_contrib == 1

    # Op by op: fused, XLA:CPU contracts the AA area's multiply-adds into
    # FMAs, which moves sub-resolution blends (_torch_port.assert_blend_counts_match).
    with jax.disable_jit():
        return np.asarray(jax.vmap(alone)(jnp.arange(s["faces"].shape[0])))


def _faint_records():
    _, a = _inputs()
    records = torch.as_tensor(np.array(JB.unblock_stream(jnp.asarray(a["stream"]))))
    records[:, REC_OP] *= FAINT
    return records


def _expected_work(tau, prefix):
    """Work counts of the tile lists cut to ``prefix`` (T,) entries, counted
    with numpy and the JAX reference's blend masks: (records, pairs,
    bbox_pairs, blend_pairs, grad_records, blend_warp_entries,
    grad_batches)."""
    s, a = _inputs()
    f = s["faces"].shape[0]
    masks = _jax_blend_masks(tau)
    aa = np.array(JB.unblock_stream(jnp.asarray(a["stream"])))[:, REC_AA:REC_AA + 6]
    gx, gy = -(-W // 16), -(-H // 16)
    got = dict(records=0, pairs=0, bbox_pairs=0, blend_pairs=0, grad_records=0,
               blend_warp_entries=0, grad_batches=0)
    for t in range(B * gx * gy):
        b, ty, tx = t // (gx * gy), (t % (gx * gy)) // gx, t % gx
        ys, xs = np.mgrid[16 * ty:min(16 * ty + 16, H), 16 * tx:min(16 * tx + 16, W)]
        px0 = (PATCH_MIN[b, 0] + xs).astype(np.float32).ravel()
        py0 = (PATCH_MIN[b, 1] + ys).astype(np.float32).ravel()
        rows = np.arange(a["starts"][t], a["starts"][t] + prefix[t])
        c = aa[rows]
        bbox = ((px0 + 1 >= c[:, 0:6:2].min(1)[:, None]) & (px0 <= c[:, 0:6:2].max(1)[:, None])
                & (py0 + 1 >= c[:, 1:6:2].min(1)[:, None]) & (py0 <= c[:, 1:6:2].max(1)[:, None]))
        assert (a["entry_bf"][rows] // f == b).all()
        blend = masks[a["entry_bf"][rows] % f, b][:, ys.ravel(), xs.ravel()]
        got["records"] += len(rows)
        got["pairs"] += len(rows) * xs.size
        got["bbox_pairs"] += int(bbox.sum())
        got["blend_pairs"] += int(blend.sum())
        got["grad_records"] += int(blend.any(axis=1).sum())
        # The kernel's warps: 8x4 pixel blocks of the tile.
        warp = ((ys % 16) // 4 * 2 + (xs % 16) // 8).ravel()
        got["blend_warp_entries"] += sum(len(np.unique(warp[row])) for row in blend)
        # The backward kernel's gradient batches: 32 pairs of one entry each.
        got["grad_batches"] += int(sum(-(-n // 32) for n in blend.sum(axis=1)))
    return got


def _forward_faint(tau, work=None):
    s, a = _inputs()
    return composite_forward_plain(
        _faint_records(), torch.as_tensor(a["starts"]), torch.as_tensor(a["counts"]),
        torch.as_tensor(a["ray_o"][:, 0, 0, :]), torch.as_tensor(a["ray_d"]),
        torch.as_tensor(s["background"]), torch.as_tensor(PATCH_MIN), W, H, tau,
        work=work)


@pytest.mark.parametrize("tau", [0.0, 1.0])
def test_forward_work_counts(tau):
    """``composite_forward_plain(..., work=)``, which the forward kernel's
    bound is computed from: every listed entry walked, every in-patch pixel
    of its tile a pair, bbox pairs by numpy, blend pairs as the JAX
    reference compositor blends them."""
    s, a = _inputs()
    work = {}
    out = _forward_faint(tau, work)
    assert float(out[2].min()) >= 1e-4
    want = _expected_work(tau, a["counts"])
    # Every pair the reference blends is in its tile's list.
    assert want["blend_pairs"] == int(_jax_blend_masks(tau).sum())
    assert want["blend_pairs"] > 100 and want["bbox_pairs"] < want["pairs"]
    assert {k: int(v) for k, v in work.items()} == {
        k: want[k] for k in ("records", "pairs", "bbox_pairs", "blend_pairs")}


@pytest.mark.parametrize("tau", [0.0, 1.0])
def test_backward_work_counts(tau):
    """``composite_backward_plain(..., work=)``, which the backward kernel's
    bound is computed from: the contributing prefixes min(count, nc_tile)
    walked, their pairs, bbox pairs, blend pairs and the entries with a
    blending pixel, counted as in :func:`test_forward_work_counts`; the
    (entry, warp) pairs with a blending pixel and the kernel's gradient
    batches."""
    s, a = _inputs()
    color, depth, final_t, prev_t, _, nc_tile = _forward_faint(tau)
    ones = torch.ones_like(depth)
    work = {}
    composite_backward_plain(
        _faint_records(), torch.as_tensor(a["starts"]), torch.as_tensor(a["counts"]),
        nc_tile, torch.as_tensor(a["ray_o"][:, 0, 0, :]), torch.as_tensor(a["ray_d"]),
        torch.as_tensor(s["background"]), torch.as_tensor(PATCH_MIN), color, depth,
        final_t, prev_t, torch.ones_like(color), ones, ones, W, H, tau, work=work)
    prefix = np.minimum(a["counts"], nc_tile.numpy())
    assert (prefix < a["counts"]).any()
    want = _expected_work(tau, prefix)
    assert want["grad_records"] < want["records"]
    assert {k: int(v) for k, v in work.items()} == want


def test_records_alignment_check():
    """The compositor kernels copy records with 16-byte cp.async: their
    wrappers refuse a record table that does not start on 16 bytes."""
    from dmesh2_renderer_tpu_torch.ops import _kernels

    table = torch.zeros(4 * 32 + 1, dtype=torch.float32)
    _kernels.check_aligned("records", table[:128].view(4, 32))
    with pytest.raises(ValueError, match="16-byte boundary"):
        _kernels.check_aligned("records", table[1:].view(4, 32))
