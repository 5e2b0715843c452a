"""Port compositors vs the JAX package on identical inputs.

The port's plain tile compositor (the CPU side of ``composite_forward``)
against the JAX Pallas forward kernel in interpret mode on the same record
stream, tile ranges and rays; and the port's reference compositor against
the JAX one.
"""

import functools

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
from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward
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
    arrays = dict(stream=stream, starts=binning.tile_starts,
                  counts=binning.tile_counts, ray_o=ray_o, ray_d=ray_d,
                  verts_ndc=verts_ndc, aa=aa)
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
