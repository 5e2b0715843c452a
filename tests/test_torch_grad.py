"""Gradients of the port's rasterize op vs the JAX package's.

The port's ``torch.autograd.Function`` (analytic backward, the plain
versions of the kernels on the CPU) against ``jax.grad`` through the JAX
``make_rasterizer`` op with its Pallas kernels in interpret mode, on the same
inputs and JAX's rays; and ``use_pallas=False`` (autograd of the plain
reference compositor) against ``jax.grad`` of the JAX reference. Scene:
icosphere(1) with 1e-3 jitter, 2 views, 32x16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu import geometry as JG
from dmesh2_renderer_tpu.ops.rasterize import make_rasterizer as jax_make_rasterizer
from dmesh2_renderer_tpu.utils.config import RasterConfig as JaxConfig
from dmesh2_renderer_tpu.utils.meshes import icosphere, orbit_cameras
from dmesh2_renderer_tpu_torch import RasterConfig
from dmesh2_renderer_tpu_torch.ops.rasterize import make_rasterizer
from tests._torch_port import to_numpy

W, H, B = 32, 16, 2
INPUTS = ("verts", "verts_color", "faces_opacity", "verts_ndc", "faces_intense",
          "aa_face_verts")
# tests/test_pallas_bwd.py:97-102: colour, opacity, intensity and NDC z
# sums reassociate only; verts and the AA corners go through the
# Moeller-Trumbore and edge epilogues, which cancel.
TOL = dict(verts=5e-4, verts_color=2e-5, faces_opacity=2e-5, verts_ndc=2e-5,
           faces_intense=2e-5, aa_face_verts=5e-4)


@functools.lru_cache(maxsize=1)
def _scene():
    """The six differentiable inputs, the rest of the op's arguments and the
    loss weights, all numpy."""
    verts, faces = icosphere(1)
    verts = verts + np.random.default_rng(12345).normal(
        scale=1e-3, size=verts.shape).astype(np.float32)
    mv, proj = (jnp.asarray(x) for x in orbit_cameras(B))
    rng = np.random.default_rng(1)
    f = faces.shape[0]
    ray_o, ray_d = JG.init_rays(mv, proj, W, H)
    ndc, img = JG.compute_verts_ndc_image(jnp.asarray(verts), mv, proj, W, H)
    diff = dict(
        verts=verts,
        verts_color=rng.uniform(size=verts.shape).astype(np.float32),
        faces_opacity=rng.uniform(0.3, 0.95, size=(f,)).astype(np.float32),
        verts_ndc=np.array(ndc),
        faces_intense=rng.uniform(0.5, 1.0, size=(B, f)).astype(np.float32),
        aa_face_verts=np.array(JG.face_aa_triangles(img, jnp.asarray(faces)).verts),
    )
    rest = dict(faces=faces, background=np.asarray([0.1, 0.2, 0.3], np.float32),
                patch_min=np.zeros((B, 2), np.int32),
                ray_o_cam=np.array(ray_o[:, 0, 0, :]), ray_d=np.array(ray_d))
    weights = [rng.normal(size=s).astype(np.float32)
               for s in ((B, H, W, 3), (B, H, W), (B, H, W))]
    return diff, rest, weights


def _jax_loss(raster, weights):
    _, rest, _ = _scene()
    fixed = [jnp.asarray(rest[k]) for k in ("faces", "background", "patch_min",
                                           "ray_o_cam", "ray_d")]

    def loss(*six):
        color, depth, final_t, _ = raster(*six, *fixed)
        return sum(jnp.sum(o * jnp.asarray(w))
                   for o, w in zip((color, depth, final_t), weights))
    return loss


def _jax_grads(tau, use_pallas, weights):
    diff, _, _ = _scene()
    cfg = JaxConfig(binning_capacity=1024, interpret=True, use_pallas=use_pallas)
    raster = jax_make_rasterizer(W, H, tau, cfg)
    grads = jax.grad(_jax_loss(raster, weights), argnums=tuple(range(6)))(
        *(jnp.asarray(diff[k]) for k in INPUTS))
    return [np.asarray(g) for g in grads]


def _port_grads(tau, use_pallas, weights):
    diff, rest, _ = _scene()
    leaves = [torch.tensor(diff[k], requires_grad=True) for k in INPUTS]
    fixed = [torch.as_tensor(rest[k]) for k in ("faces", "background",
                                                "patch_min", "ray_o_cam", "ray_d")]
    raster = make_rasterizer(W, H, tau, RasterConfig(binning_capacity=1024,
                                                     use_pallas=use_pallas))
    color, depth, final_t, aux = raster(*leaves, *fixed)
    loss = sum((o * torch.as_tensor(w)).sum()
               for o, w in zip((color, depth, final_t), weights))
    loss.backward()
    # An input the loss does not depend on gets no .grad (the AA corners at
    # tau = 0 on the reference path); jax.grad gives zeros there.
    return [np.zeros(x.shape, np.float32) if x.grad is None else to_numpy(x.grad)
            for x in leaves], aux


def _check(got, want, label):
    for name, g, w in zip(INPUTS, got, want):
        assert g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1.0)
        err = np.abs(g - w).max()
        assert err < TOL[name] * scale, \
            f"{label} {name}: max err {err:.3e} (scale {scale:.3e})"


@pytest.mark.parametrize("tau", [1.0, 0.0])
def test_rasterize_grads_match_jax_kernels(tau):
    _, _, weights = _scene()
    want = _jax_grads(tau, True, weights)
    got, aux = _port_grads(tau, True, weights)
    _check(got, want, f"tau={tau}")
    assert int(aux.num_rendered) > 0 and int(aux.num_truncated) == 0
    # NDC x/y get no gradient here (they reach the loss through the AA
    # triangles), and every input does get one.
    assert not got[3][..., :2].any()
    for name, w in zip(INPUTS, want):
        if name != "aa_face_verts" or tau > 0:
            assert np.abs(w).max() > 1e-2, name


def test_final_t_cotangent_reaches_the_gradients():
    """A loss on final_t alone gives non-zero opacity gradients, equal to
    JAX's."""
    _, _, weights = _scene()
    only_t = [np.zeros_like(weights[0]), np.zeros_like(weights[1]), weights[2]]
    want = _jax_grads(1.0, True, only_t)
    got, _ = _port_grads(1.0, True, only_t)
    _check(got, want, "final_t")
    assert np.abs(got[2]).max() > 1e-2
    assert not got[1].any()                  # colour does not move final_t


@pytest.mark.parametrize("tau", [1.0, 0.0])
def test_reference_path_grads_match_jax_reference(tau):
    """use_pallas=False: torch autograd of the port's render_reference vs
    jax.grad of the JAX render_reference (no kernels on either side)."""
    _, _, weights = _scene()
    want = _jax_grads(tau, False, weights)
    got, aux = _port_grads(tau, False, weights)
    _check(got, want, f"reference tau={tau}")
    assert [int(x) for x in aux] == [0, 0, 0]
