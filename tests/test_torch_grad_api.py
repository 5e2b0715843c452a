"""Gradients through the port's entry points vs the JAX package's.

``loss.backward()`` through the port's ``Renderer.forward`` and
``functional.render`` (analytic backward, the plain versions of the kernels
on the CPU) against ``jax.grad`` through the JAX ``Renderer`` and ``render``
with their Pallas kernels in interpret mode. Both sides use JAX's rays (the
two packages' own rays differ by ~1e-6, see tests/test_torch_renderer.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu import geometry as JG
from dmesh2_renderer_tpu.functional import render as jax_render
from dmesh2_renderer_tpu.models.renderer import Renderer as JaxRenderer
from dmesh2_renderer_tpu.utils.config import RasterConfig as JaxConfig
from dmesh2_renderer_tpu_torch import Renderer, render
from dmesh2_renderer_tpu_torch import geometry as TG
from dmesh2_renderer_tpu_torch.convert import (
    config_from_jax, params_from_jax, scene_from_jax,
)
from tests._torch_port import scene_arrays, to_numpy

W, H, PW, PH = 40, 32, 32, 16
MVP_IDX = np.asarray([1, 0], np.int32)
PATCH_MIN = np.asarray([[0, 0], [8, 16]], np.int32)
JAX_CFG = JaxConfig(binning_capacity=2048, interpret=True, warn_on_overflow=False)
PARAMS = ("verts", "verts_color", "faces_opacity")
# The four trainable inputs and their tolerances (tests/test_pallas_bwd.py:
# 97-102): verts go through the Moeller-Trumbore and AA epilogues and the
# projection, which cancel; the rest are sums that only reassociate.
TOL = dict(verts=5e-4, verts_color=2e-5, faces_opacity=2e-5, faces_intense=2e-5)


@functools.lru_cache(maxsize=1)
def _scene():
    s = scene_arrays(b=2, seed=5)
    # Off the icosphere's lattice: exact vertex-on-pixel-boundary ties are
    # subgradient choices.
    s["verts"] = s["verts"] + np.random.default_rng(12345).normal(
        scale=1e-3, size=s["verts"].shape).astype(np.float32)
    rng = np.random.default_rng(9)
    weights = (rng.normal(size=(2, PH, PW, 3)).astype(np.float32),
               rng.normal(size=(2, PH, PW)).astype(np.float32))
    return s, weights


def _check(got, want):
    for name, g in got.items():
        w = want[name]
        assert g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1.0)
        err = np.abs(g - w).max()
        assert err < TOL[name] * scale, f"{name}: max err {err:.3e} (scale {scale:.3e})"
        assert np.abs(w).max() > 1e-2, name


def _port_leaves(s):
    leaves = params_from_jax({k: s[k] for k in PARAMS}, "cpu")
    leaves["faces_intense"] = torch.tensor(s["faces_intense"], requires_grad=True)
    return leaves


def test_renderer_grads_match_jax():
    s, (w_c, w_d) = _scene()
    jr = JaxRenderer(s["mv"], s["proj"], W, H, config=JAX_CFG)

    def jax_loss(verts, verts_color, faces_opacity, faces_intense):
        color, depth = jr.forward(MVP_IDX, PATCH_MIN, PW, PH, verts, s["faces"],
                                  verts_color, faces_opacity, faces_intense,
                                  jnp.asarray(s["background"]), aa_temperature=1.0)
        return jnp.sum(color * w_c) + jnp.sum(depth * w_d)

    names = (*PARAMS, "faces_intense")
    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(s[k]) for k in names))

    t = scene_from_jax({k: s[k] for k in ("mv", "proj", "faces", "background")}, "cpu")
    r = Renderer(t["mv"], t["proj"], W, H, device="cpu",
                 config=config_from_jax(dataclasses.asdict(JAX_CFG)))
    r.ray_o, r.ray_d = torch.as_tensor(np.array(jr.ray_o)), torch.as_tensor(np.array(jr.ray_d))
    p = _port_leaves(s)
    color, depth = r.forward(MVP_IDX, PATCH_MIN, PW, PH, p["verts"], t["faces"],
                             p["verts_color"], p["faces_opacity"],
                             p["faces_intense"], t["background"], aa_temperature=1.0)
    ((color * torch.as_tensor(w_c)).sum() + (depth * torch.as_tensor(w_d)).sum()).backward()
    _check({k: to_numpy(p[k].grad) for k in names},
           {k: np.asarray(g) for k, g in zip(names, want)})
    assert int(r.last_aux.num_truncated) == 0


@pytest.mark.parametrize("tau", [0.5])
def test_functional_render_grads_match_jax(tau, monkeypatch):
    s, _ = _scene()
    rng = np.random.default_rng(10)
    w_c = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    w_d = rng.normal(size=(2, H, W)).astype(np.float32)
    names = (*PARAMS, "faces_intense")

    def jax_loss(verts, verts_color, faces_opacity, faces_intense):
        color, depth, _ = jax_render(verts, jnp.asarray(s["faces"]), verts_color,
                                     faces_opacity, faces_intense,
                                     jnp.asarray(s["mv"]), jnp.asarray(s["proj"]),
                                     jnp.asarray(s["background"]), W, H, tau, JAX_CFG)
        return jnp.sum(color * w_c) + jnp.sum(depth * w_d)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(s[k]) for k in names))

    jax_rays = [torch.as_tensor(np.array(x)) for x in
                JG.init_rays(jnp.asarray(s["mv"]), jnp.asarray(s["proj"]), W, H)]
    monkeypatch.setattr(TG, "init_rays", lambda *a, **k: jax_rays)
    p = _port_leaves(s)
    color, depth, aux = render(p["verts"], s["faces"], p["verts_color"],
                               p["faces_opacity"], p["faces_intense"], s["mv"],
                               s["proj"], s["background"], W, H, tau,
                               config_from_jax(dataclasses.asdict(JAX_CFG)),
                               device="cpu")
    ((color * torch.as_tensor(w_c)).sum() + (depth * torch.as_tensor(w_d)).sum()).backward()
    _check({k: to_numpy(p[k].grad) for k in names},
           {k: np.asarray(g) for k, g in zip(names, want)})
    assert int(aux.num_truncated) == 0


def test_params_from_jax_gives_trainable_leaves():
    s, _ = _scene()
    p = params_from_jax({k: s[k] for k in PARAMS}, "cpu")
    for k in PARAMS:
        assert p[k].is_leaf and p[k].requires_grad and p[k].dtype == torch.float32
        np.testing.assert_array_equal(to_numpy(p[k]), s[k])
    with pytest.raises(ValueError, match="fields"):
        params_from_jax({"verts": s["verts"]}, "cpu")
