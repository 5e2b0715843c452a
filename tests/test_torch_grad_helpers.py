"""The port's gradient helpers (barycentric-clamp and Moeller-Trumbore
Jacobians, Liang-Barsky clip, AA shape derivative) vs the JAX package on
seeded inputs, and the AA gradient vs the golden gradients recorded from the
original reference's oracle."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu import aa as JA
from dmesh2_renderer_tpu import geometry as JG
from dmesh2_renderer_tpu_torch import aa as TA
from dmesh2_renderer_tpu_torch import geometry as TG
from tests._torch_port import to_numpy

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "aa_golden.npz")


def _ccw_tris(n, rng, lo, hi):
    p = rng.uniform(lo, hi, size=(n, 3, 2)).astype(np.float32)
    q = JG.order_ccw(*(jnp.asarray(p[:, k]) for k in range(3)))
    return np.stack([np.asarray(x) for x in q], axis=1)


def _boxes(n, rng):
    x0 = rng.integers(-2, 2, size=(n,)).astype(np.float32)
    y0 = rng.integers(-2, 2, size=(n,)).astype(np.float32)
    return x0, x0 + 1, y0, y0 + 1


def test_clamp_bary_uv_grad_matches_jax():
    """Every region code, with boundaries hit exactly: the Jacobian is a
    pure function of the code, so the two must be equal."""
    rng = np.random.default_rng(0)
    u = rng.uniform(-1.5, 2.5, size=4096).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, size=4096).astype(np.float32)
    u[:64], v[64:128] = 0.0, 0.0
    v[128:192] = 1.0 - u[128:192]
    _, _, code = JG.clamp_bary_uv(jnp.asarray(u), jnp.asarray(v))
    _, _, tcode = TG.clamp_bary_uv(torch.as_tensor(u), torch.as_tensor(v))
    np.testing.assert_array_equal(to_numpy(tcode), np.asarray(code))
    assert set(np.unique(np.asarray(code)).tolist()) == set(range(7))
    for got, want in zip(TG.clamp_bary_uv_grad(tcode), JG.clamp_bary_uv_grad(code)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_ray_tri_intersection_uv_grad_matches_jax():
    """Rays from cameras around the origin towards triangles near it, the
    renderer's conditioning. Tolerance: float32 rounding of the triple
    products, relative to each Jacobian's scale."""
    rng = np.random.default_rng(1)
    n = 2048
    ray_o = rng.normal(size=(n, 3)).astype(np.float32)
    ray_o *= (3.0 / np.linalg.norm(ray_o, axis=1, keepdims=True)).astype(np.float32)
    p = rng.uniform(-0.5, 0.5, size=(3, n, 3)).astype(np.float32)
    target = (p.mean(axis=0) + rng.normal(scale=0.2, size=(n, 3))).astype(np.float32)
    ray_d = target - ray_o
    ray_d /= np.linalg.norm(ray_d, axis=1, keepdims=True)
    want = JG.ray_tri_intersection_uv_grad(*(jnp.asarray(x) for x in (ray_o, ray_d, *p)))
    got = TG.ray_tri_intersection_uv_grad(*(torch.as_tensor(x) for x in (ray_o, ray_d, *p)))
    for g, w in zip(got, want):
        g, w = to_numpy(g), np.asarray(w)
        assert g.shape == (n, 3)
        scale = np.abs(w).max(axis=1, keepdims=True) + 1e-3
        np.testing.assert_array_less(np.abs(g - w) / scale, 1e-4)
    # The Jacobian of u is the one autograd gives for the port's own MT.
    t = [torch.as_tensor(x[:8]).double().requires_grad_(i >= 2)
         for i, x in enumerate((ray_o, ray_d, *p))]
    _, u, _, _ = TG.ray_tri_intersection(*t)
    du = torch.autograd.grad(u.sum(), t[2:])
    an = TG.ray_tri_intersection_uv_grad(*t)
    for a, b in zip(du, an[:3]):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=1e-9, atol=1e-9)


def _segments_with_degenerate_axes(rng, n):
    """Random segments around a unit box, a quarter of them with dx == 0
    and a quarter with dy == 0, inside and outside the box's slabs (the
    +-inf rule of the clip)."""
    a = rng.uniform(-1.5, 2.5, size=(n, 2)).astype(np.float32)
    b = rng.uniform(-1.5, 2.5, size=(n, 2)).astype(np.float32)
    q = n // 4
    b[:q, 0] = a[:q, 0]
    b[q:2 * q, 1] = a[q:2 * q, 1]
    return a, b


def test_edge_clip_interval_matches_jax():
    rng = np.random.default_rng(2)
    a, b = _segments_with_degenerate_axes(rng, 4096)
    box = (np.float32(0.0), np.float32(1.0), np.float32(0.0), np.float32(1.0))
    want = JA._edge_clip_interval(*(jnp.asarray(c) for c in (a[:, 0], a[:, 1],
                                                             b[:, 0], b[:, 1])),
                                  *box)
    got = TA._edge_clip_interval(*(torch.as_tensor(c) for c in (a[:, 0], a[:, 1],
                                                               b[:, 0], b[:, 1])),
                                 *(torch.tensor(x) for x in box))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=1e-6)
    t0, t1 = (np.asarray(x) for x in want)
    # Both the empty and the full interval occur on the degenerate axes.
    assert ((t1 - t0)[:2048] == 0).any() and ((t1 - t0)[:2048] == 1).any()


def test_tri_box_edge_weights_xy_matches_jax():
    """Faces as (C, 1) columns against (1, N) pixel planes."""
    rng = np.random.default_rng(3)
    tris = np.concatenate([_ccw_tris(48, rng, -1.0, 3.0), _ccw_tris(16, rng, -20.0, 20.0)])
    tris[:8, 1, 0] = tris[:8, 0, 0]          # vertical edges
    tris[8:16, 2, 1] = tris[8:16, 1, 1]      # horizontal edges
    px = rng.integers(-2, 3, size=(1, 256)).astype(np.float32)
    py = rng.integers(-2, 3, size=(1, 256)).astype(np.float32)
    cols = [tris[:, k // 2, k % 2][:, None] for k in range(6)]
    want = JA.tri_box_edge_weights_xy(*[jnp.asarray(c) for c in cols],
                                      jnp.asarray(px), jnp.asarray(px + 1),
                                      jnp.asarray(py), jnp.asarray(py + 1))
    got = TA.tri_box_edge_weights_xy(*[torch.as_tensor(c) for c in cols],
                                     torch.as_tensor(px), torch.as_tensor(px + 1),
                                     torch.as_tensor(py), torch.as_tensor(py + 1))
    for ge, we in zip(got, want):
        for g, w in zip(ge, we):
            assert tuple(g.shape) == (64, 256)
            np.testing.assert_allclose(to_numpy(g), np.asarray(w), atol=1e-6)
    assert (np.abs(np.asarray(want[0][0])) > 0).mean() > 0.05


@pytest.mark.parametrize("planes", [False, True])
def test_tri_box_overlap_area_grad_matches_jax(planes):
    """The stacked form, and the coordinate-plane form against the stacked
    JAX gradient."""
    rng = np.random.default_rng(4)
    tris = np.concatenate([_ccw_tris(400, rng, -1.0, 2.0),
                           _ccw_tris(400, rng, -30.0, 30.0)])
    box = _boxes(tris.shape[0], rng)
    want = np.asarray(JA.tri_box_overlap_area_grad(jnp.asarray(tris),
                                                   *(jnp.asarray(x) for x in box)))
    tbox = [torch.as_tensor(x) for x in box]
    tt = torch.as_tensor(tris)
    if planes:
        g = TA.tri_box_overlap_grad_xy(*[tt[:, k // 2, k % 2] for k in range(6)], *tbox)
        got = torch.stack(g, dim=-1).reshape(-1, 3, 2)
    else:
        got = TA.tri_box_overlap_area_grad(tt, *tbox)
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-5, rtol=1e-5)
    assert (np.abs(want).sum(axis=(1, 2)) > 0).mean() > 0.1


def test_overlap_grad_matches_reference_golden():
    """The 512 recorded triangle-pixel pairs (the JAX side's test and
    tolerance: tests/test_golden_aa.py)."""
    g = np.load(FIXTURE)
    tv = torch.as_tensor(g["tri_verts"].astype(np.float32))
    tris = TG.make_triangles(tv[:, 0], tv[:, 1], tv[:, 2])
    ok = ~g["degenerate"]
    tid, pid = g["tid"][ok], g["pid"][ok]
    pmin = torch.as_tensor(g["pix_min"].astype(np.float32))[pid]
    pmax = torch.as_tensor(g["pix_max"].astype(np.float32))[pid]
    grad = TA.tri_box_overlap_area_grad(tris.verts[tid], pmin[:, 0], pmax[:, 0],
                                        pmin[:, 1], pmax[:, 1])
    want = g["grad"][ok]
    np.testing.assert_allclose(to_numpy(grad), want, atol=2e-4)
    assert (np.abs(want).sum(axis=(1, 2)) > 0).sum() > 100
