"""Port geometry (dmesh2_renderer_tpu_torch.geometry) vs the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu import geometry as JG
from dmesh2_renderer_tpu_torch import geometry as TG
from tests._torch_port import scene_arrays, to_numpy

TOL = dict(atol=1e-5, rtol=1e-5)


def _pair(x):
    return jnp.asarray(x), torch.as_tensor(x)


def test_compute_verts_ndc_image_matches_jax():
    s = scene_arrays(b=3)
    rng = np.random.default_rng(1)
    verts = rng.uniform(-1.5, 1.5, size=(64, 3)).astype(np.float32)
    j = JG.compute_verts_ndc_image(jnp.asarray(verts), jnp.asarray(s["mv"]),
                                   jnp.asarray(s["proj"]), 40, 24)
    t = TG.compute_verts_ndc_image(torch.as_tensor(verts), torch.as_tensor(s["mv"]),
                                   torch.as_tensor(s["proj"]), 40, 24)
    for a, b in zip(j, t):
        np.testing.assert_allclose(to_numpy(b), to_numpy(a), **TOL)


@pytest.mark.parametrize("window", [None, ((5, 3), (12, 20))])
def test_init_rays_matches_jax(window):
    s = scene_arrays(b=2)
    origin, shape = window if window else (None, None)
    j = JG.init_rays(jnp.asarray(s["mv"]), jnp.asarray(s["proj"]), 40, 24,
                     origin=origin, shape=shape)
    t = TG.init_rays(torch.as_tensor(s["mv"]), torch.as_tensor(s["proj"]), 40, 24,
                     origin=origin, shape=shape)
    for a, b in zip(j, t):
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_allclose(to_numpy(b), to_numpy(a), **TOL)


def test_select_rays_matches_jax():
    rng = np.random.default_rng(2)
    ro = rng.normal(size=(3, 24, 40, 3)).astype(np.float32)
    rd = rng.normal(size=(3, 24, 40, 3)).astype(np.float32)
    idx = np.asarray([2, 0], np.int32)
    pm = np.asarray([[0, 0], [24, 8]], np.int32)
    j = JG.select_rays(jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(idx),
                       jnp.asarray(pm), 16, 16)
    t = TG.select_rays(torch.as_tensor(ro), torch.as_tensor(rd), torch.as_tensor(idx),
                       torch.as_tensor(pm), 16, 16)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(to_numpy(b), to_numpy(a))


def test_triangle_precompute_matches_jax():
    rng = np.random.default_rng(3)
    img = rng.uniform(-5, 45, size=(2, 42, 2)).astype(np.float32)
    faces = np.stack([rng.permutation(42)[:3] for _ in range(30)]).astype(np.int32)
    jimg, timg = _pair(img)
    jf, tf = _pair(faces)

    jt = JG.face_aa_triangles(jimg, jf)
    tt = TG.face_aa_triangles(timg, tf)
    for name in jt._fields:
        a, b = to_numpy(getattr(jt, name)), to_numpy(getattr(tt, name))
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, err_msg=name, **TOL)

    np.testing.assert_array_equal(
        to_numpy(TG.face_aa_verts_ccw(timg, tf)),
        to_numpy(JG.face_aa_verts_ccw(jimg, jf)))
    fv = img[:, faces]
    p = [fv[..., k, :] for k in range(3)]
    np.testing.assert_allclose(
        to_numpy(TG.tri_area2(*[torch.as_tensor(x) for x in p])),
        to_numpy(JG.tri_area2(*[jnp.asarray(x) for x in p])), **TOL)
    for a, b in zip(JG.order_ccw(*[jnp.asarray(x) for x in p]),
                    TG.order_ccw(*[torch.as_tensor(x) for x in p])):
        np.testing.assert_array_equal(to_numpy(b), to_numpy(a))


def test_ray_tri_intersection_matches_jax():
    rng = np.random.default_rng(4)
    n = 512
    ro = rng.normal(size=(n, 3)).astype(np.float32) * 3
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    p = [rng.normal(size=(n, 3)).astype(np.float32) for _ in range(3)]
    j = JG.ray_tri_intersection(*[jnp.asarray(x) for x in [ro, rd] + p])
    t = TG.ray_tri_intersection(*[torch.as_tensor(x) for x in [ro, rd] + p])
    np.testing.assert_array_equal(to_numpy(t[3]), to_numpy(j[3]))
    # t, u, v are ratios with the determinant: compare where it is not tiny.
    ok = np.abs(np.einsum("nk,nk->n", np.cross(rd, p[2] - p[0]), p[1] - p[0])) > 1e-2
    assert ok.mean() > 0.9
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_allclose(to_numpy(b)[ok], to_numpy(a)[ok], **TOL)


def test_clamp_bary_uv_matches_jax():
    rng = np.random.default_rng(5)
    uv = rng.uniform(-2.0, 3.0, size=(20000, 2)).astype(np.float32)
    u, v = uv[:, 0], uv[:, 1]
    # Keep points away from every region boundary line, where the codes of
    # both packages are defined by the same ordered tests.
    lines = [u, v, u + v - 1, u - 1, v - 1, v - u + 1, v - u - 1]
    away = np.min(np.abs(np.stack(lines)), axis=0) > 1e-3
    u, v = u[away], v[away]
    ju, jv, jc = JG.clamp_bary_uv(jnp.asarray(u), jnp.asarray(v))
    tu, tv, tc = TG.clamp_bary_uv(torch.as_tensor(u), torch.as_tensor(v))
    np.testing.assert_array_equal(to_numpy(tc), to_numpy(jc))
    assert set(np.unique(to_numpy(tc))) == set(range(7))
    np.testing.assert_allclose(to_numpy(tu), to_numpy(ju), **TOL)
    np.testing.assert_allclose(to_numpy(tv), to_numpy(jv), **TOL)
