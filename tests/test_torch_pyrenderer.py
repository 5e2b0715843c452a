"""The port's pyrenderer mirror (dmesh2_renderer_tpu_torch/pyrenderer.py)
and its AA oracle copy vs the JAX package's, on the inputs of
tests/test_pyrenderer.py: areas, clip polygons and counts, both return
forms, the analytic gradient (and torch.autograd of the area) and the
strict-mode error codes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu import pyrenderer as JP
from dmesh2_renderer_tpu.aa import tri_box_overlap_area as jax_area
from dmesh2_renderer_tpu.oracle import aa_oracle as JO
from dmesh2_renderer_tpu_torch import pyrenderer as TP
from dmesh2_renderer_tpu_torch.aa import tri_box_overlap_area
from dmesh2_renderer_tpu_torch.oracle import aa_oracle as TO
from tests._torch_port import to_numpy


def _inputs(n=256, seed=0):
    """tests/test_pyrenderer.py::_random_tris_pixels, as numpy arrays."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1.5, 2.5, size=(3, n, 2)).astype(np.float32)
    pmin = rng.uniform(-0.5, 1.0, size=(n, 2)).astype(np.float32)
    return p, pmin


def _both(p, pmin):
    return ((JP.Triangles(p[0], p[1], p[2]), JP.make_pixels(pmin, pmin + 1.0)),
            (TP.Triangles(p[0], p[1], p[2]), TP.make_pixels(pmin, pmin + 1.0)))


@pytest.mark.parametrize("n,seed", [(256, 0), (512, 7)])
def test_overlap_area_and_polygons_match_jax(n, seed):
    """Areas within 1e-6, and the padded polygon form: counts equal,
    vertices within 1e-5; the triangle precompute and pixel boxes too."""
    (jt, jpx), (tt, tpx) = _both(*_inputs(n, seed))
    for name in jt._fields:
        np.testing.assert_allclose(to_numpy(getattr(tt, name)),
                                   np.asarray(getattr(jt, name)), rtol=1e-6)
    np.testing.assert_array_equal(to_numpy(tpx.verts), np.asarray(jpx.verts))
    np.testing.assert_array_equal(to_numpy(tpx.edges), np.asarray(jpx.edges))
    want_a, (want_p, want_c) = JP.tri_pixel_overlap_area(jt, jpx, jnp.arange(n),
                                                         jnp.arange(n))
    got_a, (got_p, got_c) = TP.tri_pixel_overlap_area(tt, tpx, torch.arange(n),
                                                      torch.arange(n))
    assert got_p.shape == (n, TP.MAX_POLY, 2) and got_c.dtype == torch.int32
    np.testing.assert_allclose(to_numpy(got_a), np.asarray(want_a), atol=1e-6)
    np.testing.assert_array_equal(to_numpy(got_c), np.asarray(want_c))
    np.testing.assert_allclose(to_numpy(got_p), np.asarray(want_p), atol=1e-5)
    assert 0 < int((got_c >= 3).sum()) < n      # overlaps, and misses


def test_oracle_copy_matches_jax():
    """The port's numpy oracle is the JAX package's, value for value, and
    agrees with the port's closed-form area."""
    p, pmin = _inputs(64, 3)
    tris = TP.Triangles(p[0], p[1], p[2])
    tv = to_numpy(tris.verts)
    got = tri_box_overlap_area(tris.verts, torch.as_tensor(pmin[:, 0]),
                               torch.as_tensor(pmin[:, 0] + 1.0),
                               torch.as_tensor(pmin[:, 1]),
                               torch.as_tensor(pmin[:, 1] + 1.0))
    for i in range(64):
        box = (pmin[i, 0], pmin[i, 0] + 1.0, pmin[i, 1], pmin[i, 1] + 1.0)
        want = JO.tri_box_area_oracle(tv[i], *box)
        assert TO.tri_box_area_oracle(tv[i], *box) == want
        assert abs(float(got[i]) - want) < 1e-5
        np.testing.assert_array_equal(TO.tri_box_grad_fd(tv[i], *box),
                                      JO.tri_box_grad_fd(tv[i], *box))


def test_scalar_fast_paths_match_jax():
    """The scalar return forms: (pixel area, the (4, 2) corners) for a
    pixel inside the triangle, (0, []) for a separated one, and a list of
    points for a generic overlap, each equal to the JAX module's."""
    tri = [np.array([[-10.0, -10.0]], np.float32), np.array([[10.0, -10.0]], np.float32),
           np.array([[0.0, 10.0]], np.float32)]
    cases = {"inside": ([0.0, 0.0], [1.0, 1.0]), "far": ([100.0, 100.0], [101.0, 101.0]),
             "mid": ([9.0, -10.5], [10.5, -9.0])}
    for name, (lo, hi) in cases.items():
        lo, hi = np.array([lo], np.float32), np.array([hi], np.float32)
        want_a, want_p = JP.tri_pixel_overlap_area(JP.Triangles(*tri), JP.Pixels(lo, hi), 0, 0)
        got_a, got_p = TP.tri_pixel_overlap_area(TP.Triangles(*tri), TP.Pixels(lo, hi), 0, 0)
        assert abs(float(got_a) - float(want_a)) < 1e-6, name
        if name == "far":
            assert got_p == [] and want_p == []
        elif name == "inside":
            assert isinstance(got_p, torch.Tensor) and got_p.shape == (4, 2)
            np.testing.assert_array_equal(to_numpy(got_p), np.asarray(want_p))
        else:
            assert isinstance(got_p, list) and len(got_p) == len(want_p) >= 3
            np.testing.assert_allclose(np.stack([to_numpy(q) for q in got_p]),
                                       np.stack([np.asarray(q) for q in want_p]),
                                       atol=1e-5)


def _strict_outcome(mod, tris, pixs, i):
    try:
        area, poly = mod.tri_pixel_overlap_area(tris, pixs, i, i, strict=True)
    except ValueError as e:
        return str(e)
    return len(poly)


def test_strict_error_codes_match_jax():
    """On vertices and pixels of a half-unit lattice (edges through pixel
    corners, edges along pixel edges, vertices on them) strict mode raises
    the same ``[pyrasterizer] Error code NN`` as the JAX module for every
    pair, or returns the same polygon length; the graceful default never
    raises. The test of tests/test_pyrenderer.py (E00) is among them."""
    rng = np.random.default_rng(0)
    n = 120
    p = (rng.integers(-2, 6, size=(3, n, 2)) * 0.5).astype(np.float32)
    pmin = (rng.integers(-1, 3, size=(n, 2)) * 0.5).astype(np.float32)
    # pair 0: tests/test_pyrenderer.py::test_strict_error_code_e00
    p[:, 0] = [[-1.0, -1.0], [3.0, 3.0], [-1.0, 3.0]]
    pmin[0] = [0.0, 0.0]
    (jt, _), (tt, _) = _both(p, pmin)
    hi = pmin + np.where(np.arange(n)[:, None] == 0, 2.0, 1.0).astype(np.float32)
    jpx, tpx = JP.Pixels(pmin, hi), TP.Pixels(pmin, hi)
    seen = set()
    for i in range(n):
        want = _strict_outcome(JP, jt, jpx, i)
        assert _strict_outcome(TP, tt, tpx, i) == want, i
        seen.add(want if isinstance(want, str) else "ok")
        TP.tri_pixel_overlap_area(tt, tpx, i, i)
    assert _strict_outcome(TP, tt, tpx, 0) == "[pyrasterizer] Error code 00"
    assert {"ok", "[pyrasterizer] Error code 00",
            "[pyrasterizer] Error code 04"} <= seen, seen


def test_overlap_grad_matches_jax_and_autograd():
    """The analytic shape derivative equals the JAX module's within 1e-5,
    and torch.autograd of the summed area within the 2e-4 of
    tests/test_pyrenderer.py; the use_autograd flag leaves areas unchanged."""
    p, pmin = _inputs(64, 1)
    (jt, jpx), (tt, tpx) = _both(p, pmin)
    want = np.asarray(JP.tri_pixel_overlap_area_grad(jt, jpx, jnp.arange(64),
                                                     jnp.arange(64)))
    got = TP.tri_pixel_overlap_area_grad(tt, tpx, torch.arange(64), torch.arange(64))
    np.testing.assert_allclose(to_numpy(got), want, atol=1e-5)

    tv = tt.verts.clone().requires_grad_(True)
    pv = tpx.verts
    tri_box_overlap_area(tv, pv[:, 0, 0], pv[:, 2, 0], pv[:, 0, 1], pv[:, 2, 1]).sum().backward()
    np.testing.assert_allclose(to_numpy(got), to_numpy(tv.grad), atol=2e-4)

    def area_sum(v):
        q = jpx.verts
        return jnp.sum(jax_area(v, q[:, 0, 0], q[:, 2, 0], q[:, 0, 1], q[:, 2, 1]))

    np.testing.assert_allclose(to_numpy(tv.grad), np.asarray(jax.grad(area_sum)(jt.verts)),
                               atol=1e-5)
    a0, _ = TP.tri_pixel_overlap_area(tt, tpx, torch.arange(64), torch.arange(64))
    a1, _ = TP.tri_pixel_overlap_area(tt, tpx, torch.arange(64), torch.arange(64),
                                      use_autograd=True)
    assert torch.equal(a0, a1)


def test_tri_area_and_exports_match_jax():
    p, _ = _inputs(32, 5)
    got = TP.tri_area(*(torch.as_tensor(x) for x in p))
    np.testing.assert_allclose(to_numpy(got), np.asarray(JP.tri_area(*map(jnp.asarray, p))),
                               rtol=1e-6)
    assert (TP.EPS, TP.MAX_POLY) == (JP.EPS, JP.MAX_POLY)
    assert sorted(TP.__all__) == sorted(JP.__all__)
