"""Port AA overlap area (dmesh2_renderer_tpu_torch.aa) vs the JAX package
and the golden areas recorded from the original reference's oracle."""

import os

import jax.numpy as jnp
import numpy as np
import torch

from dmesh2_renderer_tpu import aa as JA
from dmesh2_renderer_tpu.geometry import order_ccw
from dmesh2_renderer_tpu_torch import aa as TA
from dmesh2_renderer_tpu_torch.geometry import make_triangles
from tests._torch_port import to_numpy

FIXTURE = os.path.join(os.path.dirname(__file__), "golden", "aa_golden.npz")


def _ccw_tris(n, rng, lo, hi):
    p = rng.uniform(lo, hi, size=(n, 3, 2)).astype(np.float32)
    q = order_ccw(*(jnp.asarray(p[:, k]) for k in range(3)))
    return np.stack([np.asarray(x) for x in q], axis=1)


def test_tri_box_overlap_area_matches_jax():
    rng = np.random.default_rng(0)
    # Triangles from sub-pixel to far larger than the box, around the box.
    tris = np.concatenate([_ccw_tris(400, rng, -1.0, 2.0),
                           _ccw_tris(400, rng, -30.0, 30.0)])
    x0 = rng.integers(-2, 2, size=(tris.shape[0],)).astype(np.float32)
    y0 = rng.integers(-2, 2, size=(tris.shape[0],)).astype(np.float32)
    want = JA.tri_box_overlap_area(jnp.asarray(tris), jnp.asarray(x0),
                                   jnp.asarray(x0 + 1), jnp.asarray(y0),
                                   jnp.asarray(y0 + 1))
    got = TA.tri_box_overlap_area(torch.as_tensor(tris), torch.as_tensor(x0),
                                  torch.as_tensor(x0 + 1), torch.as_tensor(y0),
                                  torch.as_tensor(y0 + 1))
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), atol=1e-5, rtol=1e-5)
    assert (to_numpy(want) > 0).mean() > 0.2


def test_tri_box_overlap_area_xy_matches_jax():
    """Faces as (C, 1) columns against (1, N) pixel planes, the compositor's
    layout, far from the origin where cancellation would show."""
    rng = np.random.default_rng(1)
    tris = _ccw_tris(64, rng, 990.0, 1010.0)
    px = rng.integers(988, 1012, size=(1, 256)).astype(np.float32)
    py = rng.integers(988, 1012, size=(1, 256)).astype(np.float32)
    cols = [tris[:, k // 2, k % 2][:, None] for k in range(6)]
    want = JA.tri_box_overlap_area_xy(*[jnp.asarray(c) for c in cols],
                                      jnp.asarray(px), jnp.asarray(px + 1),
                                      jnp.asarray(py), jnp.asarray(py + 1))
    got = TA.tri_box_overlap_area_xy(*[torch.as_tensor(c) for c in cols],
                                     torch.as_tensor(px), torch.as_tensor(px + 1),
                                     torch.as_tensor(py), torch.as_tensor(py + 1))
    assert tuple(got.shape) == (64, 256)
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), atol=1e-5, rtol=1e-5)
    assert (to_numpy(want) > 0).mean() > 0.05


def test_overlap_area_matches_reference_golden():
    g = np.load(FIXTURE)
    tv = torch.as_tensor(g["tri_verts"].astype(np.float32))
    tris = make_triangles(tv[:, 0], tv[:, 1], tv[:, 2])
    ok = ~g["degenerate"]
    tid, pid = g["tid"][ok], g["pid"][ok]
    pmin = torch.as_tensor(g["pix_min"].astype(np.float32))[pid]
    pmax = torch.as_tensor(g["pix_max"].astype(np.float32))[pid]
    area = TA.tri_box_overlap_area(tris.verts[tid], pmin[:, 0], pmax[:, 0],
                                   pmin[:, 1], pmax[:, 1])
    # f32 winding integrals on O(10) coordinates vs the f64 reference walk
    # (the tolerance of tests/test_golden_aa.py).
    np.testing.assert_allclose(to_numpy(area), g["area"][ok], atol=5e-5, rtol=1e-5)
