"""The port's layered path end to end: LayeredRenderer.generate and
functional.generate_layers vs the JAX package (Pallas in interpret mode)
and vs the numpy oracles of tests/test_peel.py and tests/_tet_walk_oracle.py,
on the CPU (the plain peel)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu.functional import generate_layers as jax_generate_layers
from dmesh2_renderer_tpu.models.layered import LayeredRenderer as JaxLayered
from dmesh2_renderer_tpu.utils.config import RasterConfig as JaxConfig
from dmesh2_renderer_tpu_torch import LayeredRenderer, RasterConfig, generate_layers
from dmesh2_renderer_tpu_torch.convert import config_from_jax, scene_from_jax
from dmesh2_renderer_tpu_torch.utils.meshes import orbit_cameras, tet_grid
from tests._torch_port import to_numpy
from tests.test_peel import _prefix_ok, _subgrid, brute_force_layers

HW = 32
JAX_CFG = JaxConfig(binning_capacity=1 << 13, interpret=True)
PORT_CFG = config_from_jax(dataclasses.asdict(JAX_CFG))
# With each package's own rays, a pixel may differ where two faces meet at
# (near-)equal t: the packages' rays are ~1e-6 apart (ROADMAP.md section 3),
# which can order such hits differently. tests/test_peel.py allows the JAX
# package the same 1% against the brute force.
MISMATCH_FRAC = 0.01


def _scene(seed=0):
    verts, tets, faces, face_tets, tet_faces = tet_grid(res=2)
    exist = np.ones(faces.shape[0], np.int32)
    exist[::3] = 0
    mv, proj = orbit_cameras(2)
    return dict(verts=verts, tets=tets, faces=faces, face_tets=face_tets,
                tet_faces=tet_faces, faces_existence=exist, mv=mv, proj=proj)


def _generate_args(s):
    return [s[k] for k in ("verts", "faces", "tets", "face_tets", "tet_faces",
                           "faces_existence")]


def _mismatch(got, want):
    (gl, gc), (wl, wc) = got, want
    return ((gl != wl).any(axis=-1) | (gc != wc)).mean()


@functools.lru_cache(maxsize=4)
def _jax_generate(num_layers):
    s = _scene()
    r = JaxLayered(s["mv"], s["proj"], HW, HW, config=JAX_CFG)
    layers, counts = r.generate(jnp.asarray([1, 0]), *_generate_args(s), num_layers)
    return np.asarray(layers), np.asarray(counts), [int(x) for x in r.last_aux]


@pytest.mark.parametrize("num_layers", [3, 8])
def test_layered_renderer_matches_jax(num_layers):
    s = _scene()
    want_l, want_c, want_aux = _jax_generate(num_layers)
    t = scene_from_jax(s, "cpu")
    r = LayeredRenderer(t["mv"], t["proj"], HW, HW, "cpu", PORT_CFG)
    layers, counts = r.generate([1, 0], *[t[k] for k in (
        "verts", "faces", "tets", "face_tets", "tet_faces", "faces_existence")],
        num_layers)
    assert layers.dtype == torch.int32 and counts.dtype == torch.int32
    assert tuple(layers.shape) == (2, HW, HW, num_layers)
    got = (to_numpy(layers), to_numpy(counts))
    assert _mismatch(got, (want_l, want_c)) < MISMATCH_FRAC
    assert [int(x) for x in r.last_aux] == want_aux
    assert want_aux[0] > 0 and want_aux[1] == 0
    assert got[1].max() == num_layers
    # views are distinct: camera 1 first, then camera 0
    assert not np.array_equal(got[0][0], got[0][1])


def test_generate_layers_matches_jax_and_the_class():
    """The functional form equals the class form (same rays: both compute
    them with init_rays) and the JAX functional form. Fractional existence
    flags: the functional form keeps a face where the flag is > 0, the class
    casts to int32 first and drops 0.7 -- in both packages."""
    s = _scene()
    exist = np.where(np.arange(len(s["faces"])) % 5 == 0, 0.7, 1.0).astype(np.float32)
    exist[::3] = 0.0
    mv, proj = s["mv"], s["proj"]
    cfg = PORT_CFG
    got = generate_layers(s["verts"], s["faces"], exist, mv, proj, HW, HW, 4,
                          cfg, device="cpu")
    want = jax_generate_layers(jnp.asarray(s["verts"]), jnp.asarray(s["faces"]),
                               jnp.asarray(exist), jnp.asarray(mv),
                               jnp.asarray(proj), HW, HW, 4, JAX_CFG)
    got_np = (to_numpy(got[0]), to_numpy(got[1]))
    assert _mismatch(got_np, (np.asarray(want[0]), np.asarray(want[1]))) < MISMATCH_FRAC
    assert [int(x) for x in got[2]] == [int(x) for x in want[2]]

    r = LayeredRenderer(mv, proj, HW, HW, device="cpu", config=cfg)
    args = _generate_args(s)
    args[-1] = exist
    cls = r.generate([0, 1], *args, 4)
    jr = JaxLayered(mv, proj, HW, HW, config=JAX_CFG)
    jcls = jr.generate(jnp.asarray([0, 1]), *args, 4)
    assert _mismatch((to_numpy(cls[0]), to_numpy(cls[1])),
                     (np.asarray(jcls[0]), np.asarray(jcls[1]))) < MISMATCH_FRAC
    # 0.7 survives in the functional form and not in the class form
    frac = np.isin(got_np[0], np.nonzero(exist == 0.7)[0])
    assert frac.any()
    assert not np.isin(to_numpy(cls[0]), np.nonzero(exist < 1.0)[0]).any()
    # where no 0.7 face is hit, the two forms agree exactly
    keep = ~frac.any(axis=-1)
    assert (to_numpy(cls[0])[keep] == got_np[0][keep]).all()


@pytest.mark.parametrize("num_layers", [3, 8])
def test_layered_renderer_matches_brute_force(num_layers):
    """tests/test_peel.py::test_peel_matches_brute_force, run on the port."""
    verts, tets, faces, face_tets, tet_faces = tet_grid(res=2)
    exist = np.ones(faces.shape[0], np.int32)
    exist[::3] = 0
    mv, proj = orbit_cameras(1)
    lr = LayeredRenderer(mv, proj, HW, HW, device="cpu",
                         config=RasterConfig(binning_capacity=1 << 13))
    layers, counts = lr.generate([0], verts, faces, tets, face_tets, tet_faces,
                                 exist, num_layers)
    layers, counts = to_numpy(layers)[0], to_numpy(counts)[0]
    ref_layers, ref_counts = brute_force_layers(
        verts, faces, exist, to_numpy(lr.ray_o)[0, 0, 0], to_numpy(lr.ray_d)[0],
        num_layers)
    mismatch = (layers != ref_layers).any(axis=-1) | (counts != ref_counts)
    assert mismatch.mean() < MISMATCH_FRAC, f"{mismatch.sum()} pixels differ"
    assert counts.max() > 0


def test_capacity_truncation_keeps_nearest_layers():
    """tests/test_peel.py::test_peel_capacity_truncation_keeps_nearest_layers
    on the port: 122 full-frame triangles x 4 tiles = 488 entries against a
    capacity of 128 (one stream block); tile (0, 0) keeps all, tile (0, 1)
    the 6 nearest faces (3 layers), the bottom tiles none."""
    nq = 61
    f = 2 * nq
    verts = np.zeros((4 * nq, 3), np.float32)
    faces = np.zeros((f, 3), np.int32)
    s = 2.0
    for k in range(nq):
        x = 0.5 - k / nq
        verts[4 * k:4 * k + 4] = [[x, -s, -s], [x, s, -s], [x, s, s], [x, -s, s]]
        faces[2 * k] = [4 * k, 4 * k + 1, 4 * k + 2]
        faces[2 * k + 1] = [4 * k, 4 * k + 2, 4 * k + 3]
    exist = np.ones(f, np.int32)
    dummy = (np.zeros((1, 4), np.int32), np.zeros((f, 2), np.int32),
             np.zeros((1, 4), np.int32))
    mv, proj = orbit_cameras(1)

    def run(capacity):
        cfg = RasterConfig(binning_capacity=capacity, max_tiles_per_face=4,
                           num_giant_faces=0)
        lr = LayeredRenderer(mv, proj, HW, HW, device="cpu", config=cfg)
        layers, counts = lr.generate([0], verts, faces, *dummy, exist, 8)
        return to_numpy(layers)[0], to_numpy(counts)[0], lr.last_aux

    ref_layers, ref_counts, ref_aux = run(2048)
    assert int(ref_aux[1]) == 0
    assert (ref_counts == 8).all()

    layers, counts, aux = run(1)
    assert int(aux[1]) == 488 - 128
    t00, t01, bot = np.s_[:16, :16], np.s_[:16, 16:], np.s_[16:, :]
    np.testing.assert_array_equal(layers[t00], ref_layers[t00])
    np.testing.assert_array_equal(counts[t00], ref_counts[t00])
    np.testing.assert_array_equal(counts[t01], 3)
    np.testing.assert_array_equal(layers[t01][..., :3], ref_layers[t01][..., :3])
    assert (layers[t01][..., 3:] == -1).all()
    assert (counts[bot] == 0).all() and (layers[bot] == -1).all()


def _walk_vs_port(verts, tets, faces, face_tets, tet_faces, exist, hw, num_layers):
    from tests._tet_walk_oracle import walk_layers

    mv, proj = orbit_cameras(1)
    lr = LayeredRenderer(mv, proj, hw, hw, device="cpu",
                         config=RasterConfig(binning_capacity=1 << 14))
    peel_l, peel_c = lr.generate([0], verts, faces, tets, face_tets, tet_faces,
                                 exist, num_layers)
    walk_l, walk_c = walk_layers(
        verts, faces, tets, face_tets, tet_faces, exist,
        to_numpy(lr.ray_o)[0, 0, 0].astype(np.float32),
        to_numpy(lr.ray_d)[0].astype(np.float32), num_layers)
    return walk_l, walk_c, to_numpy(peel_l)[0], to_numpy(peel_c)[0]


def test_port_matches_tet_walk_oracle_convex():
    """tests/test_peel.py::test_peel_matches_tet_walk_oracle_convex on the
    port: on a convex grid the reference walk and the peel agree."""
    verts, tets, faces, face_tets, tet_faces = tet_grid(res=2)
    exist = np.ones(faces.shape[0], np.int32)
    exist[::4] = 0
    walk_l, walk_c, peel_l, peel_c = _walk_vs_port(
        verts, tets, faces, face_tets, tet_faces, exist, 24, 4)
    equal = (walk_l == peel_l).all(axis=-1) & (walk_c == peel_c)
    assert equal.mean() > 0.95, f"{(~equal).sum()} / {equal.size} differ"
    assert _prefix_ok(walk_l, walk_c, peel_l, peel_c).mean() > 0.99


def test_port_vs_tet_walk_nonconvex_divergence_is_prefix_only():
    """tests/test_peel.py::test_peel_vs_tet_walk_nonconvex_divergence_is_
    prefix_only on the port: on a grid with its middle tet layer deleted the
    walk stops at the boundary, and its records are a prefix of the peel's."""
    verts, tets, faces, face_tets, tet_faces = tet_grid(res=3)
    cent = verts[tets].mean(axis=1)
    ext = np.abs(verts[:, 0]).max()
    third = 2 * ext / 3
    keep = ~((cent[:, 0] > -ext + third) & (cent[:, 0] < ext - third))
    assert keep.sum() < keep.size
    tets2, face_tets2, tet_faces2 = _subgrid(verts, tets, faces, tet_faces, keep)
    exist = np.ones(faces.shape[0], np.int32)
    walk_l, walk_c, peel_l, peel_c = _walk_vs_port(
        verts, tets2, faces, face_tets2, tet_faces2, exist, 24, 6)
    assert _prefix_ok(walk_l, walk_c, peel_l, peel_c).mean() > 0.99
    short = (walk_c < peel_c).mean()
    assert short > 0.2, f"only {short:.1%} boundary-stopped rays"


def test_layered_entry_points_check_their_arguments(monkeypatch):
    s = _scene()
    r = LayeredRenderer(s["mv"], s["proj"], HW, HW, device="cpu")
    args = _generate_args(s)
    with pytest.raises(ValueError, match="tet_faces"):
        r.generate([0], *args[:4], args[4][:-1], args[5], 3)
    with pytest.raises(ValueError, match="cameras"):
        r.generate([2], *args, 3)
    bad = s["faces"].copy()
    bad[0, 0] = len(s["verts"])
    with pytest.raises(ValueError, match="outside"):
        r.generate([0], args[0], bad, *args[2:], 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LayeredRenderer(s["mv"], s["proj"], HW, HW)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_layers(s["verts"], s["faces"], s["faces_existence"], s["mv"],
                        s["proj"], HW, HW, 3)
