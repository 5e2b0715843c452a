"""The port's forward slice end to end: Renderer and functional.render vs
the JAX package (Pallas kernels in interpret mode), plus the port's guards."""

import dataclasses
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu.functional import render as jax_render
from dmesh2_renderer_tpu.functional import render_banded as jax_render_banded
from dmesh2_renderer_tpu.models.renderer import Renderer as JaxRenderer
from dmesh2_renderer_tpu.utils.config import RasterConfig as JaxConfig
from dmesh2_renderer_tpu_torch import (
    RasterConfig, Renderer, render, render_banded, render_partial,
)
from dmesh2_renderer_tpu_torch.convert import config_from_jax, scene_from_jax
from tests._torch_port import scene_arrays, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, PW, PH = 48, 48, 32, 32
MVP_IDX = np.asarray([1, 0], np.int32)
PATCH_MIN = np.asarray([[0, 0], [12, 16]], np.int32)
JAX_CFG = JaxConfig(binning_capacity=2048, interpret=True)
# Colour and depth with identical rays: the two packages project with
# float32 rounding in different places (XLA fuses multiply-adds into FMAs),
# so screen coordinates differ by ulps; 2e-5 bounds their effect.
TOL = dict(atol=2e-5)
# Colour and depth with each package's own rays: init_rays unprojects every
# pixel at the near plane, 0.1 from the camera, and subtracts the camera
# position, 3 away. That 30x cancellation turns the two packages'
# differently ordered float32 matrix products into ray directions ~1e-6
# apart (test_torch_geometry holds init_rays at 1e-5), which moves u, v and
# so the interpolated colour by up to ~1e-4 on faces seen at grazing angles.
OWN_RAYS_TOL = dict(atol=1e-4)

RENDER_KEYS = ("verts", "faces", "verts_color", "faces_opacity",
               "faces_intense", "background")


def _forward_args(s):
    return [s[k] for k in RENDER_KEYS]


@functools.lru_cache(maxsize=2)
def _jax_renderer_out(tau):
    s = scene_arrays(b=2)
    r = JaxRenderer(s["mv"], s["proj"], W, H, config=JAX_CFG)
    color, depth = r.forward(MVP_IDX, PATCH_MIN, PW, PH,
                             *[jnp.asarray(x) for x in _forward_args(s)],
                             aa_temperature=tau)
    return (np.asarray(color), np.asarray(depth), [int(x) for x in r.last_aux],
            np.array(r.ray_o), np.array(r.ray_d))


@pytest.mark.parametrize("tau", [0.0, 1.0])
def test_renderer_forward_matches_jax(tau):
    s = scene_arrays(b=2)
    want_c, want_d, want_aux, jax_ray_o, jax_ray_d = _jax_renderer_out(tau)
    t = scene_from_jax(s, "cpu")
    r = Renderer(t["mv"], t["proj"], W, H, device="cpu",
                 config=config_from_jax(dataclasses.asdict(JAX_CFG)))
    np.testing.assert_allclose(to_numpy(r.ray_d), jax_ray_d, atol=1e-5)
    own = r.forward(MVP_IDX, PATCH_MIN, PW, PH, *[t[k] for k in RENDER_KEYS],
                    aa_temperature=tau)
    own_aux = [int(x) for x in r.last_aux]
    r.ray_o, r.ray_d = torch.as_tensor(jax_ray_o), torch.as_tensor(jax_ray_d)
    color, depth = r.forward(MVP_IDX, PATCH_MIN, PW, PH,
                             *[t[k] for k in RENDER_KEYS], aa_temperature=tau)
    assert tuple(color.shape) == (2, PH, PW, 3) and tuple(depth.shape) == (2, PH, PW)
    np.testing.assert_allclose(to_numpy(color), want_c, **TOL)
    np.testing.assert_allclose(to_numpy(depth), want_d, **TOL)
    np.testing.assert_allclose(to_numpy(own[0]), want_c, **OWN_RAYS_TOL)
    np.testing.assert_allclose(to_numpy(own[1]), want_d, **OWN_RAYS_TOL)
    assert [int(x) for x in r.last_aux] == want_aux == own_aux
    assert want_aux[0] > 0 and want_aux[1] == 0
    # the two windows really render different pixels of different views
    assert not np.allclose(want_c[0], want_c[1])


def test_functional_render_matches_jax():
    s = scene_arrays(b=2, seed=3)
    want = jax_render(*[jnp.asarray(s[k]) for k in RENDER_KEYS[:5]],
                      jnp.asarray(s["mv"]), jnp.asarray(s["proj"]),
                      jnp.asarray(s["background"]), 40, 36, 1.0, JAX_CFG)
    got = render(*[s[k] for k in RENDER_KEYS[:5]], s["mv"], s["proj"],
                 s["background"], 40, 36, 1.0,
                 config_from_jax(dataclasses.asdict(JAX_CFG)), device="cpu")
    np.testing.assert_allclose(to_numpy(got[0]), np.asarray(want[0]), **OWN_RAYS_TOL)
    np.testing.assert_allclose(to_numpy(got[1]), np.asarray(want[1]), **OWN_RAYS_TOL)
    assert [int(x) for x in got[2]] == [int(x) for x in want[2]]


@pytest.mark.parametrize("origin,shape", [((0, 0), (H, W)), ((12, 16), (PH, PW))],
                         ids=["full_frame", "patch"])
def test_renderer_forward_equals_render_partial(origin, shape):
    """Renderer.forward and functional.render_partial run one render body:
    the same views and window give the same colour, depth and gradients of
    the four parameters, bit for bit, though the Renderer gathers its rays
    from precomputed full-frame maps and render_partial computes the
    window's."""
    s = scene_arrays(b=2, seed=4)
    cfg = config_from_jax(dataclasses.asdict(JAX_CFG))
    keys = ("verts", "verts_color", "faces_opacity", "faces_intense")
    order = MVP_IDX.tolist()
    outs = []
    for front in ("renderer", "functional"):
        p = {k: torch.as_tensor(s[k]).clone().requires_grad_(True) for k in keys}
        scene = (p["verts"], s["faces"], p["verts_color"], p["faces_opacity"],
                 p["faces_intense"], s["background"])
        if front == "renderer":
            renderer = Renderer(s["mv"], s["proj"], W, H, device="cpu", config=cfg)
            color, depth = renderer.forward(order, [list(origin)] * len(order),
                                            shape[1], shape[0], *scene)
        else:
            color, depth_raw, _, _ = render_partial(
                *scene[:5], s["mv"][order], s["proj"][order], s["background"], W, H,
                1.0, cfg, patch_origin=origin, patch_shape=shape, device="cpu")
            depth = 1.0 - (depth_raw + 1.0) / 2.0
        (color.sum() + depth.sum()).backward()
        outs.append([color, depth] + [p[k].grad for k in keys])
    assert outs[0][0].shape == (len(order), *shape, 3)
    for name, a, b in zip(("color", "depth") + keys, *outs):
        assert torch.equal(a, b), name
        assert torch.count_nonzero(a) > 0, name


def test_render_banded_matches_full_frame_and_jax():
    """Bands stitch to the port's own full-frame render (within the 5e-6
    that tests/test_api.py allows the JAX package) and match the JAX
    render_banded (each package's own rays: OWN_RAYS_TOL); the aux takes the
    per-band maxima and the summed truncation. A height that does not
    divide into the bands raises."""
    s = scene_arrays(b=2, seed=5)
    args = [s[k] for k in RENDER_KEYS[:5]] + [s["mv"], s["proj"], s["background"]]
    cfg = config_from_jax(dataclasses.asdict(JAX_CFG))
    full = render(*args, 40, 48, 1.0, cfg, device="cpu")
    band = render_banded(*args, 40, 48, 4, 1.0, cfg, device="cpu")
    want = jax_render_banded(*[jnp.asarray(x) for x in args], 40, 48, bands=4,
                             aa_temperature=1.0, config=JAX_CFG)
    for got, ref, tol in ((band[0], full[0], 5e-6), (band[1], full[1], 5e-6),
                          (band[0], want[0], OWN_RAYS_TOL["atol"]),
                          (band[1], want[1], OWN_RAYS_TOL["atol"])):
        assert tuple(got.shape) == tuple(np.shape(ref))
        np.testing.assert_allclose(to_numpy(got), to_numpy(ref), atol=tol)
    assert [int(x) for x in band[2]] == [int(x) for x in want[2]]
    assert int(band[2].num_truncated) == 0
    assert 0 < int(band[2].num_rendered) < int(full[2].num_rendered)
    with pytest.raises(ValueError, match="bands"):
        render_banded(*args, 40, 47, 4, config=cfg, device="cpu")


def test_reference_path_matches_kernel_path():
    """use_pallas=False (the plain reference compositor, no binning) renders
    the same image as the binned tile compositor."""
    s = scene_arrays(b=2, seed=4)
    args = [s[k] for k in RENDER_KEYS[:5]] + [s["mv"], s["proj"], s["background"],
                                             40, 36, 1.0]
    tiles = render(*args, RasterConfig(binning_capacity=2048), device="cpu")
    ref = render(*args, RasterConfig(use_pallas=False), device="cpu")
    np.testing.assert_allclose(to_numpy(ref[0]), to_numpy(tiles[0]), atol=2e-5)
    np.testing.assert_allclose(to_numpy(ref[1]), to_numpy(tiles[1]), atol=2e-5)
    assert [int(x) for x in ref[2]] == [0, 0, 0]


def test_config_carries_across_with_validation():
    jcfg = JaxConfig(binning_capacity=4096, max_tiles_per_face=12,
                     num_giant_faces=7, giant_tiles=40, exact_tile_cull=True,
                     fwd_subchunks=2, grad_compact_capacity=1 << 21,
                     vertex_sort_mode="static", prep_mode="fused")
    assert dataclasses.asdict(config_from_jax(dataclasses.asdict(jcfg))) == \
        dataclasses.asdict(jcfg)
    for bad in (dict(fwd_subchunks=3), dict(prep_mode="x"),
                dict(grad_sort_split=30), dict(vertex_sort_mode="y")):
        with pytest.raises(ValueError):
            JaxConfig(**bad)
        with pytest.raises(ValueError):
            RasterConfig(**bad)


def test_renderer_overflow_warns():
    s = scene_arrays(b=1)
    r = Renderer(s["mv"], s["proj"], 32, 32, device="cpu",
                 config=RasterConfig(max_tiles_per_face=1, num_giant_faces=0))
    with pytest.warns(RuntimeWarning, match="truncated"):
        r.forward([0], [[0, 0]], 32, 32, *[s[k] for k in RENDER_KEYS[:4]],
                  s["faces_intense"][:1], s["background"])
    assert int(r.last_aux.num_truncated) > 0


def test_static_mode_skips_the_valence_guard_as_jax_does():
    """icosphere(1) has vertices of valence 6. With max_vertex_valence=4 and
    vertex_sort_mode="static" both packages render (their valence-table and
    index_add_ reductions have no cap), through functional.render and
    Renderer.forward, and the images agree; in "sort" mode both raise. The
    vertex-index check still runs in static mode."""
    s = scene_arrays(b=2, seed=6)
    assert np.bincount(s["faces"].ravel()).max() == 6
    jcfg = JaxConfig(binning_capacity=2048, interpret=True, max_vertex_valence=4,
                     vertex_sort_mode="static")
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    args = [s[k] for k in RENDER_KEYS[:5]] + [s["mv"], s["proj"], s["background"],
                                             32, 32, 1.0]
    want = jax_render(*[jnp.asarray(x) for x in args[:8]], *args[8:], jcfg)
    got = render(*args, cfg, device="cpu")
    np.testing.assert_allclose(to_numpy(got[0]), np.asarray(want[0]), **OWN_RAYS_TOL)
    np.testing.assert_allclose(to_numpy(got[1]), np.asarray(want[1]), **OWN_RAYS_TOL)
    assert [int(x) for x in got[2]] == [int(x) for x in want[2]]

    jr = JaxRenderer(s["mv"], s["proj"], 32, 32, config=jcfg)
    want_c, want_d = jr.forward([0, 1], [[0, 0], [0, 0]], 32, 32,
                                *[jnp.asarray(s[k]) for k in RENDER_KEYS])
    r = Renderer(s["mv"], s["proj"], 32, 32, device="cpu", config=cfg)
    r.ray_o, r.ray_d = torch.as_tensor(np.array(jr.ray_o)), torch.as_tensor(np.array(jr.ray_d))
    color, depth = r.forward([0, 1], [[0, 0], [0, 0]], 32, 32,
                             *[s[k] for k in RENDER_KEYS])
    np.testing.assert_allclose(to_numpy(color), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(to_numpy(depth), np.asarray(want_d), **TOL)
    np.testing.assert_allclose(to_numpy(color), to_numpy(got[0]), **OWN_RAYS_TOL)

    sort_cfg = dataclasses.replace(cfg, vertex_sort_mode="sort")
    with pytest.raises(ValueError, match="max_vertex_valence=4"):
        render(*args, sort_cfg, device="cpu")
    with pytest.raises(ValueError, match="max_vertex_valence=4"):
        jax_render(*[jnp.asarray(x) for x in args[:8]], *args[8:],
                   dataclasses.replace(jcfg, vertex_sort_mode="sort"))
    bad_faces = s["faces"].copy()
    bad_faces[0, 0] = len(s["verts"])
    with pytest.raises(ValueError, match="outside"):
        render(args[0], bad_faces, *args[2:], cfg, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        r.forward([0, 1], [[0, 0], [0, 0]], 32, 32, s["verts"], bad_faces,
                  *[s[k] for k in RENDER_KEYS[2:]])


def test_renderer_rejects_bad_indices():
    """Face vertex ids, camera ids and patch windows are checked before any
    kernel reads through them."""
    s = scene_arrays(b=1)
    r = Renderer(s["mv"], s["proj"], 32, 32, device="cpu")
    args = [s[k] for k in RENDER_KEYS[:4]] + [s["faces_intense"][:1], s["background"]]
    bad_faces = s["faces"].copy()
    bad_faces[3, 1] = len(s["verts"])
    with pytest.raises(ValueError, match="outside"):
        r.forward([0], [[0, 0]], 32, 32, args[0], bad_faces, *args[2:])
    with pytest.raises(ValueError, match="cameras"):
        r.forward([1], [[0, 0]], 32, 32, *args)
    with pytest.raises(ValueError, match="leave"):
        r.forward([0], [[8, 0]], 32, 32, *args)


def test_without_cuda_the_default_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = scene_arrays(b=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer(s["mv"], s["proj"], 32, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render(*[s[k] for k in RENDER_KEYS[:4]], s["faces_intense"][:1],
               s["mv"], s["proj"], s["background"], 32, 32)


def test_kernel_wrappers_take_plain_versions_only_on_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    not sent to a plain version; a CPU tensor takes the plain version."""
    from dmesh2_renderer_tpu_torch.ops.binning import pack_stream
    from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
        composite_backward, composite_backward_plain)
    from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward
    from dmesh2_renderer_tpu_torch.ops.peel import peel_layers, peel_layers_plain

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def bwd_args(make):
        i32 = dict(dtype=torch.int32)
        return (make(128, 32), make(4, **i32), make(4, **i32), make(4, **i32),
                make(1, 3), make(1, 32, 32, 3), make(3), make(1, 2, **i32),
                make(1, 32, 32, 3), make(1, 32, 32), make(1, 32, 32),
                make(1, 32, 32), make(1, 32, 32, 3), make(1, 32, 32),
                make(1, 32, 32), 32, 32, 1.0)

    with pytest.raises(ValueError, match="CUDA"):
        composite_backward(*bwd_args(meta))

    def cpu(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    args = bwd_args(cpu)
    assert torch.equal(composite_backward(*args), composite_backward_plain(*args))

    with pytest.raises(ValueError, match="CUDA"):
        composite_forward(meta(128, 32), meta(4, dtype=torch.int32),
                          meta(4, dtype=torch.int32), meta(1, 3), meta(1, 32, 32, 3),
                          meta(3), meta(1, 2, dtype=torch.int32), 32, 32, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        pack_stream(meta(128, dtype=torch.int32), meta(4, 3, dtype=torch.int32),
                    meta(6, 3), meta(6, 3), meta(1, 6, 3), meta(4), meta(1, 4),
                    meta(1, 4, 3, 2))

    def peel_args(make):
        i32 = dict(dtype=torch.int32)
        return (make(128, **i32), make(4, 3, **i32), make(6, 3), make(4, **i32),
                make(4, **i32), make(4, **i32), make(1, 3), make(1, 32, 32, 3),
                32, 32, 3)

    with pytest.raises(ValueError, match="CUDA"):
        peel_layers(*peel_args(meta))
    args = peel_args(cpu)
    assert all(torch.equal(a, b) for a, b in zip(peel_layers(*args),
                                                 peel_layers_plain(*args)))


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor the JAX
    package."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import dmesh2_renderer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'dmesh2_renderer_tpu' or m.startswith('dmesh2_renderer_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14
