"""The port's suggest_config / scene_binning_stats (utils/autotune.py) vs
the JAX package's, on the scenes of tests/test_autotune.py: the same stats
and the same config, and a render with the suggested config truncates
nothing in the port (in vertex_sort_mode="static", whose valence guard the
port skips as the JAX package does)."""

import dataclasses

import numpy as np
import pytest
import torch

import dmesh2_renderer_tpu_torch as port
from dmesh2_renderer_tpu.utils import autotune as JA
from dmesh2_renderer_tpu.utils.config import RasterConfig as JaxConfig
from dmesh2_renderer_tpu.utils.meshes import icosphere, orbit_cameras
from dmesh2_renderer_tpu_torch.utils import autotune as TA
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig


def _scene(b=2, giant=False):
    """tests/test_autotune.py::_scene."""
    verts_np, faces_np = icosphere(1)
    if giant:
        verts_np = np.concatenate([
            verts_np,
            np.array([[0.0, -9.0, -9.0], [0.0, 9.0, -9.0], [0.0, 0.0, 12.0]],
                     np.float32),
        ])
        p = verts_np.shape[0]
        faces_np = np.concatenate(
            [faces_np, np.array([[p - 3, p - 2, p - 1]], np.int32)])
    mv, proj = orbit_cameras(b)
    return verts_np, faces_np, mv, proj


@pytest.mark.parametrize("giant", [False, True])
def test_stats_match_jax(giant):
    verts, faces, mv, proj = _scene(giant=giant)
    want = JA.scene_binning_stats(verts, faces, mv, proj, 128, 128)
    got = TA.scene_binning_stats(verts, faces, mv, proj, 128, 128, device="cpu")
    assert got["total_emissions"] == want["total_emissions"] > 0
    assert got["max_tiles"] == want["max_tiles"]
    assert got["grid"] == want["grid"]
    np.testing.assert_array_equal(got["tiles_hist"], want["tiles_hist"])
    assert got["tiles_hist"].shape == (mv.shape[0] * faces.shape[0],)


@pytest.mark.parametrize("giant", [False, True])
def test_suggested_config_matches_jax_and_renders_without_truncation(giant):
    """Every field equals the JAX package's config for the same scene and
    base; the port's render with it truncates nothing and is finite."""
    verts, faces, mv, proj = _scene(giant=giant)
    cfg = TA.suggest_config(verts, faces, mv, proj, 128, 128,
                            base=RasterConfig(interpret=True), device="cpu")
    want = JA.suggest_config(verts, faces, mv, proj, 128, 128,
                             base=JaxConfig(interpret=True))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.interpret and cfg.vertex_sort_mode == "static"
    if giant:
        assert cfg.num_giant_faces >= 16
    f = faces.shape[0]
    color, _, aux = port.render(
        verts, faces, np.abs(verts)[:, :3] % 1.0, np.full((f,), 0.7, np.float32),
        np.ones((mv.shape[0], f), np.float32), mv, proj, np.zeros(3, np.float32),
        128, 128, 1.0, cfg, device="cpu")
    assert int(aux.num_truncated) == 0
    assert bool(torch.isfinite(color).all())
    assert cfg.binning_capacity <= 4 * max(int(aux.num_rendered), 1024)


def test_suggest_config_is_exported_and_honours_base():
    """Exported from the package as in the JAX package; an explicit base
    mode wins, an empty scene gets the 1024-entry floor."""
    assert port.suggest_config is TA.suggest_config and "suggest_config" in port.__all__
    verts, faces = icosphere(1)
    mv, proj = orbit_cameras(1)
    cfg = port.suggest_config(verts, faces, mv, proj, 64, 64, device="cpu")
    assert cfg.vertex_sort_mode == "static"
    far = verts + np.float32(100.0)      # every face behind or off the frame
    for mod, base in ((TA, RasterConfig(vertex_sort_mode="static")),
                      (JA, JaxConfig(vertex_sort_mode="static"))):
        kw = {"device": "cpu"} if mod is TA else {}
        out = mod.suggest_config(far, faces, mv, proj, 64, 64, base=base, **kw)
        assert out.binning_capacity == 1024 and out.vertex_sort_mode == "static"
