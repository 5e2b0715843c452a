"""The port's profile_render (utils/profiling.py) on the scene of
tests/test_profiling.py: the JAX package's keys, every stage timed, and the
binning counters equal to the JAX package's for the same scene and config
(times are not compared: they are the host's here). The counters are held
at tau = 0: at tau > 0 a sub-resolution AA blend may add a contributing
entry on one side only (the known departure of tests/test_torch_composite.py:
XLA contracts multiply-adds into FMAs, the port rounds every operation)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from dmesh2_renderer_tpu.functional import render as jax_render
from dmesh2_renderer_tpu.ops.binning import bin_faces as jax_bin_faces
from dmesh2_renderer_tpu import geometry as JG
from dmesh2_renderer_tpu.ops.reference import face_depth01 as jax_face_depth01
from dmesh2_renderer_tpu.utils.config import RasterConfig as JaxConfig
from dmesh2_renderer_tpu.utils.meshes import icosphere, orbit_cameras
from dmesh2_renderer_tpu_torch.convert import config_from_jax
from dmesh2_renderer_tpu_torch.utils.profiling import profile_render, time_fn

JAX_CFG = JaxConfig(binning_capacity=1 << 12, max_tiles_per_face=16, interpret=True)
STAGES = {"prep", "binning", "pack", "fwd_kernel", "bwd_kernel", "scatter"}


def _scene():
    verts, faces = icosphere(1)
    f = faces.shape[0]
    mv, proj = orbit_cameras(1, radius=3.0)
    return (verts, faces, np.abs(verts) % 1.0, np.full((f,), 0.7, np.float32),
            np.ones((1, f), np.float32), mv, proj, np.zeros(3, np.float32))


def _jax_counters(args, hw, tau):
    """num_rendered, num_truncated, num_binned and num_contributing of the
    JAX package for this scene (its render and its binning)."""
    j = [jnp.asarray(x) for x in args]
    _, _, aux = jax_render(*j, hw, hw, tau, JAX_CFG)
    verts, faces, mv, proj = j[0], j[1], j[5], j[6]
    vndc, vimg = JG.compute_verts_ndc_image(verts, mv, proj, hw, hw)
    aa = JG.face_aa_verts_ccw(vimg, faces)
    depth01, _, _, alive = jax_face_depth01(vndc, faces)
    binning = jax_bin_faces(aa, depth01, alive, jnp.zeros((1, 2), jnp.int32), hw, hw,
                            JAX_CFG.binning_capacity, JAX_CFG.max_tiles_per_face,
                            num_giant_faces=JAX_CFG.num_giant_faces,
                            giant_tiles=JAX_CFG.giant_tiles,
                            exact_tile_cull=JAX_CFG.exact_tile_cull)
    return dict(num_rendered=int(aux.num_rendered), num_truncated=int(aux.num_truncated),
                num_binned=int(jnp.sum(binning.tile_counts)),
                num_contributing=int(aux.num_grad_contributing))


@pytest.mark.parametrize("hw", [64, 40])
def test_profile_render_reports_all_stages_and_jax_counters(hw):
    args = _scene()
    report = profile_render(*args, hw, hw, 0.0,
                            config_from_jax(dataclasses.asdict(JAX_CFG)), iters=1,
                            device="cpu")
    assert set(report) == {"stages_ms", "e2e_fwd_ms", "e2e_ms", "unattributed_ms",
                           "num_rendered", "num_truncated", "num_binned",
                           "num_contributing"}
    assert set(report["stages_ms"]) == STAGES
    assert all(np.isfinite(v) and v >= 0 for v in report["stages_ms"].values())
    assert report["e2e_ms"] > 0 and report["e2e_fwd_ms"] > 0
    assert np.isfinite(report["unattributed_ms"])
    want = _jax_counters(args, hw, 0.0)
    assert {k: report[k] for k in want} == want
    assert want["num_rendered"] > 0 and want["num_truncated"] == 0
    assert 0 < want["num_contributing"] <= want["num_binned"]


def test_time_fn_returns_the_output_and_milliseconds():
    calls = []
    out, ms = time_fn(lambda x: calls.append(x) or x * 2, 3, iters=4)
    assert out == 6 and len(calls) == 5 and ms >= 0
