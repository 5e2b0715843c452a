"""The port's pixel parallelism and the 2-D view x band grid
(parallel/patch_parallel.py, the Trainer's grid route) vs one process and
vs the JAX package's on the virtual CPU mesh (tests/test_patch_parallel.py's
semantics).

The two-rank cases run tests/_torch_dist_worker.py's ``patch`` scenario as
two gloo processes on the CPU, once per module, each joined with a timeout
of its own, their rendezvous a file under the test's temporary directory.
The JAX side runs in this process, Pallas in interpret mode. The scene is
16x16 in 2 bands of 8 rows: band 1's origin y0 = 8 is not tile-aligned.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from dmesh2_renderer_tpu.parallel import patch_parallel as JP
from dmesh2_renderer_tpu.parallel.data_parallel import SceneParams as JaxParams
from dmesh2_renderer_tpu.utils.config import RasterConfig as JaxConfig
from dmesh2_renderer_tpu_torch import RasterConfig, render, render_partial
from dmesh2_renderer_tpu_torch.parallel import (
    RankMesh, SceneParams, make_grid_train_step, make_mesh, make_pixel_mesh,
    make_sharded_train_step, make_view_mesh, render_pixels_sharded)
from dmesh2_renderer_tpu_torch.parallel import patch_parallel as PP
from tests import _torch_dist_worker as W

WORLD = 2
VERTS_TOL, TOL = 5e-4, 2e-5        # tests/test_torch_parallel.py
JAX_IMAGE_TOL = 1e-4               # the ray departure tests/test_torch_renderer allows
NAMES = ("verts", "verts_color", "faces_opacity")
ARGS = ("verts", "faces", "verts_color", "faces_opacity", "faces_intense", "mv",
        "proj", "background")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two gloo ranks of the patch scenario once."""
    return W.run_ranks(tmp_path_factory.mktemp("patch_ranks"), "patch", WORLD)


def _cfg():
    return RasterConfig(**W.CONFIG)


def _args(s):
    return [s[k] for k in ARGS]


def _leaves(s):
    return SceneParams(*(torch.tensor(s[k], requires_grad=True) for k in NAMES))


@functools.lru_cache(maxsize=1)
def _jax_pixels():
    """The JAX render_pixels_sharded on a 2-device ("sp",) mesh."""
    j = {k: jnp.asarray(v) for k, v in W.scene().items()}
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    color, depth, stats = JP.render_pixels_sharded(
        mesh, *[j[k] for k in ARGS], W.HW, W.HW, 1.0, JaxConfig(**W.CONFIG))
    return np.asarray(color), np.asarray(depth), [int(x) for x in stats]


@functools.lru_cache(maxsize=2)
def _jax_grid_step(shape):
    """One JAX make_grid_train_step SGD step (lr 1) on a ("dp", "sp") mesh
    of ``shape``: (loss, parameters after, stats)."""
    j = {k: jnp.asarray(v) for k, v in W.scene().items()}
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("dp", "sp"))
    params = JaxParams(j["verts"], j["verts_color"], j["faces_opacity"])
    opt = optax.sgd(W.SGD_LR)
    step = JP.make_grid_train_step(mesh, opt, j["faces"], W.HW, W.HW, 1.0,
                                   JaxConfig(**W.CONFIG))
    after, _, loss, stats = step(params, opt.init(params), j["faces_intense"],
                                 j["mv"], j["proj"], j["target"], j["background"])
    return float(loss), [np.asarray(p) for p in after], [int(x) for x in stats]


def _assert_sgd_matches_jax(loss, params_after, jax_result):
    """Loss within 2e-5; parameters after SGD(lr=1) within 5e-4 (verts) and
    2e-5 (the rest) times the scale of the JAX update."""
    jax_loss, jax_params, _ = jax_result
    s = W.scene()
    assert abs(loss - jax_loss) < TOL
    for i, (name, tol) in enumerate(zip(NAMES, (VERTS_TOL, TOL, TOL))):
        scale = max(float(np.abs(s[name] - jax_params[i]).max()), 1.0)
        np.testing.assert_allclose(params_after[i], jax_params[i], atol=tol * scale,
                                   err_msg=name)
        assert np.abs(s[name] - jax_params[i]).max() > 1e-4


def test_meshes_lay_ranks_out_row_major():
    """make_pixel_mesh and make_mesh on a world of one; a (2, 2) mesh's
    ranks take coordinates row-major, as the JAX Mesh(devices.reshape(2, 2))
    does; a shape that needs more ranks than the world raises."""
    mesh = make_pixel_mesh(device="cpu")
    assert (mesh.axis_names, mesh.shape, mesh.coord("sp")) == (("sp",), (1,), 0)
    grid = make_mesh((1, 1), ("dp", "sp"), device="cpu")
    assert (grid.axis_names, grid.shape, grid.world_size) == (("dp", "sp"), (1, 1), 1)
    coords = [(m.coord("dp"), m.coord("sp"))
              for m in (RankMesh(None, r, 4, torch.device("cpu"), ("dp", "sp"), (2, 2))
                        for r in range(4))]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    m = RankMesh(None, 2, 4, torch.device("cpu"), ("dp", "sp"), (2, 2))
    assert m.axis_ranks("sp") == [2, 3] and m.axis_ranks("dp") == [0, 2]
    assert m.shard(4, "dp") == slice(2, 4)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((1, 2), ("dp", "sp"), device="cpu")
    with pytest.raises(ValueError, match="n_devices=2"):
        make_pixel_mesh(2, device="cpu")


def test_world_of_one_equals_functional_render():
    s = W.scene()
    color, depth, stats = render_pixels_sharded(
        make_pixel_mesh(device="cpu"), *_args(s), W.HW, W.HW, 1.0, _cfg())
    ref_c, ref_d, aux = render(*_args(s), W.HW, W.HW, 1.0, _cfg(), device="cpu")
    assert torch.equal(color, ref_c) and torch.equal(depth, ref_d)
    assert [int(x) for x in stats] == [0, int(aux.num_grad_contributing),
                                       int(aux.num_rendered)]


def test_two_ranks_render_as_one_process(ranks):
    """Both ranks hold the stitched frame, within 1e-6 of the port's render
    (band compositing is per pixel); the stats are max-reduced."""
    s = W.scene()
    ref_c, ref_d, aux = render(*_args(s), W.HW, W.HW, 1.0, _cfg(), device="cpu")
    r0, r1 = ranks
    for key in ("color", "depth", "stats"):
        np.testing.assert_array_equal(r0[key], r1[key])
    np.testing.assert_allclose(r0["color"], ref_c.numpy(), atol=1e-6)
    np.testing.assert_allclose(r0["depth"], ref_d.numpy(), atol=1e-6)
    assert r0["stats"][0] == 0
    assert 0 < r0["stats"][1] <= int(aux.num_grad_contributing)


def test_two_ranks_render_matches_jax(ranks):
    color, depth, stats = _jax_pixels()
    np.testing.assert_allclose(ranks[0]["color"], color, atol=JAX_IMAGE_TOL)
    np.testing.assert_allclose(ranks[0]["depth"], depth, atol=JAX_IMAGE_TOL)
    # The JAX stats; the port adds num_rendered.
    assert ranks[0]["stats"].tolist()[:2] == stats


def test_two_ranks_grid_step_matches_jax(ranks):
    """One SGD step (lr 1) on a (1, 2) ("dp", "sp") mesh of two ranks: the
    loss and parameters of the JAX make_grid_train_step on 2 devices; both
    ranks apply the same update; the stats equal JAX's."""
    r0, r1 = ranks
    for i in range(3):
        np.testing.assert_array_equal(r0[f"grid_param_{i}"], r1[f"grid_param_{i}"])
    result = _jax_grid_step((1, WORLD))
    _assert_sgd_matches_jax(float(r0["grid_loss"]),
                            [r0[f"grid_param_{i}"] for i in range(3)], result)
    assert r0["grid_stats"].tolist()[:2] == result[2]


def test_pure_pixel_mesh_step(ranks):
    """The 1-D ("sp",) mesh replicates the views: with one view shard it is
    the (1, 2) grid step, bit for bit, and its values are finite."""
    r0 = ranks[0]
    assert np.isfinite(float(r0["sp_loss"]))
    assert float(r0["sp_loss"]) == float(r0["grid_loss"])
    for i in range(3):
        assert np.isfinite(r0[f"sp_param_{i}"]).all()
        np.testing.assert_array_equal(r0[f"sp_param_{i}"], r0[f"grid_param_{i}"])


def test_one_process_2x2_grid_matches_jax_2x2_mesh():
    """The four (view half, band) bodies of a (2, 2) grid run in one
    process, their losses and gradients averaged as the collectives would:
    the JAX make_grid_train_step on a (2, 2) mesh of 4 devices, and the
    port's view-parallel step on a world of one (loss within 1e-5 relative,
    gradients within 1e-6 x max(|g|, 1))."""
    s = W.scene()
    cfg = _cfg()
    faces = torch.as_tensor(s["faces"])
    fi, mv, proj, tgt, bg = (torch.as_tensor(s[k]) for k in (
        "faces_intense", "mv", "proj", "target", "background"))
    band = W.HW // 2
    params = _leaves(s)
    grads = [torch.zeros_like(p) for p in params]
    losses = []
    for i in range(2):
        v = slice(2 * i, 2 * i + 2)
        for k in range(2):
            loss, _ = PP.band_loss(params, faces, fi[v], mv[v], proj[v],
                                   tgt[v, k * band:(k + 1) * band], bg, W.HW, W.HW,
                                   1.0, cfg, k, 2)
            for g, d in zip(grads, torch.autograd.grad(loss, list(params))):
                g += d
            losses.append(float(loss.detach()))
    loss = sum(losses) / 4
    grads = [g / 4 for g in grads]
    after = [(p - W.SGD_LR * g).detach().numpy() for p, g in zip(params, grads)]
    _assert_sgd_matches_jax(loss, after, _jax_grid_step((2, 2)))

    step = make_sharded_train_step(make_view_mesh(device="cpu"),
                                   functools.partial(torch.optim.SGD, lr=0.0),
                                   s["faces"], W.HW, W.HW, 1.0, cfg)
    ref = _leaves(s)
    _, _, ref_loss, _ = step(ref, step.init(ref), *(s[k] for k in (
        "faces_intense", "mv", "proj", "target", "background")))
    assert loss == pytest.approx(float(ref_loss), rel=1e-5)
    for name, g, p in zip(NAMES, grads, ref):
        scale = max(float(p.grad.abs().max()), 1.0)
        np.testing.assert_allclose(g.numpy(), p.grad.numpy(), atol=1e-6 * scale,
                                   err_msg=name)


def test_grid_step_world_of_one_is_the_view_step():
    """A (1, 1) grid is one band of all views: the view-parallel step, bit
    for bit, with and without the depth term."""
    s = W.scene()
    opt = functools.partial(torch.optim.SGD, lr=1.0)
    batch = [s[k] for k in ("faces_intense", "mv", "proj", "target", "background")]
    for depth_weight in (0.0, 0.5):
        got, want = _leaves(s), _leaves(s)
        grid = make_grid_train_step(make_mesh((1, 1), ("dp", "sp"), device="cpu"),
                                    opt, s["faces"], W.HW, W.HW, 1.0, _cfg(),
                                    depth_weight=depth_weight)
        view = make_sharded_train_step(make_view_mesh(device="cpu"), opt, s["faces"],
                                       W.HW, W.HW, 1.0, _cfg(),
                                       depth_weight=depth_weight)
        a = grid(got, grid.init(got), *batch)
        b = view(want, view.init(want), *batch)
        assert float(a[2]) == float(b[2])
        assert [int(x) for x in a[3]] == [int(x) for x in b[3]]
        assert all(torch.equal(p, q) for p, q in zip(got, want))


def test_two_ranks_grid_trainer_trains_and_resumes(ranks):
    """Adam through the Trainer on a (1, 2) grid of two ranks: the loss
    falls, both ranks hold the same parameters, and a trainer resumed from
    rank 0's checkpoint continues bit for bit as the first."""
    r0, r1 = ranks
    losses = r0["adam_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    np.testing.assert_array_equal(losses, r1["adam_losses"])
    for i in range(3):
        np.testing.assert_array_equal(r0[f"adam_param_{i}"], r1[f"adam_param_{i}"])
    assert bool(r0["resume_exact"]) and bool(r1["resume_exact"])


def test_bands_and_mesh_axes_errors():
    """A height the bands do not divide raises ("bands"), in the render and
    in the grid step; a mesh without the pixel axis raises the JAX error;
    render_partial's window arguments must come together."""
    s = W.scene()
    four = RankMesh(None, 0, 4, torch.device("cpu"), ("sp",))
    with pytest.raises(ValueError, match="bands"):
        render_pixels_sharded(four, *_args(s), 32, 30, 1.0, _cfg())
    with pytest.raises(ValueError, match="bands"):
        make_grid_train_step(four, torch.optim.SGD, s["faces"], 32, 30)
    with pytest.raises(ValueError, match="lack pixel axis 'sp'"):
        make_grid_train_step(make_view_mesh(device="cpu"), torch.optim.SGD,
                             s["faces"], W.HW, W.HW)
    with pytest.raises(ValueError, match="together"):
        render_partial(*_args(s), W.HW, W.HW, 1.0, _cfg(), patch_origin=(0, 8),
                       device="cpu")
    with pytest.raises(ValueError, match="'fp' is not an axis"):
        render_pixels_sharded(four, *_args(s), W.HW, W.HW, 1.0, _cfg(), axis="fp")


def test_bands_quantize_depth_for_their_own_tiles_as_in_jax():
    """Two overlapping triangles 1e-4 apart in depth on a 1024x1024 frame
    in 2 bands: the frame's 4,096 tiles leave the binning's key 18 depth
    bits, where the two tie (one render composites them in id order, the
    farther face 0 first); a band's 2,048 tiles leave 19, where they do
    not. A band is the plain render_partial window, as in the JAX package,
    so at this tie the stitched bands depart from the render (ROADMAP.md
    section 3)."""
    from dmesh2_renderer_tpu_torch import geometry as G
    from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
    from dmesh2_renderer_tpu_torch.utils.meshes import look_at, perspective

    hw = 1024
    tri = np.array([[-0.5, -0.5, 0.016], [0.5, -0.5, 0.016], [0.0, 0.5, 0.016]],
                   np.float32)
    verts = np.concatenate([tri - [0, 0, 1e-4], tri]).astype(np.float32)
    args = [torch.as_tensor(x) for x in (
        verts, np.arange(6, dtype=np.int32).reshape(2, 3),
        np.array([[1, 0, 0]] * 3 + [[0, 0, 1]] * 3, np.float32),
        np.array([0.6, 0.6], np.float32), np.ones((1, 2), np.float32),
        look_at((0.0, 0.0, 3.0), (0.0, 0.0, 0.0))[None], perspective(45.0, 1.0)[None],
        np.zeros(3, np.float32))]
    cfg = RasterConfig(binning_capacity=1 << 14)
    ndc, _ = G.compute_verts_ndc_image(args[0], args[5], args[6], hw, hw)
    depth01 = face_depth01(ndc, args[1])[0][0]
    frame_dq, band_dq = ((depth01 * float((1 << bits) - 1)).to(torch.int32).tolist()
                         for bits in (18, 19))
    assert frame_dq[0] == frame_dq[1] and band_dq[0] > band_dq[1]
    ref_c, _, _ = render(*args, hw, hw, 1.0, cfg, device="cpu")
    with torch.no_grad():
        bands = [PP.render_band(*args, hw, hw, 1.0, cfg, k, 2, device="cpu")
                 for k in range(2)]
        plain = render_partial(*args, hw, hw, 1.0, cfg, patch_origin=(0, 0),
                               patch_shape=(hw // 2, hw), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(bands[0][:3], plain[:3]))
    stitched = torch.cat([b[0] for b in bands], dim=1)
    centre, got = ref_c[0, hw // 2, hw // 2], stitched[0, hw // 2, hw // 2]
    assert float(centre[0]) > float(centre[2]) > 0     # the render: red over blue
    assert float(got[2]) > float(got[0]) > 0           # the bands: blue over red


def test_bands_depart_from_render_at_a_giant_tier_tie_as_in_jax():
    """The witness that the JAX package's own bands depart from its render
    at a depth tie (ROADMAP.md section 3): in tests/_torch_dist_worker.py's
    tie scene one render composites face 1 over face 0 in the lower tile,
    where face 0 is in the giant tier (the regular tier goes first); band 1
    tiles face 0 from its own origin, where that tile is its first, regular
    one, so the band composites face 0 first (id order). The JAX
    render_pixels_sharded on 2 devices departs from the JAX render by more
    than 0.3 there; the port's two bands stitch to the JAX result within
    1e-4 and depart from the port's render on the same pixels."""
    from dmesh2_renderer_tpu import functional as JFn

    s = W.tie_scene()
    w, h = W.TIE_FRAME
    j = [jnp.asarray(s[k]) for k in ARGS]
    jcfg = JaxConfig(**W.TIE_CONFIG)
    jax_render = np.asarray(JFn.render(*j, w, h, 1.0, jcfg)[0])
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    jax_bands = np.asarray(JP.render_pixels_sharded(mesh, *j, w, h, 1.0, jcfg)[0])
    jax_moved = np.abs(jax_bands - jax_render).max(axis=-1) > 0.3
    assert 0 < jax_moved.sum() < jax_moved.size

    cfg = RasterConfig(**W.TIE_CONFIG)
    args = [torch.as_tensor(s[k]) for k in ARGS]
    ref_c, _, _ = render(*args, w, h, 1.0, cfg, device="cpu")
    with torch.no_grad():
        color = torch.cat([PP.render_band(*args, w, h, 1.0, cfg, k, WORLD,
                                          device="cpu")[0] for k in range(WORLD)], dim=1)
    np.testing.assert_allclose(ref_c.numpy(), jax_render, atol=JAX_IMAGE_TOL)
    np.testing.assert_allclose(color.numpy(), jax_bands, atol=JAX_IMAGE_TOL)
    moved = (color - ref_c).abs().amax(dim=-1).numpy() > 0.3
    np.testing.assert_array_equal(moved, jax_moved)
