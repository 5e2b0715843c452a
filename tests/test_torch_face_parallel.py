"""The port's face-list parallelism (parallel/face_parallel.py) vs one
process and vs the JAX package's on a 2-device CPU mesh
(tests/test_face_parallel.py's semantics).

The two-rank cases run tests/_torch_dist_worker.py's ``face`` scenario as
two gloo processes on the CPU, once per module, each joined with a timeout
of its own, their rendezvous a file under the test's temporary directory.
The JAX side runs in this process, Pallas in interpret mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dmesh2_renderer_tpu.parallel import face_parallel as JF
from dmesh2_renderer_tpu.parallel.data_parallel import SceneParams as JaxParams
from dmesh2_renderer_tpu.utils.config import RasterConfig as JaxConfig
from dmesh2_renderer_tpu_torch import RasterConfig, render
from dmesh2_renderer_tpu_torch.parallel import (
    SceneParams, make_face_mesh, make_face_sharded_train_step, render_faces_sharded)
from dmesh2_renderer_tpu_torch.parallel import face_parallel as FP
from tests import _torch_dist_worker as W

WORLD = 2
# tests/test_torch_parallel.py: verts gradients 5e-4, the rest 2e-5, times
# scale; images 1e-4 against JAX (the ray departure tests/test_torch_renderer
# allows), 2e-5 against the port's own render (tests/test_face_parallel.py).
VERTS_TOL, TOL = 5e-4, 2e-5
JAX_IMAGE_TOL, RENDER_TOL = 1e-4, 2e-5
NAMES = ("verts", "verts_color", "faces_opacity")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two gloo ranks of the face scenario once."""
    return W.run_ranks(tmp_path_factory.mktemp("face_ranks"), "face", WORLD)


def _args(s):
    return [s[k] for k in ("verts", "faces", "verts_color", "faces_opacity",
                           "faces_intense", "mv", "proj", "background")]


def _cfg():
    return RasterConfig(**W.CONFIG)


@functools.lru_cache(maxsize=1)
def _jax_face():
    """JAX render_faces_sharded and one face-sharded SGD step (lr 1) on a
    2-device face mesh."""
    s = W.scene()
    j = {k: jnp.asarray(v) for k, v in s.items()}
    cfg = JaxConfig(**W.CONFIG)
    mesh = JF.make_face_mesh(WORLD)
    color, depth, (nr, nt) = JF.render_faces_sharded(
        mesh, *[j[k] for k in ("verts", "faces", "verts_color", "faces_opacity",
                                "faces_intense", "mv", "proj", "background")],
        W.HW, W.HW, 1.0, cfg)
    params = JaxParams(j["verts"], j["verts_color"], j["faces_opacity"])
    opt = optax.sgd(W.SGD_LR)
    step = JF.make_face_sharded_train_step(mesh, opt, j["faces"], W.HW, W.HW, 1.0, cfg)
    after, _, loss = step(params, opt.init(params), j["faces_intense"], j["mv"],
                          j["proj"], j["target"], j["background"])
    return (np.asarray(color), np.asarray(depth), (int(nr), int(nt)), float(loss),
            [np.asarray(p) for p in after])


def _leaves(s):
    return SceneParams(*(torch.tensor(s[k], requires_grad=True) for k in NAMES))


def test_make_face_mesh_world_of_one():
    mesh = make_face_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.axis_names, mesh.shape) == \
        (0, 1, ("fp",), (1,))
    assert (mesh.coord("fp"), mesh.axis_size("fp")) == (0, 1)
    with pytest.raises(ValueError, match="n_devices=2"):
        make_face_mesh(2, device="cpu")


def test_world_of_one_equals_functional_render():
    """One slab holding every face in depth order: the render with the
    background folded in after the slab is functional.render."""
    s = W.scene()
    color, depth, (nr, nt) = render_faces_sharded(
        make_face_mesh(device="cpu"), *_args(s), W.HW, W.HW, 1.0, _cfg())
    ref_c, ref_d, aux = render(*_args(s), W.HW, W.HW, 1.0, _cfg(), device="cpu")
    np.testing.assert_allclose(color.numpy(), ref_c.numpy(), atol=RENDER_TOL)
    np.testing.assert_allclose(depth.numpy(), ref_d.numpy(), atol=RENDER_TOL)
    assert (int(nr), int(nt)) == (int(aux.num_rendered), 0)


def test_two_ranks_render_as_one_process(ranks):
    """Both ranks hold the whole combined frame, within 2e-5 of the port's
    own render; the slabs' counters sum to the one-process count."""
    s = W.scene()
    ref_c, ref_d, aux = render(*_args(s), W.HW, W.HW, 1.0, _cfg(), device="cpu")
    r0, r1 = ranks
    for key in ("color", "depth", "aux"):
        np.testing.assert_array_equal(r0[key], r1[key])
    np.testing.assert_allclose(r0["color"], ref_c.numpy(), atol=RENDER_TOL)
    np.testing.assert_allclose(r0["depth"], ref_d.numpy(), atol=RENDER_TOL)
    assert r0["aux"].tolist() == [int(aux.num_rendered), 0]


def test_two_ranks_render_matches_jax(ranks):
    """The JAX render_faces_sharded on a 2-device face mesh: colour and
    depth within 1e-4, the same counters."""
    color, depth, aux, _, _ = _jax_face()
    np.testing.assert_allclose(ranks[0]["color"], color, atol=JAX_IMAGE_TOL)
    np.testing.assert_allclose(ranks[0]["depth"], depth, atol=JAX_IMAGE_TOL)
    assert ranks[0]["aux"].tolist() == list(aux)


def test_two_ranks_sgd_step_matches_jax(ranks):
    """Loss and the parameters after one SGD step (lr 1, so the step is the
    summed gradient) equal the JAX make_face_sharded_train_step on a 2-device
    mesh: verts within 5e-4, the rest within 2e-5, times scale; both ranks
    apply the same update."""
    _, _, _, loss, params = _jax_face()
    s = W.scene()
    r0, r1 = ranks
    assert abs(float(r0["sgd_loss"]) - loss) < TOL
    assert float(r0["sgd_loss"]) == float(r1["sgd_loss"])
    for i, (name, tol) in enumerate(zip(NAMES, (VERTS_TOL, TOL, TOL))):
        np.testing.assert_array_equal(r0[f"sgd_param_{i}"], r1[f"sgd_param_{i}"])
        scale = max(float(np.abs(s[name] - params[i]).max()), 1.0)
        np.testing.assert_allclose(r0[f"sgd_param_{i}"], params[i], atol=tol * scale,
                                   err_msg=name)
        assert np.abs(r0[f"sgd_grad_{i}"]).max() > 1e-4


def test_two_ranks_sum_what_one_process_sums_over_its_slabs(ranks):
    """The per-rank bodies run for k = 0 and 1 in one process, each slab
    backpropagated with the combine's cotangents into the same leaves (whose
    .grad sums them), give the two ranks' summed gradients and loss."""
    s = W.scene()
    params = _leaves(s)
    faces = torch.as_tensor(s["faces"])
    fi, mv, proj, tgt, bg = (torch.as_tensor(s[k]) for k in (
        "faces_intense", "mv", "proj", "target", "background"))
    order = FP.depth_slab_order(params.verts, faces, mv, proj, W.HW, W.HW)
    parts = [FP.render_slab(params, faces, fi, mv, proj, order, W.HW, W.HW, 1.0,
                            _cfg(), k, WORLD) for k in range(WORLD)]
    stacked = [torch.stack([p[i].detach() for p in parts]) for i in range(3)]
    loss, g_c, g_t = FP.slab_cotangents(*stacked, tgt, bg)
    for k, (cn, _, t, _, _) in enumerate(parts):
        torch.autograd.backward([cn, t], [g_c[k], g_t[k]])
    assert float(loss) == pytest.approx(float(ranks[0]["sgd_loss"]), abs=1e-7)
    for i, p in enumerate(params):
        scale = max(float(p.grad.abs().max()), 1.0)
        np.testing.assert_allclose(ranks[0][f"sgd_grad_{i}"], p.grad.numpy(),
                                   atol=1e-6 * scale, err_msg=NAMES[i])


def test_world_of_one_step_is_autograd_of_the_unsharded_loss():
    """tests/test_face_parallel.py's bound: on one slab the step's gradients
    are autograd of the unsharded mean squared error within 5e-5 x scale +
    1e-7, and SGD(lr=1) moves each parameter by its gradient."""
    s = W.scene()
    want = _leaves(s)
    color, _, _ = render(want.verts, s["faces"], want.verts_color, want.faces_opacity,
                         s["faces_intense"], s["mv"], s["proj"], s["background"],
                         W.HW, W.HW, 1.0, _cfg(), device="cpu")
    ref_loss = torch.mean((color - torch.as_tensor(s["target"])) ** 2)
    ref_loss.backward()
    step = make_face_sharded_train_step(
        make_face_mesh(device="cpu"), functools.partial(torch.optim.SGD, lr=1.0),
        s["faces"], W.HW, W.HW, 1.0, _cfg())
    params = _leaves(s)
    _, _, loss = step(params, step.init(params), s["faces_intense"], s["mv"],
                      s["proj"], s["target"], s["background"])
    assert float(loss) == pytest.approx(float(ref_loss.detach()), rel=1e-6)
    for name, p, q in zip(NAMES, params, want):
        scale = max(float(q.grad.abs().max()), 1e-3)
        err = float((p.grad - q.grad).abs().max())
        assert err < 5e-5 * scale + 1e-7, f"{name}: {err:.3e} vs {scale:.3e}"
        np.testing.assert_allclose(p.detach().numpy(), s[name] - p.grad.numpy(),
                                   atol=1e-6)


def test_slab_body_pads_with_the_dummy_face():
    """F = 80 faces in 3 slabs of 27 ranks: the last slab holds 26 faces and
    one dummy (vertex row (0, 0, 0), opacity 0); the three partials fold to
    the one-process render."""
    s = W.scene()
    params = _leaves(s)
    faces = torch.as_tensor(s["faces"])
    fi, mv, proj, bg = (torch.as_tensor(s[k]) for k in (
        "faces_intense", "mv", "proj", "background"))
    assert faces.shape[0] == 80
    order = FP.depth_slab_order(params.verts, faces, mv, proj, W.HW, W.HW)
    with torch.no_grad():
        parts = [FP.render_slab(params, faces, fi, mv, proj, order, W.HW, W.HW, 1.0,
                                _cfg(), k, 3) for k in range(3)]
    c, d, t = FP.composite_slabs(*(torch.stack([p[i] for p in parts]) for i in range(3)))
    ref_c, ref_d, aux = render(*_args(s), W.HW, W.HW, 1.0, _cfg(), device="cpu")
    np.testing.assert_allclose((c + t[..., None] * bg).numpy(), ref_c.numpy(),
                               atol=RENDER_TOL)
    np.testing.assert_allclose((1.0 - ((d + t) + 1.0) / 2.0).numpy(), ref_d.numpy(),
                               atol=RENDER_TOL)
    # each view's dummy face may bin into one tile
    n = int(aux.num_rendered)
    assert n <= sum(int(p[3]) for p in parts) <= n + fi.shape[0]


def test_an_axis_the_mesh_lacks_raises():
    s = W.scene()
    mesh = make_face_mesh(device="cpu")
    with pytest.raises(ValueError, match="'dp' is not an axis"):
        render_faces_sharded(mesh, *_args(s), W.HW, W.HW, 1.0, _cfg(), axis="dp")
    with pytest.raises(ValueError, match="'dp' is not an axis"):
        make_face_sharded_train_step(mesh, torch.optim.SGD, s["faces"], W.HW, W.HW,
                                     axis="dp")


def test_slabs_rank_by_the_unquantized_depth_as_in_jax():
    """Two overlapping triangles 1e-5 apart in depth on a 1024x1024 frame,
    whose 4,096 tiles leave the binning 18 depth bits: their quantized
    depths tie, so one render composites them in id order, the farther face
    0 first (red over blue). The slabs rank by the unquantized depth, as the
    JAX _depth_slab_order does: face 1 is slab 0, so the fold composites
    blue over red and departs from the render, as the JAX slabs do
    (ROADMAP.md section 3)."""
    from dmesh2_renderer_tpu_torch import geometry as G
    from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
    from dmesh2_renderer_tpu_torch.utils.meshes import look_at, perspective

    hw = 1024
    tri = np.array([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.0, 0.5, 0.0]], np.float32)
    verts = np.concatenate([tri - [0, 0, 1e-5], tri]).astype(np.float32)
    faces = np.arange(6, dtype=np.int32).reshape(2, 3)
    mv = look_at((0.0, 0.0, 3.0), (0.0, 0.0, 0.0))[None]
    proj = perspective(45.0, 1.0)[None]
    args = [torch.as_tensor(x) for x in (
        verts, faces, np.array([[1, 0, 0]] * 3 + [[0, 0, 1]] * 3, np.float32),
        np.array([0.6, 0.6], np.float32), np.ones((1, 2), np.float32), mv, proj,
        np.array([0.0, 0.0, 0.0], np.float32))]
    cfg = RasterConfig(binning_capacity=1 << 14)
    ndc, _ = G.compute_verts_ndc_image(args[0], args[5], args[6], hw, hw)
    depth01 = face_depth01(ndc, args[1])[0][0]
    assert depth01[0] > depth01[1]                 # face 0 lies behind
    dq = (depth01 * float((1 << 18) - 1)).to(torch.int32)
    assert dq[0] == dq[1]
    order = FP.depth_slab_order(args[0], args[1], args[5], args[6], hw, hw)
    jax_order = JF._depth_slab_order(jnp.asarray(verts), jnp.asarray(faces),
                                     jnp.asarray(mv), jnp.asarray(proj), hw, hw)
    assert order.tolist() == np.asarray(jax_order).tolist() == [[1, 0]]
    params = SceneParams(args[0], args[2], args[3])
    with torch.no_grad():
        parts = [FP.render_slab(params, args[1], args[4], args[5], args[6], order, hw,
                                hw, 1.0, cfg, k, 2) for k in range(2)]
    c, _, _ = FP.composite_slabs(*(torch.stack([p[i] for p in parts]) for i in range(3)))
    ref_c, _, _ = render(*args, hw, hw, 1.0, cfg, device="cpu")
    fold, centre = c[0, hw // 2, hw // 2], ref_c[0, hw // 2, hw // 2]
    assert float(centre[0]) > float(centre[2]) > 0     # the render: red over blue
    assert float(fold[2]) > float(fold[0]) > 0         # the slabs: blue over red


def test_slabs_depart_from_render_at_a_giant_tier_tie_as_in_jax():
    """The witness that the JAX package's own slabs depart from its render
    at a depth tie (ROADMAP.md section 3): in tests/_torch_dist_worker.py's
    tie scene one render composites face 1 over face 0 where face 0 is in
    the giant tier (the regular tier goes first), while the slabs rank by
    depth, then id: face 0 is slab 0. The JAX render_faces_sharded on 2
    devices departs from the JAX render there by more than 0.3; the port's
    two slabs fold to the JAX result within 1e-4 and depart from the port's
    render on the same pixels."""
    s = W.tie_scene()
    w, h = W.TIE_FRAME
    keys = ("verts", "faces", "verts_color", "faces_opacity", "faces_intense", "mv",
            "proj", "background")
    j = [jnp.asarray(s[k]) for k in keys]
    from dmesh2_renderer_tpu import functional as JFn

    jcfg = JaxConfig(**W.TIE_CONFIG)
    jax_render = np.asarray(JFn.render(*j, w, h, 1.0, jcfg)[0])
    jax_slabs = np.asarray(JF.render_faces_sharded(JF.make_face_mesh(WORLD), *j, w, h,
                                                   1.0, jcfg)[0])
    jax_moved = np.abs(jax_slabs - jax_render).max(axis=-1) > 0.3
    assert 0 < jax_moved.sum() < jax_moved.size

    args = [torch.as_tensor(s[k]) for k in keys]
    cfg = RasterConfig(**W.TIE_CONFIG)
    order = FP.depth_slab_order(args[0], args[1], args[5], args[6], w, h)
    assert order.tolist() == [[0, 1]]
    params = SceneParams(args[0], args[2], args[3])
    with torch.no_grad():
        parts = [FP.render_slab(params, args[1], args[4], args[5], args[6], order, w,
                                h, 1.0, cfg, k, WORLD) for k in range(WORLD)]
    c, _, t = FP.composite_slabs(*(torch.stack([p[i] for p in parts]) for i in range(3)))
    ref_c, _, _ = render(*args, w, h, 1.0, cfg, device="cpu")
    np.testing.assert_allclose(ref_c.numpy(), jax_render, atol=JAX_IMAGE_TOL)
    np.testing.assert_allclose(c.numpy(), jax_slabs, atol=JAX_IMAGE_TOL)
    moved = (c - ref_c).abs().amax(dim=-1).numpy() > 0.3
    np.testing.assert_array_equal(moved, jax_moved)
