"""The port's view parallelism (parallel/data_parallel.py) vs a single
process and vs the JAX package's make_sharded_train_step on a 2-device CPU
mesh (tests/test_parallel.py's semantics).

The two-rank cases run tests/_torch_dist_worker.py as two gloo processes on
the CPU, once per module, each joined with a timeout of its own; their
rendezvous is a file under the test's temporary directory, so concurrent
test workers never share a port. The JAX side runs in this process.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from dmesh2_renderer_tpu.parallel import data_parallel as JD
from dmesh2_renderer_tpu.utils.config import RasterConfig as JaxConfig
from dmesh2_renderer_tpu_torch import RasterConfig, generate_layers, render
from dmesh2_renderer_tpu_torch.parallel import (
    SceneParams, ViewMesh, generate_layers_sharded, make_sharded_train_step,
    make_view_mesh, render_views_sharded)
from dmesh2_renderer_tpu_torch.train import Trainer
from tests import _torch_dist_worker as W

WORLD = 2
# tests/test_torch_grad_api.py:38: verts gradients 5e-4, the rest 2e-5.
VERTS_TOL, TOL = 5e-4, 2e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the two gloo ranks once; returns their outputs as dicts."""
    return W.run_ranks(tmp_path_factory.mktemp("ranks"), "view", WORLD)


def _mesh1():
    return make_view_mesh(device="cpu")


def test_make_view_mesh_world_of_one():
    mesh = _mesh1()
    assert (mesh.rank, mesh.world_size, mesh.device.type, mesh.group) == (0, 1, "cpu", None)
    assert mesh.axis_names == ("dp",)
    with pytest.raises(ValueError, match="n_devices=2"):
        make_view_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="do not split evenly"):
        ViewMesh(None, 0, 2, torch.device("cpu")).shard(3)
    assert ViewMesh(None, 1, 2, torch.device("cpu")).shard(4) == slice(2, 4)


def test_world_of_one_equals_functional_render():
    """render_views_sharded and generate_layers_sharded on a world of one
    are functional.render and functional.generate_layers."""
    s = W.scene()
    cfg = RasterConfig(**W.CONFIG)
    args = [s[k] for k in ("verts", "faces", "verts_color", "faces_opacity",
                           "faces_intense", "mv", "proj", "background")]
    c, d = render_views_sharded(_mesh1(), *args, W.HW, W.HW, 1.0, cfg)
    c_ref, d_ref, _ = render(*args, W.HW, W.HW, 1.0, cfg, device="cpu")
    assert torch.equal(c, c_ref) and torch.equal(d, d_ref)
    lay, cnt, (nr, nt) = generate_layers_sharded(
        _mesh1(), s["verts"], s["faces"], s["faces_existence"], s["mv"], s["proj"],
        W.HW, W.HW, W.LAYERS, cfg)
    l_ref, c_ref, (nr_ref, nt_ref) = generate_layers(
        s["verts"], s["faces"], s["faces_existence"], s["mv"], s["proj"], W.HW,
        W.HW, W.LAYERS, cfg, device="cpu")
    assert torch.equal(lay, l_ref) and torch.equal(cnt, c_ref)
    assert (int(nr), int(nt)) == (int(nr_ref), int(nt_ref)) and int(nt) == 0
    assert int(c_ref.max()) >= 2


def test_two_ranks_render_and_peel_as_one_process(ranks):
    """Each rank holds the whole all-gathered batch, equal to one process
    rendering and peeling every view; the peel's counters are summed."""
    s = W.scene()
    cfg = RasterConfig(**W.CONFIG)
    c_ref, d_ref = render_views_sharded(
        _mesh1(), *[s[k] for k in ("verts", "faces", "verts_color", "faces_opacity",
                                   "faces_intense", "mv", "proj", "background")],
        W.HW, W.HW, 1.0, cfg)
    l_ref, n_ref, (nr, nt) = generate_layers_sharded(
        _mesh1(), s["verts"], s["faces"], s["faces_existence"], s["mv"], s["proj"],
        W.HW, W.HW, W.LAYERS, cfg)
    for out in ranks:
        np.testing.assert_allclose(out["color"], c_ref.numpy(), atol=1e-6)
        np.testing.assert_allclose(out["depth"], d_ref.numpy(), atol=1e-6)
        np.testing.assert_array_equal(out["layers"], l_ref.numpy())
        np.testing.assert_array_equal(out["counts"], n_ref.numpy())
        assert out["peel_aux"].tolist() == [int(nr), int(nt)]


def _one_process_sgd():
    return W.sgd_step(_mesh1(), W.scene(), RasterConfig(**W.CONFIG))


def test_two_ranks_average_gradients_as_one_process(ranks):
    """The all-reduced mean over two ranks of two views each gives the loss
    and gradients one process takes over all four views (the per-rank mean
    and the average reassociate the sum: within float32 rounding), and both
    ranks apply the same update; the stats are max-reduced."""
    loss, grads, after, stats = _one_process_sgd()
    r0, r1 = ranks
    for i in range(3):
        np.testing.assert_array_equal(r0[f"sgd_grad_{i}"], r1[f"sgd_grad_{i}"])
        np.testing.assert_array_equal(r0[f"sgd_param_{i}"], r1[f"sgd_param_{i}"])
        scale = max(float(np.abs(grads[i]).max()), 1.0)
        np.testing.assert_allclose(r0[f"sgd_grad_{i}"], grads[i], atol=1e-6 * scale)
        np.testing.assert_allclose(r0[f"sgd_param_{i}"], after[i], atol=1e-6 * scale)
    assert abs(float(r0["sgd_loss"]) - loss) < 1e-6
    assert float(r0["sgd_loss"]) == float(r1["sgd_loss"])
    assert r0["sgd_stats"][0] == 0 and r0["sgd_stats"][1] > 0
    # max over the ranks: at most the one-process total, at least its share
    assert stats[1] / WORLD <= r0["sgd_stats"][1] <= stats[1]


@functools.lru_cache(maxsize=1)
def _jax_sgd_step():
    s = W.scene()
    cfg = JaxConfig(**W.CONFIG)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    params = JD.SceneParams(jnp.asarray(s["verts"]), jnp.asarray(s["verts_color"]),
                            jnp.asarray(s["faces_opacity"]))
    opt = optax.sgd(W.SGD_LR)
    step = JD.make_sharded_train_step(mesh, opt, jnp.asarray(s["faces"]), W.HW,
                                      W.HW, 1.0, cfg)
    params, _, loss, stats = step(params, opt.init(params),
                                  jnp.asarray(s["faces_intense"]), jnp.asarray(s["mv"]),
                                  jnp.asarray(s["proj"]), jnp.asarray(s["target"]),
                                  jnp.asarray(s["background"]))
    return float(loss), [np.asarray(p) for p in params], [int(x) for x in stats]


def test_two_ranks_match_jax_sharded_train_step(ranks):
    """Loss, gradients and the parameters after one SGD step (lr 1, so the
    step is the gradient) equal the JAX make_sharded_train_step on a
    2-device CPU mesh (Pallas in interpret mode), within the tolerances of
    tests/test_torch_grad_api.py; the stats too. SGD, not Adam: Adam's first
    step is about sign(g), so rounding noise in a near-zero gradient could
    flip an update by a whole learning rate."""
    loss, params, stats = _jax_sgd_step()
    s = W.scene()
    r0 = ranks[0]
    assert abs(float(r0["sgd_loss"]) - loss) < TOL
    for i, (name, tol) in enumerate((("verts", VERTS_TOL), ("verts_color", TOL),
                                     ("faces_opacity", TOL))):
        before = s[name]
        np.testing.assert_allclose(r0[f"sgd_param_{i}"], params[i], atol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(r0[f"sgd_grad_{i}"], (before - params[i]) / W.SGD_LR,
                                   atol=tol, err_msg=name)
        assert np.abs(r0[f"sgd_grad_{i}"]).max() > 1e-4
    # The JAX stats; the port adds num_rendered.
    assert r0["sgd_stats"].tolist()[:2] == stats


def test_two_ranks_train_with_adam_and_resume_exactly(ranks):
    """Adam through the Trainer on two ranks: the loss falls, both ranks
    hold the same parameters, and a trainer resumed from rank 0's
    checkpoint continues bit for bit as the first."""
    r0, r1 = ranks
    losses = r0["adam_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    np.testing.assert_array_equal(losses, r1["adam_losses"])
    for i in range(3):
        np.testing.assert_array_equal(r0[f"adam_param_{i}"], r1[f"adam_param_{i}"])
    assert bool(r0["resume_exact"]) and bool(r1["resume_exact"])


def test_train_step_world_of_one_is_autograd_of_the_loss():
    """On a world of one the step's gradients are autograd of the mean
    squared error (no reduction), and depth_weight adds the depth term."""
    s = W.scene()
    cfg = RasterConfig(**W.CONFIG)
    leaves = [torch.tensor(s[k], requires_grad=True)
              for k in ("verts", "verts_color", "faces_opacity")]
    color, depth, _ = render(leaves[0], s["faces"], leaves[1], leaves[2],
                             s["faces_intense"], s["mv"], s["proj"], s["background"],
                             W.HW, W.HW, 1.0, cfg, device="cpu")
    loss = ((color - torch.as_tensor(s["target"])) ** 2).mean() + 0.5 * (depth ** 2).mean()
    want = torch.autograd.grad(loss, leaves)
    mesh = _mesh1()
    opt = functools.partial(torch.optim.SGD, lr=0.0)
    step = make_sharded_train_step(mesh, opt, s["faces"], W.HW, W.HW, 1.0, cfg,
                                   depth_weight=0.5)
    state = Trainer(mesh, opt, s["faces"], W.HW, W.HW, 1.0, cfg).init_state(
        SceneParams(s["verts"], s["verts_color"], s["faces_opacity"]))
    params, _, got_loss, _ = step(state.params, state.opt_state, s["faces_intense"],
                                  s["mv"], s["proj"], s["target"], s["background"])
    assert float(got_loss) == pytest.approx(float(loss.detach()), abs=1e-7)
    for p, g in zip(params, want):
        assert torch.equal(p.grad, g)


def test_views_that_do_not_split_evenly_raise():
    s = W.scene()
    mesh = dataclasses.replace(_mesh1(), world_size=3)
    with pytest.raises(ValueError, match="split evenly"):
        render_views_sharded(mesh, *[s[k] for k in (
            "verts", "faces", "verts_color", "faces_opacity", "faces_intense", "mv",
            "proj", "background")], W.HW, W.HW)


@pytest.mark.parametrize("entry", ["render", "train_step", "peel"])
def test_an_axis_the_mesh_lacks_raises(entry):
    """Each entry point's ``axis`` must name the mesh's axis: a wrong name
    raises instead of being ignored."""
    s = W.scene()
    mesh = _mesh1()
    cfg = RasterConfig(**W.CONFIG)
    calls = {
        "render": lambda axis: render_views_sharded(
            mesh, *[s[k] for k in ("verts", "faces", "verts_color", "faces_opacity",
                                   "faces_intense", "mv", "proj", "background")],
            W.HW, W.HW, 1.0, cfg, axis=axis),
        "train_step": lambda axis: make_sharded_train_step(
            mesh, torch.optim.SGD, s["faces"], W.HW, W.HW, 1.0, cfg, axis=axis),
        "peel": lambda axis: generate_layers_sharded(
            mesh, s["verts"], s["faces"], s["faces_existence"], s["mv"], s["proj"],
            W.HW, W.HW, W.LAYERS, cfg, axis=axis),
    }
    with pytest.raises(ValueError, match="'sp' is not an axis"):
        calls[entry]("sp")
    calls[entry]("dp")


def test_step_init_builds_the_optimizer_it_was_given():
    """``step.init`` plays optax's ``init``: it builds the step's optimizer
    over the parameters, and the Trainer's state holds that optimizer."""
    s = W.scene()
    cfg = RasterConfig(**W.CONFIG)
    mesh = _mesh1()
    opt = functools.partial(torch.optim.SGD, lr=0.25, momentum=0.5)
    step = make_sharded_train_step(mesh, opt, s["faces"], W.HW, W.HW, 1.0, cfg)
    leaves = [torch.tensor(s[k], requires_grad=True)
              for k in ("verts", "verts_color", "faces_opacity")]
    built = step.init(leaves)
    assert isinstance(built, torch.optim.SGD)
    assert built.param_groups[0]["lr"] == 0.25
    assert built.param_groups[0]["momentum"] == 0.5
    assert all(a is b for a, b in zip(built.param_groups[0]["params"], leaves))
    state = Trainer(mesh, opt, s["faces"], W.HW, W.HW, 1.0, cfg).init_state(
        SceneParams(s["verts"], s["verts_color"], s["faces_opacity"]))
    assert isinstance(state.opt_state, torch.optim.SGD)
    assert state.opt_state.param_groups[0]["lr"] == 0.25
    assert all(a is b for a, b in zip(state.opt_state.param_groups[0]["params"],
                                      state.params))
