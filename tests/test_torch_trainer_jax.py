"""The port's multi-view optimisation step (train.Trainer.step, one rank,
Adam) against the JAX package's make_sharded_train_step and functional
render on a one-device CPU mesh (Pallas in interpret mode), from the same
restored snapshot: the step's own render, its loss, its three gradients and
the updated parameters. The scene and the trainer are
tests/test_torch_trainer.py's: three views of 48x40 binned in one batch."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from dmesh2_renderer_tpu.functional import render as jax_render
from dmesh2_renderer_tpu.parallel import data_parallel as JD
from dmesh2_renderer_tpu.utils.config import RasterConfig as JaxConfig
from tests.test_torch_trainer import (
    CFG, H, LR, W, WARMUP, _scene, _snapshot, _trainer, step_keeping_render,
)

LEAVES = ("verts", "verts_color", "faces_opacity")
JAX_CFG = JaxConfig(binning_capacity=CFG.binning_capacity,
                    max_tiles_per_face=CFG.max_tiles_per_face,
                    num_giant_faces=CFG.num_giant_faces,
                    exact_tile_cull=CFG.exact_tile_cull, interpret=True)
# Colour: each package builds its own rays, whose differently ordered float32
# products move u, v on grazing faces by up to ~1e-4
# (tests/test_torch_renderer.py OWN_RAYS_TOL); depth: 2e-5, the packages'
# projection ulps (tests/test_torch_renderer.py TOL).
COLOR_TOL, DEPTH_TOL = 1e-4, 2e-5
# The loss is the mean of (c - t)^2 with |c - t| <= 1: the image's
# departure moves it by at most 2 COLOR_TOL per element, far less on
# average; 2e-5 is tests/test_torch_parallel.py's loss tolerance.
LOSS_TOL = 2e-5
# The image's departure reaches the gradients through the same faces; 1e-4
# of each leaf's norm is the colour tolerance's relative size.
GRAD_TOL = 1e-4
# Adam scales this step's share (1 - beta1 = 0.1) of m-hat by 1/sqrt(v-hat)
# over a shared history, so an element whose gradient differs by a fraction
# d moves by about 0.4 d lr: 1e-2 lr is d = 2.5% on any element.
PARAM_TOL = 1e-2 * LR


def _keep_grads():
    """An optax stage that passes the updates on and keeps them as its
    state: after the step it holds the gradients the optimizer saw."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _jax_opt_state(opt, params, torch_state):
    """``opt.init(params)`` with Adam's moments and count set from the
    port's optimizer state."""
    keep, (adam, *rest) = opt.init(params)
    moments = {k: JD.SceneParams(*(jnp.asarray(torch_state[i][k].numpy()) for i in range(3)))
               for k in ("exp_avg", "exp_avg_sq")}
    adam = adam._replace(count=jnp.asarray(WARMUP, adam.count.dtype),
                         mu=moments["exp_avg"], nu=moments["exp_avg_sq"])
    return keep, (adam, *rest)


@pytest.fixture(scope="module")
def both():
    params, faces, inputs = _scene()
    trainer = _trainer(faces)
    state = trainer.init_state(params)
    for _ in range(WARMUP):
        state, _ = trainer.step(state, *inputs)
    snap = _snapshot(state)
    state, loss, (color, depth, _) = step_keeping_render(trainer, state, inputs)
    prog = dict(color=color.detach().numpy(), depth=depth.detach().numpy(), loss=float(loss),
                grads=[p.grad.numpy() for p in state.params],
                params=[p.detach().numpy() for p in state.params],
                before=[p.numpy() for p in snap[0]])

    jparams = JD.SceneParams(*(jnp.asarray(p.numpy()) for p in snap[0]))
    jfaces = jnp.asarray(faces.numpy())
    intense, mv, proj, target, bg = (jnp.asarray(x.numpy()) for x in inputs)
    jcolor, jdepth, _ = jax_render(jparams.verts, jfaces, jparams.verts_color,
                                   jparams.faces_opacity, intense, mv, proj, bg, W, H, 1.0,
                                   JAX_CFG)
    opt = optax.chain(_keep_grads(), optax.adam(LR))
    step = JD.make_sharded_train_step(Mesh(np.array(jax.devices()[:1]), ("dp",)), opt,
                                      jfaces, W, H, 1.0, JAX_CFG)
    new, opt_state, jloss, stats = step(jparams, _jax_opt_state(opt, jparams, snap[1]["state"]),
                                        intense, mv, proj, target, bg)
    want = dict(color=np.asarray(jcolor), depth=np.asarray(jdepth), loss=float(jloss),
                grads=[np.asarray(g) for g in opt_state[0]],
                params=[np.asarray(p) for p in new], truncated=int(stats.num_truncated))
    return prog, want


def test_trainer_step_image_and_loss_match_jax(both):
    prog, want = both
    assert want["truncated"] == 0
    np.testing.assert_allclose(prog["color"], want["color"], atol=COLOR_TOL)
    np.testing.assert_allclose(prog["depth"], want["depth"], atol=DEPTH_TOL)
    assert abs(prog["loss"] - want["loss"]) <= LOSS_TOL


@pytest.mark.parametrize("i,leaf", list(enumerate(LEAVES)))
def test_trainer_step_gradients_and_update_match_jax(both, i, leaf):
    prog, want = both
    g, g_want = prog["grads"][i], want["grads"][i]
    assert np.linalg.norm(g_want) > 0, leaf
    assert np.linalg.norm(g - g_want) <= GRAD_TOL * np.linalg.norm(g_want), leaf
    # The step moved the leaf by about lr, and both packages the same way.
    assert np.abs(prog["params"][i] - prog["before"][i]).max() > 0.1 * LR, leaf
    np.testing.assert_allclose(prog["params"][i], want["params"][i], atol=PARAM_TOL,
                               rtol=0, err_msg=leaf)
