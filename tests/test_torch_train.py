"""The port's Trainer and checkpoints (train.py) on a world of one, on the
scenes of tests/test_train.py: the loss falls, a checkpoint restores the
parameters, the optimizer state and the step exactly, the capacity warnings
reach the training loop with the port's wording, and a mesh with an "sp"
axis takes the pixel-band grid step."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from dmesh2_renderer_tpu.utils.meshes import icosphere, orbit_cameras
from dmesh2_renderer_tpu_torch import RasterConfig, render
from dmesh2_renderer_tpu_torch.parallel import (
    RenderStats, SceneParams, make_grid_train_step, make_mesh, make_view_mesh)
from dmesh2_renderer_tpu_torch.train import (
    TrainState, Trainer, check_render_stats, load_checkpoint, save_checkpoint)

CFG = RasterConfig(binning_capacity=1 << 12, interpret=True)
ADAM = functools.partial(torch.optim.Adam, lr=1e-2)


def _scene(b, subdiv=0):
    verts, faces = icosphere(subdiv)
    mv, proj = orbit_cameras(b)
    f = faces.shape[0]
    params = SceneParams(verts, np.abs(verts), np.full((f,), 0.7, np.float32))
    return params, faces, (np.ones((b, f), np.float32), mv, proj)


def test_trainer_checkpoint_resume(tmp_path):
    """tests/test_train.py's resume test: after two Adam steps the loss has
    fallen and the checkpoint exists; a fresh trainer restores the step, the
    parameters and Adam's moments exactly, and its next step equals the
    first trainer's bit for bit."""
    b, hw = 4, 16
    params, faces, (it, mv, proj) = _scene(b)
    bg = np.zeros(3, np.float32)
    tgt = np.zeros((b, hw, hw, 3), np.float32)
    ckpt = os.path.join(tmp_path, "state.npz")
    mesh = make_view_mesh(device="cpu")
    tr = Trainer(mesh, ADAM, faces, hw, hw, 1.0, CFG, checkpoint_path=ckpt,
                 checkpoint_every=2)
    state = tr.init_state(params)
    losses = []
    for _ in range(2):
        state, loss = tr.step(state, it, mv, proj, tgt, bg)
        losses.append(float(loss))
    assert losses[1] < losses[0] and os.path.exists(ckpt)
    assert int(state.step) == 2

    tr2 = Trainer(mesh, ADAM, faces, hw, hw, 1.0, CFG, checkpoint_path=ckpt)
    state2 = tr2.init_state(params)
    assert int(state2.step) == 2
    for a, b_ in zip(state2.params, state.params):
        assert torch.equal(a, b_) and a.requires_grad
    sd1, sd2 = state.opt_state.state_dict(), state2.opt_state.state_dict()
    assert sd1["param_groups"] == sd2["param_groups"]
    for k in sd1["state"]:
        for name, v in sd1["state"][k].items():
            assert torch.equal(v, sd2["state"][k][name]), (k, name)
    state, _ = tr.step(state, it, mv, proj, tgt, bg)
    state2, _ = tr2.step(state2, it, mv, proj, tgt, bg)
    for a, b_ in zip(state2.params, state.params):
        assert torch.equal(a, b_)


def test_checkpoint_roundtrip_scalars(tmp_path):
    """A train state of any optimizer round-trips, scalars and nested
    hyperparameters included; a template with another number of parameter
    leaves or other shapes raises ValueError, as in the JAX package."""
    p = SceneParams(*(torch.full(s, v, requires_grad=True)
                      for s, v in (((4, 3), 1.0), ((4, 3), 0.0), ((2,), 1.0))))
    opt = torch.optim.SGD(list(p), lr=0.5, momentum=0.9, nesterov=True)
    for t in p:
        t.grad = torch.ones_like(t)
    opt.step()
    st = TrainState(p, opt, torch.tensor(7, dtype=torch.int32))
    path = os.path.join(tmp_path, "c.npz")
    save_checkpoint(path, st)
    q = SceneParams(*(torch.zeros_like(t).requires_grad_(True) for t in p))
    back = load_checkpoint(path, TrainState(q, torch.optim.SGD(
        list(q), lr=0.1, momentum=0.9, nesterov=True), torch.zeros((), dtype=torch.int32)))
    assert int(back.step) == 7 and back.params is q
    assert all(torch.equal(a, b) for a, b in zip(back.params, p))
    assert back.opt_state.param_groups[0]["lr"] == 0.5
    assert torch.equal(back.opt_state.state[q[0]]["momentum_buffer"],
                       opt.state[p[0]]["momentum_buffer"])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    with pytest.raises(ValueError, match="parameter leaves"):
        load_checkpoint(path, TrainState(q[:2], opt, st.step))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, TrainState(SceneParams(torch.zeros(5, 3), q[1], q[2]),
                                         opt, st.step))


def test_trainer_surfaces_compaction_overflow():
    """tests/test_train.py's scene: a contributing count above
    grad_compact_capacity reaches the training loop as a warning, worded
    for the port (its backward keeps every row; the JAX package's would
    drop the excess), and last_stats carries the count, which equals the
    forward's."""
    b, hw = 1, 32
    params, faces, (it, mv, proj) = _scene(b, subdiv=2)
    params = params._replace(faces_opacity=np.full((faces.shape[0],), 0.2, np.float32))
    cfg = dataclasses.replace(CFG, grad_compact_capacity=128)
    tr = Trainer(make_view_mesh(device="cpu"), ADAM, faces, hw, hw, 1.0, cfg)
    state = tr.init_state(params)
    with pytest.warns(RuntimeWarning, match="gradients stay right"):
        tr.step(state, it, mv, proj, np.zeros((b, hw, hw, 3), np.float32),
                np.zeros(3, np.float32))
    n = int(tr.last_stats.num_grad_contributing)
    _, _, aux = render(params.verts, faces, params.verts_color, params.faces_opacity,
                       it, mv, proj, np.zeros(3, np.float32), hw, hw, 1.0, cfg,
                       device="cpu")
    assert n == int(aux.num_grad_contributing) > 128


def test_check_render_stats_warns_on_truncation():
    with pytest.warns(RuntimeWarning, match="binning truncated 5 face instances"):
        check_render_stats(RenderStats(torch.tensor(5), torch.tensor(0), torch.tensor(9)), CFG)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        check_render_stats(RenderStats(torch.tensor(0), torch.tensor(10 ** 6),
                                       torch.tensor(10 ** 7)), CFG)


def test_trainer_grid_mesh_step():
    """A mesh with an "sp" axis takes the JAX Trainer's route: the grid step
    of parallel/patch_parallel.py (views over "dp", pixel bands over "sp").
    On a (1, 1) ("dp", "sp") world of one it trains as the grid step does,
    bit for bit, and the 1-D view mesh keeps the view-parallel step."""
    params, faces, (it, mv, proj) = _scene(2)
    hw = 16
    tgt = np.zeros((2, hw, hw, 3), np.float32)
    bg = np.zeros(3, np.float32)
    grid = make_mesh((1, 1), ("dp", "sp"), device="cpu")
    tr = Trainer(grid, ADAM, faces, hw, hw, 1.0, CFG)
    assert tr.step_fn.__qualname__.startswith("make_grid_train_step")
    assert Trainer(make_view_mesh(device="cpu"), ADAM, faces, hw, hw, 1.0,
                   CFG).step_fn.__qualname__.startswith("make_sharded_train_step")
    state = tr.init_state(params)
    step = make_grid_train_step(grid, ADAM, faces, hw, hw, 1.0, CFG)
    leaves = SceneParams(*(torch.tensor(p, requires_grad=True) for p in params))
    opt = step.init(leaves)
    for _ in range(2):
        state, loss = tr.step(state, it, mv, proj, tgt, bg)
        _, _, want, stats = step(leaves, opt, it, mv, proj, tgt, bg)
        assert float(loss) == float(want)
        assert [int(x) for x in tr.last_stats] == [int(x) for x in stats]
    assert all(torch.equal(a, b) for a, b in zip(state.params, leaves))
    assert int(state.step) == 2
