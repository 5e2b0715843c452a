"""The port's multi-view optimisation step (train.Trainer.step over
make_sharded_train_step, one rank, Adam) against the plain oracle of
oracle/train_step.py on a tiny soup of three views whose binning shares one
set of depth bits; a step repeated from one restored snapshot; and the
step's profiler ranges and host-sync counts. CPU only, with the port alone
(tests/test_torch_trainer_jax.py holds the same step to the JAX package)."""

import copy
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from dmesh2_renderer_tpu_torch import RasterConfig
from dmesh2_renderer_tpu_torch.oracle.train_step import LEAVES, train_step
from dmesh2_renderer_tpu_torch.parallel import SceneParams, data_parallel, make_view_mesh
from dmesh2_renderer_tpu_torch.train import Trainer
from dmesh2_renderer_tpu_torch.utils.meshes import orbit_cameras
from dmesh2_renderer_tpu_torch.utils.profiling import counters, reset_counters

B, W, H = 3, 48, 40
LR = 1e-3
# 3 x 3 tiles a view, 27 in the batch: 26 depth bits in the packed keys;
# faces over 4 tiles take the giant tier, and the exact cull drops slots.
CFG = RasterConfig(binning_capacity=1 << 12, max_tiles_per_face=4, num_giant_faces=32,
                   exact_tile_cull=True)
WARMUP = 2


def _scene(seed=7, n_faces=200):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-0.8, 0.8, (n_faces, 1, 3))
    verts = (centres + rng.normal(0.0, 0.12, (n_faces, 3, 3))).reshape(-1, 3)
    verts = torch.as_tensor(verts, dtype=torch.float32)
    faces = torch.arange(3 * n_faces, dtype=torch.int32).reshape(n_faces, 3)
    mv, proj = (torch.as_tensor(a) for a in orbit_cameras(B))
    gen = torch.Generator().manual_seed(seed)
    knots = torch.rand((B, 3, 3, 4), generator=gen)
    target = F.interpolate(knots, size=(H, W), mode="bilinear", align_corners=True)
    params = SceneParams(verts, torch.remainder(verts.abs(), 1.0),
                         torch.full((n_faces,), 0.5))
    inputs = (torch.ones((B, n_faces)), mv, proj, target.permute(0, 2, 3, 1).contiguous(),
              torch.zeros(3))
    return params, faces, inputs


def _trainer(faces, config=CFG):
    adam = functools.partial(torch.optim.Adam, lr=LR)
    return Trainer(make_view_mesh(device="cpu"), adam, faces, W, H, 1.0, config)


def _snapshot(state):
    return ([p.detach().clone() for p in state.params],
            copy.deepcopy(state.opt_state.state_dict()))


def _restore(state, snap):
    with torch.no_grad():
        for p, q in zip(state.params, snap[0]):
            p.copy_(q)
    state.opt_state.load_state_dict(copy.deepcopy(snap[1]))


def step_keeping_render(trainer, state, inputs):
    """``trainer.step`` that also returns what the step's own call of
    ``functional.render`` returned: (state, loss, (colour, depth, aux))."""
    kept = []
    orig = data_parallel.render

    def keep(*args, **kw):
        kept.append(orig(*args, **kw))
        return kept[-1]

    data_parallel.render = keep
    try:
        state, loss = trainer.step(state, *inputs)
    finally:
        data_parallel.render = orig
    (out,) = kept
    return state, loss, out


@pytest.fixture(scope="module")
def stepped():
    """The trainer after its warm-up, the snapshot then, the step from it
    (its own render, loss, gradients, updated parameters) and the oracle's
    step from the same snapshot."""
    params, faces, inputs = _scene()
    trainer = _trainer(faces)
    state = trainer.init_state(params)
    for _ in range(WARMUP):
        state, _ = trainer.step(state, *inputs)
    snap = _snapshot(state)
    state, loss, (color, depth, _) = step_keeping_render(trainer, state, inputs)
    prog = dict(loss=loss, grads={k: p.grad.clone() for k, p in zip(LEAVES, state.params)},
                params={k: p.detach().clone() for k, p in zip(LEAVES, state.params)},
                color=color.detach(), depth=depth.detach())
    intense, mv, proj, target, bg = inputs
    adam_state = {k: s for k, s in zip(LEAVES, (snap[1]["state"][i] for i in range(3)))}
    oracle = train_step(dict(zip(LEAVES, snap[0])), faces, intense, mv, proj, target, bg, W,
                        H, 1.0, CFG, adam_state, LR)
    return dict(trainer=trainer, state=state, snap=snap, inputs=inputs, faces=faces,
                prog=prog, oracle=oracle)


def test_the_batch_bins_with_shared_depth_bits(stepped):
    """The oracle bins the three views at once and drops nothing: each
    view's faces sort among 27 tiles' keys."""
    o = stepped["oracle"]
    assert int(o["num_truncated"]) == 0 and int(o["num_rendered"]) > 0
    assert float((o["color"] != 0).float().mean()) > 0.3


def test_trainer_step_matches_the_oracle(stepped):
    """Image, loss, the three gradients and the updated parameters."""
    prog, o = stepped["prog"], stepped["oracle"]
    # On the CPU the port's step runs the oracle's plain binning and
    # compositors, so image and loss agree bit for bit; what this test holds
    # independently is the reduction, the gradients and Adam.
    # tests/test_torch_trainer_jax.py holds the image to the JAX package.
    assert torch.equal(prog["color"], o["color"])
    assert torch.equal(prog["depth"], o["depth"])
    # One mean over the same image and targets.
    assert float(prog["loss"]) == float(o["loss"])
    for k in LEAVES:
        g, want = prog["grads"][k], o["grads"][k]
        # Equal here; the colour cotangent is autograd's against the
        # oracle's written-out 2 (c - t) / N, whose product order may move
        # the last bit of a per-pixel term: 1e-6 of the leaf's norm is
        # about ten float32 roundings of it.
        assert float((g - want).norm()) <= 1e-6 * float(want.norm()), k
    for k in LEAVES:
        step = (prog["params"][k] - stepped["snap"][0][LEAVES.index(k)]).abs().max()
        assert float(step) > 0.1 * LR, k          # the step moved every leaf
        # Adam's two forms round differently, by a few ulps of an update
        # of about lr (~1e-10); the sum with the parameter then rounds to
        # its own ulp, 1.2e-7 at |p| < 2: at most two of those.
        gap = (prog["params"][k] - o["params"][k]).abs().max()
        assert float(gap) <= 2.4e-7, k


def test_a_step_from_one_snapshot_repeats_exactly(stepped):
    """Two steps, each from the restored snapshot, give the same loss,
    gradients and parameters bit for bit, and the optimizer's step count
    is the snapshot's plus one both times."""
    trainer, state, snap = stepped["trainer"], stepped["state"], stepped["snap"]
    outs = []
    for _ in range(2):
        _restore(state, snap)
        state, loss = trainer.step(state, *stepped["inputs"])
        outs.append((float(loss), [p.grad.clone() for p in state.params],
                     [p.detach().clone() for p in state.params]))
        steps = {float(s["step"]) for s in state.opt_state.state.values()}
        assert steps == {WARMUP + 1.0}
    (l0, g0, p0), (l1, g1, p1) = outs
    assert l0 == l1 == float(stepped["prog"]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(g0 + p0, g1 + p1))


@pytest.mark.parametrize("cap,reads", [(None, 1), (1 << 20, 2)])
def test_step_counts_render_stats_syncs(cap, reads):
    """The capacity check reads ``num_truncated``, and with
    ``grad_compact_capacity`` set ``num_grad_contributing`` too: each read
    is one pass through the sync site ``render_stats``. The step's other
    site: the projection's ``image_scale`` (the gradient reduction has
    none)."""
    params, faces, inputs = _scene(n_faces=20)
    config = RasterConfig(**{**CFG.__dict__, "grad_compact_capacity": cap})
    trainer = _trainer(faces, config)
    state = trainer.init_state(params)
    state, _ = trainer.step(state, *inputs)
    reset_counters()
    for _ in range(2):
        state, _ = trainer.step(state, *inputs)
    assert counters()["syncs"] == {"render_stats": 2 * reads, "image_scale": 2}


def test_step_opens_its_ranges_once():
    """Under a profiler a step is one ``dmesh2/train_step`` holding one
    ``loss``, one ``optimizer``, one ``stats`` and the render's and the
    backward's roots."""
    params, faces, inputs = _scene(n_faces=20)
    trainer = _trainer(faces)
    state = trainer.init_state(params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            state, _ = trainer.step(state, *inputs)
    ranges = [(e.name[len("dmesh2/"):], e.time_range) for e in prof.events()
              if e.name.startswith("dmesh2/")]
    names = [n for n, _ in ranges]
    for name in ("train_step", "loss", "optimizer", "stats", "render", "backward",
                 "sync/render_stats"):
        assert names.count(name) == 2, (name, names)
    roots = [t for n, t in ranges if n == "train_step"]
    for n, t in ranges:
        assert any(r.start <= t.start and t.end <= r.end for r in roots), n
