"""``trainer``: one iteration is ``Trainer.step``
(``dmesh2_renderer_tpu_torch.train``) on a one-rank view mesh: every view of
the scene rendered in one call, the mean squared colour error against the
scene's target images, its backward and the configuration's optimizer
step over the vertices, vertex colours and face opacities (the per-view
intensities are inputs). After the warm-up the loop snapshots the
parameters and the optimizer's state, its step count included; every later
iteration first copies that snapshot back, so each measured step does the
same work. The check: the last step's own render (the colour, depth and
counts that ``make_sharded_train_step`` took from ``functional.render``
inside the step), its loss, its gradients and its updated parameters
against the reference's step from the same snapshot."""

from __future__ import annotations

import functools
import importlib

import torch

from bench_port import faults
from bench_port.loop import gap, render_numbers
from bench_port.reference import trainer as ref

LEAVES = ref.LEAVES
KERNELS = ("bin_emit", "pack_stream", "composite_fwd", "composite_bwd")
DATA_PARALLEL = "dmesh2_renderer_tpu_torch.parallel.data_parallel"
ADAM_STATE = ("exp_avg", "exp_avg_sq", "step")


def first_view_detached(orig):
    """The step's render with view 0's colour detached: that view drops out
    of the loss's gradient."""
    def f(*args, **kw):
        color, *rest = orig(*args, **kw)
        return (torch.cat([color[:1].detach(), color[1:]]), *rest)
    return f


def step_skipped(optimizer_cls):
    """The optimizer, with a step that updates nothing."""
    class Skipping(optimizer_cls):
        def step(self, closure=None):
            return None
    return Skipping


def gradients_kept(optimizer_cls):
    """The optimizer, with a ``zero_grad`` that clears nothing: gradients
    add up from step to step."""
    class Keeping(optimizer_cls):
        def zero_grad(self, set_to_none=True):
            return None
    return Keeping


def one_depth(orig):
    """The step's render with one pixel's depth moved by 0.01: depth is not
    in the loss, so only the check of the step's own render sees it."""
    def f(*args, **kw):
        color, depth, aux = orig(*args, **kw)
        depth = depth.clone()
        depth[0, 5, 7] += 0.01
        return color, depth, aux
    return f


FAULTS = dict(
    dropped_view=(DATA_PARALLEL, "render", first_view_detached),
    step_skipped=("torch.optim", "Adam", step_skipped),
    gradients_kept=("torch.optim", "Adam", gradients_kept),
    altered_gradient=(faults.RASTERIZE, "composite_backward", faults.one_record),
    altered_depth=(DATA_PARALLEL, "render", one_depth),
)


class Loop:
    def __init__(self, scene, config, mix, device, spans):
        from dmesh2_renderer_tpu_torch import RasterConfig
        from dmesh2_renderer_tpu_torch.parallel import SceneParams, make_view_mesh
        from dmesh2_renderer_tpu_torch.train import Trainer

        self.scene = scene
        opt = config["optimizer"]
        optimizer = functools.partial(getattr(torch.optim, opt["name"]), lr=float(opt["lr"]),
                                      betas=tuple(opt["betas"]), eps=float(opt["eps"]))
        self.trainer = Trainer(make_view_mesh(device=device), optimizer, scene.faces,
                               int(config["width"]), int(config["height"]),
                               float(config["aa_temperature"]), RasterConfig(**config["raster"]))
        self.state = self.trainer.init_state(
            SceneParams(scene.verts, scene.verts_color, scene.faces_opacity))
        self.target = scene.extra["target_color"]
        self.warmup = int(mix["warmup"])
        self.steps = 0
        self.snapshot = self._take() if self.warmup == 0 else None
        self.auxes = []
        self.loss = None
        self.rendered = None

    def _take(self):
        """Copies of the parameters and, by leaf, of the optimizer's state."""
        opt = self.state.opt_state
        return ([p.detach().clone() for p in self.state.params],
                [{k: v.clone() for k, v in opt.state[p].items()} if p in opt.state else None
                 for p in self.state.params])

    def _restore(self):
        params, states = self.snapshot
        opt = self.state.opt_state
        with torch.no_grad():
            for p, saved, state in zip(self.state.params, params, states):
                p.copy_(saved)
                if state is None:
                    opt.state.pop(p, None)
                else:
                    for k, v in state.items():
                        opt.state[p][k].copy_(v)

    def _kept(self, orig):
        """``functional.render`` as the step calls it, keeping what it
        returns: (colour, depth, aux), detached."""
        def f(*args, **kw):
            color, depth, aux = orig(*args, **kw)
            self.rendered = (color.detach(), depth.detach(), aux)
            return color, depth, aux
        return f

    def step(self):
        if self.snapshot is not None:
            self._restore()
        s = self.scene
        self.rendered = None
        module = importlib.import_module(DATA_PARALLEL)
        orig = module.render
        module.render = self._kept(orig)
        try:
            self.state, self.loss = self.trainer.step(self.state, s.faces_intense, s.mv,
                                                      s.proj, self.target, s.background)
        finally:
            module.render = orig
        self.auxes.append(self.trainer.last_stats)
        self.steps += 1
        if self.steps == self.warmup:
            self.snapshot = self._take()

    def failed(self) -> int:
        """Steps whose binning truncated an entry."""
        return int(sum(int(a.num_truncated > 0) for a in self.auxes))

    def outputs(self, seed):
        params, states = self.snapshot
        color, depth, aux = self.rendered
        truncated = [int(a.num_truncated) for a in self.auxes]
        live = self.state.params
        return dict(
            color=color, depth=depth, num_rendered=int(aux.num_rendered),
            num_truncated=max(truncated), loss=float(self.loss),
            grads={k: p.grad for k, p in zip(LEAVES, live)},
            params={k: p.detach() for k, p in zip(LEAVES, live)},
            snapshot=dict(
                params=dict(zip(LEAVES, params)),
                adam={k: {n: st[n] for n in ADAM_STATE}
                      for k, st in zip(LEAVES, states) if st is not None}))

    def release(self):
        self.trainer = None
        self.state = None
        self.snapshot = None
        self.rendered = None
        self.auxes = []

    @staticmethod
    def reference(scene, config, mix, precision, prog):
        return ref.train_step(scene, scene.extra["target_color"], int(config["width"]),
                              int(config["height"]), float(config["aa_temperature"]),
                              config["raster"], prog["snapshot"], config["optimizer"],
                              precision)

    @staticmethod
    def compare(prog, reference) -> dict:
        """The render's numbers; ``grad_gap`` as the train cell's over the
        three leaves (the largest norm of program - reference over the
        larger of the reference leaf's norm and the median leaf's);
        ``loss_gap``, |loss - reference| over the reference's; and
        ``param_gap``, the largest |updated parameter - reference's| over
        the learning rate."""
        nums = render_numbers(prog, reference)
        norms = {k: float(reference["grads"][k].norm()) for k in LEAVES}
        median = sorted(norms.values())[len(norms) // 2]
        grad_gap, param_gap = 0.0, 0.0
        for k in LEAVES:
            g = prog["grads"][k]
            if g is None:
                grad_gap = float("inf")
                continue
            diff = float((g.float() - reference["grads"][k]).norm())
            grad_gap = max(grad_gap, diff / max(norms[k], median, 1e-30))
            param_gap = max(param_gap, gap(prog["params"][k], reference["params"][k])
                            / reference["lr"])
        loss_gap = abs(prog["loss"] - reference["loss"]) / max(abs(reference["loss"]), 1e-30)
        return dict(nums, grad_gap=grad_gap, loss_gap=loss_gap, param_gap=param_gap)
