"""Inverse-rendering training loop utilities: step, metrics, checkpointing.

Port of ``dmesh2_renderer_tpu/train.py``: the multi-view train step of
``parallel/data_parallel.py`` (views split over the ranks, shared scene
gradients averaged), or on a mesh with an ``"sp"`` axis the view x band
grid step of ``parallel/patch_parallel.py``, with parameter state, capacity warnings, periodic
checkpointing and resume. ``torch.optim`` takes the place of optax: the
``optimizer`` argument builds a ``torch.optim.Optimizer`` from the parameter
list, and that optimizer is the train state's ``opt_state``.

A checkpoint is one ``.npz``: the scene parameters, the optimizer's
``state_dict`` flattened into arrays (its nesting kept as a JSON string)
and the step, written to a temporary name and renamed into place.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from dmesh2_renderer_tpu_torch.parallel.data_parallel import (
    RankMesh,
    RenderStats,
    SceneParams,
    make_sharded_train_step,
)
from dmesh2_renderer_tpu_torch.parallel.patch_parallel import make_grid_train_step
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.profiling import span
from dmesh2_renderer_tpu_torch.utils.validate import check_render_stats


class TrainState(NamedTuple):
    params: SceneParams      # leaf tensors, updated in place by the optimizer
    opt_state: object        # the torch.optim.Optimizer over params
    step: torch.Tensor       # () int32


def _flatten(obj, leaves):
    """Replace every tensor or number of a state_dict by its leaf index."""
    if isinstance(obj, dict):
        return {"dict": [[_flatten(k, leaves), _flatten(v, leaves)]
                         for k, v in obj.items()]}
    if isinstance(obj, (list, tuple)):
        return {"list" if isinstance(obj, list) else "tuple":
                [_flatten(v, leaves) for v in obj]}
    if isinstance(obj, torch.Tensor):
        leaves.append(obj.detach().cpu().numpy())
        return {"tensor": len(leaves) - 1, "device": str(obj.device)}
    if isinstance(obj, np.generic):
        obj = obj.item()
    if isinstance(obj, (bool, int, float)):
        return {type(obj).__name__: obj}
    if obj is None or isinstance(obj, str):
        return {"value": obj}
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _unflatten(node, data):
    (kind, val), = ((k, v) for k, v in node.items() if k != "device")
    if kind == "dict":
        return {_unflatten(k, data): _unflatten(v, data) for k, v in val}
    if kind == "list":
        return [_unflatten(v, data) for v in val]
    if kind == "tuple":
        return tuple(_unflatten(v, data) for v in val)
    if kind == "tensor":
        return torch.from_numpy(data[f"opt_{val}"].copy()).to(node["device"])
    return val


def save_checkpoint(path: str, state: TrainState) -> None:
    """Write the train state as one .npz (written to a temporary name, then
    renamed into place)."""
    leaves = []
    tree = _flatten(state.opt_state.state_dict(), leaves)
    arrays = {f"param_{i}": p.detach().cpu().numpy()
              for i, p in enumerate(state.params)}
    arrays.update({f"opt_{i}": x for i, x in enumerate(leaves)})
    arrays["step"] = np.asarray(int(state.step), np.int32)
    arrays["opt_tree"] = np.asarray(json.dumps(tree))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, template: TrainState) -> TrainState:
    """Restore a train state saved by :func:`save_checkpoint` into
    ``template`` (build it as at save time: same optimizer, same shapes).

    The parameters are copied into the template's tensors, which its
    optimizer holds, and the optimizer's state is loaded. Raises ValueError
    when the checkpoint's parameter leaves do not match the template's.
    """
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("param_"))
        if n != len(template.params):
            raise ValueError(
                f"checkpoint has {n} parameter leaves, template "
                f"{len(template.params)}")
        for i, p in enumerate(template.params):
            if data[f"param_{i}"].shape != tuple(p.shape):
                raise ValueError(
                    f"checkpoint leaf {i} has shape {data[f'param_{i}'].shape}, "
                    f"template {tuple(p.shape)}")
        with torch.no_grad():
            for i, p in enumerate(template.params):
                p.copy_(torch.from_numpy(data[f"param_{i}"]))
        template.opt_state.load_state_dict(
            _unflatten(json.loads(str(data["opt_tree"])), data))
        step = torch.tensor(int(data["step"]), dtype=torch.int32)
    return TrainState(template.params, template.opt_state, step)


class Trainer:
    """Multi-view inverse-rendering trainer (the JAX package's
    ``BASELINE.json`` config 5, the 64-view optimization loop).

    Wraps the train step with parameter state, capacity warnings, periodic
    checkpointing (by rank 0) and resume. ``mesh`` is a
    :class:`~dmesh2_renderer_tpu_torch.parallel.RankMesh`: with an ``"sp"``
    axis (a 2-D ``("dp", "sp")`` mesh, or a 1-D pixel mesh) the step is
    ``make_grid_train_step``, which also shards each view's pixel rows,
    else the view-parallel ``make_sharded_train_step``; both take the same
    arguments. ``optimizer`` builds a ``torch.optim.Optimizer`` from the
    parameter list.
    """

    def __init__(self, mesh: RankMesh, optimizer, faces, width, height,
                 aa_temperature=1.0, config: RasterConfig | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 100):
        self.mesh = mesh
        self.config = config or RasterConfig()
        make_step = (make_grid_train_step if "sp" in mesh.axis_names
                     else make_sharded_train_step)
        self.step_fn = make_step(
            mesh, optimizer, faces, width, height, aa_temperature, self.config)
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = checkpoint_every
        self.last_stats: RenderStats | None = None

    def init_state(self, params: SceneParams) -> TrainState:
        """Leaf copies of ``params`` on the mesh's device, a fresh optimizer
        over them and step 0; restored from the checkpoint when one exists."""
        leaves = SceneParams(*(
            torch.as_tensor(p, dtype=torch.float32, device=self.mesh.device)
            .detach().clone().requires_grad_(True) for p in params))
        state = TrainState(leaves, self.step_fn.init(leaves),
                           torch.zeros((), dtype=torch.int32))
        if self.checkpoint_path and os.path.exists(self.checkpoint_path):
            state = load_checkpoint(self.checkpoint_path, state)
        return state

    def step(self, state: TrainState, faces_intense, mv, proj, target_color,
             background):
        """One optimisation step over every view: (the new state, the loss).

        Under a profiler it is the root range ``dmesh2/train_step``: the
        step function's ranges (the render's, ``loss``, the backward's and
        ``optimizer``) and ``stats``, the capacity check."""
        with span("train_step"):
            params, opt_state, loss, stats = self.step_fn(
                state.params, state.opt_state, faces_intense, mv, proj,
                target_color, background,
            )
            self.last_stats = stats
            if self.config.warn_on_overflow:
                with span("stats"):
                    check_render_stats(stats, self.config)
        state = TrainState(params, opt_state, state.step + 1)
        if (self.checkpoint_path and self.mesh.rank == 0
                and int(state.step) % self.checkpoint_every == 0):
            save_checkpoint(self.checkpoint_path, state)
        return state, loss
