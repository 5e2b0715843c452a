"""Inverse-rendering training loop utilities: step, metrics, checkpointing.

Port of ``dmesh2_renderer_tpu/train.py``: the multi-view train step of
``parallel/data_parallel.py`` (views split over the ranks, shared scene
gradients averaged) with parameter state, capacity warnings, periodic
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
import warnings
from typing import NamedTuple

import numpy as np
import torch

from dmesh2_renderer_tpu_torch.parallel.data_parallel import (
    RenderStats,
    SceneParams,
    ViewMesh,
    make_sharded_train_step,
)
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig


def check_render_stats(stats: RenderStats, config: RasterConfig) -> None:
    """Warn when a step's capacity counters signal truncation.

    The functional-path analogue of ``Renderer.forward``'s warnings, with
    the same wording: binning truncation drops geometry; a contributing
    count above ``grad_compact_capacity`` is harmless here (the port's
    backward reduces every contributing entry) but would make the JAX
    package's backward drop gradient rows with this config. Costs two scalar
    device-to-host reads.
    """
    truncated = int(stats.num_truncated)
    if truncated > 0:
        warnings.warn(
            f"binning truncated {truncated} face instances this step; the "
            "rendered image is missing geometry. Raise "
            "RasterConfig.binning_capacity (or max_tiles_per_face).",
            RuntimeWarning,
            stacklevel=3,
        )
    cap = config.grad_compact_capacity
    if cap and int(stats.num_grad_contributing) > cap:
        warnings.warn(
            f"{int(stats.num_grad_contributing)} entries contribute "
            f"gradients but grad_compact_capacity={cap}. This "
            "backward reduces every contributing entry, so its "
            "gradients stay right; the JAX package's backward would "
            "drop the excess with this config and give wrong "
            "gradients. Raise RasterConfig.grad_compact_capacity to "
            "keep the config portable.",
            RuntimeWarning,
            stacklevel=3,
        )


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

    Wraps the view-parallel train step with parameter state, capacity
    warnings, periodic checkpointing (by rank 0) and resume. ``mesh`` is a
    :class:`~dmesh2_renderer_tpu_torch.parallel.ViewMesh`; ``optimizer``
    builds a ``torch.optim.Optimizer`` from the parameter list.
    """

    def __init__(self, mesh: ViewMesh, optimizer, faces, width, height,
                 aa_temperature=1.0, config: RasterConfig | None = None,
                 checkpoint_path: str | None = None,
                 checkpoint_every: int = 100):
        if "sp" in getattr(mesh, "axis_names", ()):
            raise NotImplementedError(
                "a 2-D (view x pixel-band) mesh is not ported yet: it comes "
                "with the port of parallel/patch_parallel.py; use a 1-D view "
                "mesh (make_view_mesh)")
        self.mesh = mesh
        self.config = config or RasterConfig()
        self.step_fn = make_sharded_train_step(
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
        params, opt_state, loss, stats = self.step_fn(
            state.params, state.opt_state, faces_intense, mv, proj,
            target_color, background,
        )
        self.last_stats = stats
        if self.config.warn_on_overflow:
            check_render_stats(stats, self.config)
        state = TrainState(params, opt_state, state.step + 1)
        if (self.checkpoint_path and self.mesh.rank == 0
                and int(state.step) % self.checkpoint_every == 0):
            save_checkpoint(self.checkpoint_path, state)
        return state, loss
