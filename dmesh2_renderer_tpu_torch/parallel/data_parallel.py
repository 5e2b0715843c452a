"""View parallelism over ``torch.distributed``: each rank renders its views,
the shared scene gradients are averaged over the ranks.

Port of ``dmesh2_renderer_tpu/parallel/data_parallel.py``. The JAX package
shards the B cameras of a batch over a device mesh with ``shard_map`` and
all-reduces the gradients of the shared scene parameters (verts, colours and
opacities are the same for every view). Here a rank of a process group takes
the place of a mesh device: rank r renders the contiguous views
``[r * B / world, (r + 1) * B / world)``, gradients and loss are averaged
with ``all_reduce`` (the JAX ``pmean``), the capacity counters are
max-reduced, and rendered batches are all-gathered, so every rank holds the
(B, ...) arrays the JAX functions return. No parameter state is sharded.

A world of one needs no process group: :func:`make_view_mesh` then describes
the current CUDA device (or the CPU when the caller asks for it) and no
collective runs. Under ``torch.distributed`` the caller initialises the
group (``nccl`` on the cards, ``gloo`` for CPU ranks) with its own address,
world size and rank; nothing here reads a cluster's environment.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from dmesh2_renderer_tpu_torch.functional import generate_layers, render
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.validate import resolve_device


class SceneParams(NamedTuple):
    """Differentiable scene state of the DMesh++ optimization loop."""

    verts: torch.Tensor          # (P, 3)
    verts_color: torch.Tensor    # (P, 3)
    faces_opacity: torch.Tensor  # (F,)


class RenderStats(NamedTuple):
    """Per-step capacity counters, max-reduced over the ranks: entries the
    binning dropped, and entries inside some tile's contributing prefix
    (what the JAX package's ``grad_compact_capacity`` must cover)."""

    num_truncated: torch.Tensor          # () int64
    num_grad_contributing: torch.Tensor  # () int64


@dataclasses.dataclass(frozen=True)
class ViewMesh:
    """The ranks that share a batch of views: the port's 1-D mesh.

    ``group`` is None for a world of one without ``torch.distributed``.
    """

    group: object
    rank: int
    world_size: int
    device: torch.device
    axis_names: tuple = ("dp",)

    def shard(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` views."""
        if n % self.world_size:
            raise ValueError(
                f"{n} views do not split evenly over {self.world_size} ranks")
        k = n // self.world_size
        return slice(self.rank * k, (self.rank + 1) * k)


def make_view_mesh(n_devices: int | None = None, axis: str = "dp",
                   device=None) -> ViewMesh:
    """Describe the ranks that render one batch.

    Without an initialised ``torch.distributed`` group: a world of one on
    ``device`` (the current CUDA device unless the caller passes
    ``device="cpu"``). With one: its world, this process's rank, and
    ``device`` (the current CUDA device by default; an ``nccl`` group needs a
    CUDA device, ``gloo`` serves CPU ranks). ``n_devices``, when given, must
    equal the world size.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(
                f"n_devices={n_devices} needs an initialised torch.distributed "
                "group of that size")
        return ViewMesh(None, 0, 1, dev, (axis,))
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{world} ranks")
    if dist.get_backend() == "nccl" and dev.type != "cuda":
        raise ValueError("an nccl group reduces CUDA tensors: pass a CUDA device")
    return ViewMesh(dist.group.WORLD, dist.get_rank(), world, dev, (axis,))


def _all_gather(mesh: ViewMesh, x: torch.Tensor) -> torch.Tensor:
    if mesh.world_size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=0)


def _all_reduce(mesh: ViewMesh, x: torch.Tensor, op) -> torch.Tensor:
    if mesh.world_size > 1:
        dist.all_reduce(x, op=op, group=mesh.group)
    return x


def _on(mesh: ViewMesh, x, dtype=torch.float32):
    return torch.as_tensor(x, dtype=dtype, device=mesh.device)


def _check_axis(mesh: ViewMesh, axis: str) -> None:
    # The views split over the mesh's one axis; name it to be sure.
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh "
                         f"{mesh.axis_names}")


def render_views_sharded(
    mesh: ViewMesh,
    verts, faces, verts_color, faces_opacity, faces_intense,
    mv, proj, background,
    width: int, height: int,
    aa_temperature: float = 1.0,
    config: RasterConfig | None = None,
    axis: str = "dp",
):
    """Render B views split over the mesh's ranks.

    Returns (color (B, H, W, 3), depth (B, H, W)), all-gathered: every rank
    holds the whole batch. B must split evenly over the ranks, along
    ``axis``, which must name the mesh's axis.
    """
    _check_axis(mesh, axis)
    config = config or RasterConfig()
    s = mesh.shard(len(mv))
    color, depth, _aux = render(
        verts, faces, verts_color, faces_opacity, _on(mesh, faces_intense)[s],
        _on(mesh, mv)[s], _on(mesh, proj)[s], background, width, height,
        aa_temperature, config, device=mesh.device)
    return _all_gather(mesh, color.detach()), _all_gather(mesh, depth.detach())


def make_sharded_train_step(
    mesh: ViewMesh,
    optimizer: Callable,
    faces,
    width: int,
    height: int,
    aa_temperature: float = 1.0,
    config: RasterConfig | None = None,
    axis: str = "dp",
    depth_weight: float = 0.0,
):
    """Build the multi-view inverse-rendering train step.

    Views (cameras, target images and per-view intensities) are split over
    the ranks; the scene parameters are replicated. Each rank's loss is the
    mean squared colour error over its views (plus ``depth_weight`` times
    the mean squared depth); loss and gradients are averaged over the ranks
    before the optimizer step, so every rank applies the same update.

    ``optimizer`` builds a ``torch.optim.Optimizer`` from a parameter list
    (e.g. ``functools.partial(torch.optim.Adam, lr=1e-2)``); ``step.init``
    calls it, as optax's ``init`` does, and the optimizer it builds is the
    step's ``opt_state``. ``axis`` must name the mesh's axis.

    Returns step(params: SceneParams, opt_state, faces_intense, mv, proj,
    target_color, background) -> (params, opt_state, loss, stats): the
    parameters are leaf tensors updated in place (their ``.grad`` keeps the
    averaged gradients), ``loss`` the averaged loss and ``stats`` the
    :class:`RenderStats` max-reduced over the ranks. The full-batch inputs
    are given to every rank. ``step.init(params)`` returns the optimizer
    over ``params`` (leaf tensors on the mesh's device).
    """
    _check_axis(mesh, axis)
    config = config or RasterConfig()
    tau = float(aa_temperature)
    faces_t = torch.as_tensor(faces, dtype=torch.int32, device=mesh.device)

    def step(params: SceneParams, opt_state, faces_intense, mv, proj,
             target_color, background):
        s = mesh.shard(len(mv))
        opt_state.zero_grad(set_to_none=True)
        color, depth, aux = render(
            params.verts, faces_t, params.verts_color, params.faces_opacity,
            _on(mesh, faces_intense)[s], _on(mesh, mv)[s], _on(mesh, proj)[s],
            _on(mesh, background), width, height, tau, config,
            device=mesh.device)
        loss = torch.mean((color - _on(mesh, target_color)[s]) ** 2)
        if depth_weight:
            loss = loss + depth_weight * torch.mean(depth ** 2)
        loss.backward()
        if mesh.world_size > 1:
            grads = [p.grad for p in params]
            flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
            _all_reduce(mesh, flat, dist.ReduceOp.SUM).div_(mesh.world_size)
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
            loss_mean = flat[-1]
        else:
            loss_mean = loss.detach()
        stats = torch.stack([aux.num_truncated, aux.num_grad_contributing])
        stats = _all_reduce(mesh, stats, dist.ReduceOp.MAX)
        opt_state.step()
        return params, opt_state, loss_mean, RenderStats(stats[0], stats[1])

    step.init = lambda params: optimizer(list(params))
    return step


def generate_layers_sharded(
    mesh: ViewMesh,
    verts, faces, faces_existence,
    mv, proj,
    width: int, height: int,
    num_layers: int,
    config: RasterConfig | None = None,
    axis: str = "dp",
):
    """Depth-peel B views split over the mesh's ranks.

    The peel is per-view independent, so the split is exact. Returns
    (layers (B, H, W, L) int32, counts (B, H, W) int32, (num_rendered,
    num_truncated) summed over the ranks), all-gathered on every rank.
    ``axis`` must name the mesh's axis.
    """
    _check_axis(mesh, axis)
    config = config or RasterConfig()
    s = mesh.shard(len(mv))
    layers, counts, (nr, nt) = generate_layers(
        verts, faces, faces_existence, _on(mesh, mv)[s], _on(mesh, proj)[s],
        width, height, num_layers, config, device=mesh.device)
    totals = _all_reduce(mesh, torch.stack([nr, nt]).to(torch.int64),
                         dist.ReduceOp.SUM)
    return (_all_gather(mesh, layers), _all_gather(mesh, counts),
            (totals[0], totals[1]))
