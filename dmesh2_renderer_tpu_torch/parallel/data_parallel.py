"""View parallelism over ``torch.distributed``: each rank renders its views,
the shared scene gradients are averaged over the ranks.

Port of ``dmesh2_renderer_tpu/parallel/data_parallel.py``. The JAX package
shards the B cameras of a batch over a device mesh with ``shard_map`` and
all-reduces the gradients of the shared scene parameters (verts, colours and
opacities are the same for every view). Here a rank of a process group takes
the place of a mesh device, laid out on named axes by :class:`RankMesh`
(the face and pixel axes of ``face_parallel.py`` and ``patch_parallel.py``
use it too): the rank at coordinate c of the view axis renders the
contiguous views ``[c * B / n, (c + 1) * B / n)``, gradients and loss are
averaged with ``all_reduce`` (the JAX ``pmean``), the capacity counters are
max-reduced, and rendered batches are all-gathered, so every rank holds the
(B, ...) arrays the JAX functions return. No parameter state is sharded.
Every collective runs over the whole process group: the JAX reductions all
run over every axis of the mesh, and a gather along one axis keeps the
ranks on it.

A world of one needs no process group: :func:`make_mesh` then describes
the current CUDA device (or the CPU when the caller asks for it) and no
collective runs. Under ``torch.distributed`` the caller initialises the
group (``nccl`` on the cards, ``gloo`` for CPU ranks) with its own address,
world size and rank; nothing here reads a cluster's environment.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from dmesh2_renderer_tpu_torch.functional import generate_layers, render
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.profiling import span
from dmesh2_renderer_tpu_torch.utils.validate import resolve_device


class SceneParams(NamedTuple):
    """Differentiable scene state of the DMesh++ optimization loop."""

    verts: torch.Tensor          # (P, 3)
    verts_color: torch.Tensor    # (P, 3)
    faces_opacity: torch.Tensor  # (F,)


class RenderStats(NamedTuple):
    """Per-step capacity counters, max-reduced over the ranks: entries the
    binning dropped, entries inside some tile's contributing prefix (what
    the JAX package's ``grad_compact_capacity`` must cover) and the
    binning's rect slots, ``num_rendered`` (not in the JAX package's
    stats)."""

    num_truncated: torch.Tensor          # () int64
    num_grad_contributing: torch.Tensor  # () int64
    num_rendered: torch.Tensor           # () int64


@dataclasses.dataclass(frozen=True)
class RankMesh:
    """The ranks of a process group laid out on named axes: the port's
    device mesh.

    ``group`` is None for a world of one without ``torch.distributed``.
    ``dims`` gives the size of each of ``axis_names``; None means one axis
    over the whole world. Rank r has coordinates r in row-major order over
    ``shape``, as ``jax.sharding.Mesh(np.array(devices).reshape(shape),
    axis_names)`` lays out its devices.
    """

    group: object
    rank: int
    world_size: int
    device: torch.device
    axis_names: tuple = ("dp",)
    dims: tuple | None = None

    @property
    def shape(self) -> tuple:
        """The size of each axis, in the order of ``axis_names``."""
        return tuple(self.dims) if self.dims is not None else (self.world_size,)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def coord(self, axis: str, rank: int | None = None) -> int:
        """The coordinate of ``rank`` (this process's by default) on ``axis``."""
        i = self.axis_names.index(axis)
        r = self.rank if rank is None else rank
        for size in self.shape[i + 1:]:
            r //= size
        return r % self.shape[i]

    def axis_ranks(self, axis: str) -> list:
        """The ranks along ``axis`` through this rank, in coordinate order."""
        mine = [self.coord(a) for a in self.axis_names if a != axis]
        return [r for r in range(self.world_size)
                if [self.coord(a, r) for a in self.axis_names if a != axis] == mine]

    def shard(self, n: int, axis: str | None = None) -> slice:
        """This rank's contiguous share of ``n`` views along ``axis`` (the
        mesh's first axis by default)."""
        axis = axis or self.axis_names[0]
        size = self.axis_size(axis)
        if n % size:
            raise ValueError(f"{n} views do not split evenly over {size} ranks")
        k = n // size
        c = self.coord(axis)
        return slice(c * k, (c + 1) * k)


# The 1-D mesh of view parallelism (make_view_mesh) is a RankMesh.
ViewMesh = RankMesh


def make_mesh(shape=None, axis_names=("dp",), device=None) -> RankMesh:
    """Lay the ranks out on named axes.

    Without an initialised ``torch.distributed`` group: a world of one on
    ``device`` (the current CUDA device unless the caller passes
    ``device="cpu"``), every axis of size 1. With one: its world, this
    process's rank, and ``device`` (the current CUDA device by default; an
    ``nccl`` group needs a CUDA device, ``gloo`` serves CPU ranks).
    ``shape`` gives each axis's size and must multiply to the world size;
    None puts the whole world on the one axis of a 1-D mesh.
    """
    axis_names = tuple(axis_names)
    if shape is not None:
        shape = tuple(int(n) for n in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
    elif len(axis_names) != 1:
        raise ValueError(f"a mesh with axes {axis_names} needs a shape")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_available() and dist.is_initialized():
        group, rank, world = dist.group.WORLD, dist.get_rank(), dist.get_world_size()
        if dist.get_backend() == "nccl" and dev.type != "cuda":
            raise ValueError("an nccl group reduces CUDA tensors: pass a CUDA device")
    else:
        group, rank, world = None, 0, 1
    if shape is not None and math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} "
                         f"ranks; the world has {world}")
    return RankMesh(group, rank, world, dev, axis_names, shape)


def _make_1d(n_devices, axis, device) -> RankMesh:
    """A 1-D mesh of the whole world on ``axis``; ``n_devices``, when given,
    must be the world size."""
    mesh = make_mesh(None, (axis,), device)
    if n_devices is not None and n_devices != mesh.world_size:
        raise ValueError(
            f"n_devices={n_devices} needs an initialised torch.distributed "
            "group of that size" if mesh.group is None else
            f"n_devices={n_devices}, but the process group has "
            f"{mesh.world_size} ranks")
    return mesh


def make_view_mesh(n_devices: int | None = None, axis: str = "dp",
                   device=None) -> RankMesh:
    """The 1-D mesh of view parallelism: every rank on ``axis`` (see
    :func:`make_mesh` for the world and the device). ``n_devices``, when
    given, must equal the world size."""
    return _make_1d(n_devices, axis, device)


def _gather_axis(mesh: RankMesh, x: torch.Tensor, axis: str) -> list:
    """``x`` of every rank along ``axis`` through this one, in coordinate
    order (a world all-gather: the ranks off the axis hold replicas)."""
    if mesh.world_size == 1:
        return [x]
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return [parts[r] for r in mesh.axis_ranks(axis)]


def _all_reduce(mesh: RankMesh, x: torch.Tensor, op) -> torch.Tensor:
    if mesh.world_size > 1:
        dist.all_reduce(x, op=op, group=mesh.group)
    return x


def _reduce_grads(mesh: RankMesh, params, divisor: int, extra=None):
    """Sum every parameter's ``.grad`` (and ``extra``, a 0-d tensor) over the
    world in one all-reduce and divide by ``divisor``, in place; returns the
    reduced ``extra``."""
    grads = [p.grad for p in params]
    tail = [] if extra is None else [extra.reshape(1)]
    flat = torch.cat([g.reshape(-1) for g in grads] + tail)
    _all_reduce(mesh, flat, dist.ReduceOp.SUM).div_(divisor)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return None if extra is None else flat[off]


def _on(mesh: RankMesh, x, dtype=torch.float32):
    return torch.as_tensor(x, dtype=dtype, device=mesh.device)


def _check_axis(mesh: RankMesh, axis: str) -> None:
    # The work splits over a named axis of the mesh; name it to be sure.
    if axis not in mesh.axis_names:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh "
                         f"{mesh.axis_names}")


def render_views_sharded(
    mesh: RankMesh,
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
    s = mesh.shard(len(mv), axis)
    color, depth, _aux = render(
        verts, faces, verts_color, faces_opacity, _on(mesh, faces_intense)[s],
        _on(mesh, mv)[s], _on(mesh, proj)[s], background, width, height,
        aa_temperature, config, device=mesh.device)
    return (torch.cat(_gather_axis(mesh, color.detach(), axis)),
            torch.cat(_gather_axis(mesh, depth.detach(), axis)))


def make_sharded_train_step(
    mesh: RankMesh,
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

    Under a profiler the loss opens the range ``dmesh2/loss`` and the
    optimizer's step ``dmesh2/optimizer``; ``zero_grad(set_to_none=True)``
    drops the gradients and launches nothing.
    """
    _check_axis(mesh, axis)
    config = config or RasterConfig()
    tau = float(aa_temperature)
    faces_t = torch.as_tensor(faces, dtype=torch.int32, device=mesh.device)

    def step(params: SceneParams, opt_state, faces_intense, mv, proj,
             target_color, background):
        s = mesh.shard(len(mv), axis)
        opt_state.zero_grad(set_to_none=True)
        color, depth, aux = render(
            params.verts, faces_t, params.verts_color, params.faces_opacity,
            _on(mesh, faces_intense)[s], _on(mesh, mv)[s], _on(mesh, proj)[s],
            _on(mesh, background), width, height, tau, config,
            device=mesh.device)
        with span("loss"):
            loss = torch.mean((color - _on(mesh, target_color)[s]) ** 2)
            if depth_weight:
                loss = loss + depth_weight * torch.mean(depth ** 2)
        loss.backward()
        if mesh.world_size > 1:
            loss_mean = _reduce_grads(mesh, params, mesh.world_size, loss.detach())
        else:
            loss_mean = loss.detach()
        stats = torch.stack([aux.num_truncated, aux.num_grad_contributing,
                             aux.num_rendered])
        stats = _all_reduce(mesh, stats, dist.ReduceOp.MAX)
        with span("optimizer"):
            opt_state.step()
        return params, opt_state, loss_mean, RenderStats(*stats)

    step.init = lambda params: optimizer(list(params))
    return step


def generate_layers_sharded(
    mesh: RankMesh,
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
    s = mesh.shard(len(mv), axis)
    layers, counts, (nr, nt) = generate_layers(
        verts, faces, faces_existence, _on(mesh, mv)[s], _on(mesh, proj)[s],
        width, height, num_layers, config, device=mesh.device)
    totals = sum(_gather_axis(mesh, torch.stack([nr, nt]).to(torch.int64), axis))
    return (torch.cat(_gather_axis(mesh, layers, axis)),
            torch.cat(_gather_axis(mesh, counts, axis)), (totals[0], totals[1]))
