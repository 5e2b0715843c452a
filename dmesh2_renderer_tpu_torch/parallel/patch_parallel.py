"""Pixel parallelism: each rank renders a horizontal band of every view.

Port of ``dmesh2_renderer_tpu/parallel/patch_parallel.py``, the third
scaling axis beside views and faces: band k of n is the ``render_partial``
window of rows ``[k * H / n, (k + 1) * H / n)``, binned and composited on
its own (faces outside the band cull at binning), with no compositing
across ranks. The stitched frame is the one-process render wherever the
band composites a pixel's faces in the render's order. It need not at
depth ties, as in the JAX package (``ROADMAP.md`` section 3): a band's
smaller tile grid quantizes depth more finely, and a band tiles a face's
rows from its own origin, which can move the face's tiles between the
binning's regular and giant tiers (and, with the exact tile cull, keep a
face that only grazes a pixel in one tiling and not the other).
``make_grid_train_step`` composes it with the view axis on a 2-D
``("dp", "sp")`` mesh: the rank at (i, k) renders band k of view shard i;
loss and gradients are averaged over every rank (the JAX ``pmean`` over
both axes) and the capacity counters max-reduced.

``config.binning_capacity`` applies per band. The per-rank bodies
(:func:`render_band`, :func:`band_loss`) take the band index and count as
arguments, so one process can run every band in turn (a card hosts one
rank).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from dmesh2_renderer_tpu_torch.functional import render_partial_unchecked
from dmesh2_renderer_tpu_torch.parallel.data_parallel import (
    RankMesh, RenderStats, SceneParams, _all_reduce, _check_axis, _gather_axis,
    _make_1d, _on, _reduce_grads,
)
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.profiling import span
from dmesh2_renderer_tpu_torch.utils.validate import valence_cache, valence_cap


def make_pixel_mesh(n_devices: int | None = None, axis: str = "sp",
                    device=None) -> RankMesh:
    """The 1-D mesh of pixel parallelism: every rank on ``axis``, as
    :func:`~dmesh2_renderer_tpu_torch.parallel.make_view_mesh` builds it (a
    world of one without an initialised process group)."""
    return _make_1d(n_devices, axis, device)


def _band(height: int, n: int) -> int:
    if height % n:
        raise ValueError(
            f"height {height} must divide evenly into {n} bands; pad the "
            "frame or choose a band-aligned height"
        )
    return height // n


def render_band(verts, faces, verts_color, faces_opacity, faces_intense, mv,
                proj, background, width: int, height: int,
                aa_temperature: float, config: RasterConfig, k: int, n: int,
                device=None):
    """The per-rank body: band ``k`` of ``n`` of every view, as
    ``render_partial``'s (color, depth_raw, final_t, aux) of that window.
    ``faces`` is not checked here: the entry points check it once."""
    band = _band(height, n)
    return render_partial_unchecked(
        verts, faces, verts_color, faces_opacity, faces_intense, mv, proj,
        background, width, height, aa_temperature, config,
        patch_origin=(0, k * band), patch_shape=(band, width), device=device)


def render_pixels_sharded(
    mesh: RankMesh,
    verts, faces, verts_color, faces_opacity, faces_intense,
    mv, proj, background,
    width: int, height: int,
    aa_temperature: float = 1.0,
    config: RasterConfig | None = None,
    axis: str = "sp",
):
    """Render B views with the pixel rows sharded over the mesh's ``axis``.

    Returns (color (B, H, W, 3), depth (B, H, W) in [0, 1], stats:
    :class:`RenderStats` max-reduced over the bands), the bands all-gathered
    and stitched on every rank (the module docstring says where the frame
    can depart from the one-process render).
    """
    _check_axis(mesh, axis)
    config = config or RasterConfig()
    n = mesh.axis_size(axis)
    _band(height, n)
    valence_cache.check(faces, valence_cap(config), len(verts))
    with torch.no_grad():
        color, depth_raw, _final_t, aux = render_band(
            verts, faces, verts_color, faces_opacity, faces_intense, mv, proj,
            background, width, height, aa_temperature, config, mesh.coord(axis),
            n, device=mesh.device)
    depth = 1.0 - (depth_raw + 1.0) / 2.0
    stats = torch.stack(_gather_axis(mesh, torch.stack(
        [aux.num_truncated, aux.num_grad_contributing, aux.num_rendered]),
        axis)).amax(dim=0)
    return (torch.cat(_gather_axis(mesh, color, axis), dim=1),
            torch.cat(_gather_axis(mesh, depth, axis), dim=1),
            RenderStats(*stats))


def band_loss(params: SceneParams, faces, faces_intense, mv, proj,
              target_color, background, width: int, height: int,
              aa_temperature: float, config: RasterConfig, k: int, n: int,
              depth_weight: float = 0.0):
    """The per-rank loss of the grid step: band ``k`` of ``n`` of the given
    views, against ``target_color``, that band's rows of those views. Returns
    (mean squared colour error plus ``depth_weight`` times the mean squared
    depth, differentiable; stats (num_truncated, num_grad_contributing,
    num_rendered))."""
    color, depth_raw, _final_t, aux = render_band(
        params.verts, faces, params.verts_color, params.faces_opacity,
        faces_intense, mv, proj, background, width, height, aa_temperature,
        config, k, n, device=faces.device)
    # Equal-sized shards: the mean over ranks of the local means is the
    # global mean.
    with span("loss"):
        loss = torch.mean((color - target_color) ** 2)
        if depth_weight:
            depth = 1.0 - (depth_raw + 1.0) / 2.0
            loss = loss + depth_weight * torch.mean(depth ** 2)
    return loss, torch.stack([aux.num_truncated, aux.num_grad_contributing,
                              aux.num_rendered])


def make_grid_train_step(
    mesh: RankMesh,
    optimizer: Callable,
    faces,
    width: int,
    height: int,
    aa_temperature: float = 1.0,
    config: RasterConfig | None = None,
    view_axis: str = "dp",
    pixel_axis: str = "sp",
    depth_weight: float = 0.0,
):
    """Build the train step over a (view x pixel-band) mesh.

    Views split over ``view_axis``, each view's pixel rows over
    ``pixel_axis``: the rank at (i, k) renders band k of view shard i
    against the same rows of its targets. Loss and gradients are averaged
    over every rank, the stats max-reduced, so every rank applies the same
    update. A mesh of shape (n, 1) is view parallelism; a 1-D mesh that has
    only ``pixel_axis`` (:func:`make_pixel_mesh`) replicates the views and
    shards the bands. ``optimizer`` builds a ``torch.optim.Optimizer`` from
    the parameter list (``step.init(params)`` calls it).

    Returns step(params, opt_state, faces_intense, mv, proj, target_color,
    background) -> (params, opt_state, loss, stats: RenderStats); the full
    batch is given to every rank. Its ranges are
    :func:`~dmesh2_renderer_tpu_torch.parallel.make_sharded_train_step`'s.
    """
    config = config or RasterConfig()
    if pixel_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh axes {mesh.axis_names} lack pixel axis {pixel_axis!r}"
        )
    has_views = view_axis in mesh.axis_names
    n_px = mesh.axis_size(pixel_axis)
    band = _band(height, n_px)
    k = mesh.coord(pixel_axis)
    rows = slice(k * band, (k + 1) * band)
    tau = float(aa_temperature)
    faces_t = torch.as_tensor(faces, dtype=torch.int32, device=mesh.device).contiguous()

    def step(params: SceneParams, opt_state, faces_intense, mv, proj,
             target_color, background):
        valence_cache.check(faces_t, valence_cap(config), params.verts.shape[0])
        s = mesh.shard(len(mv), view_axis) if has_views else slice(None)
        opt_state.zero_grad(set_to_none=True)
        loss, stats = band_loss(
            params, faces_t, _on(mesh, faces_intense)[s], _on(mesh, mv)[s],
            _on(mesh, proj)[s], _on(mesh, target_color)[s, rows],
            _on(mesh, background), width, height, tau, config, k, n_px,
            depth_weight)
        loss.backward()
        if mesh.world_size > 1:
            loss = _reduce_grads(mesh, params, mesh.world_size, loss.detach())
        stats = _all_reduce(mesh, stats, dist.ReduceOp.MAX)
        with span("optimizer"):
            opt_state.step()
        return params, opt_state, loss.detach(), RenderStats(*stats)

    step.init = lambda params: optimizer(list(params))
    return step
