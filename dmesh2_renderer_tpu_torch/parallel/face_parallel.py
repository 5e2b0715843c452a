"""Face-list parallelism: depth-slab sharding and the associative ``over``.

Port of ``dmesh2_renderer_tpu/parallel/face_parallel.py``. The view axis
(``data_parallel.py``) stops helping when one frame's face list outgrows a
device; this axis shards the face list itself. Every rank bins and
composites a disjoint slab of faces, and the per-rank partial framebuffers
merge front to back with the associative ``over`` operator

    C = C_a + T_a * C_b        T = T_a * T_b

exact when, per pixel, slab k's faces come before slab k + 1's in the
order one render composites them. Slab k of n owns ranks
``[k * fsub, (k + 1) * fsub)``, ``fsub = ceil(F / n)``, of each view's
stable argsort of the mean depth (dead faces last), padded with a dummy
face of opacity 0. One render sorts a tile's faces by that depth quantized
for its tile grid, then by tier (regular before giant), then by face id, so
where two faces' quantized depths tie the fold can composite them in the
other order: a departure of the JAX package's own slabs from its render,
kept here as it is (``ROADMAP.md`` section 3). Each slab also stops
compositing a pixel when its own transmittance falls below 1e-4, so where
one render stops early (final T < 1e-4) the fold adds the later slabs
times that T.

Gradients: the loss is a function of the combined image, the same on every
rank. Each rank backpropagates its own slab's partials with the cotangents
of the combine; the parameter gradients are then SUMMED over the ranks (the
transpose of the JAX ``shard_map``'s replicated inputs): each slab
contributes a disjoint part of one loss, unlike the view axis, whose ranks
average.

The per-rank bodies (:func:`render_slab`, :func:`slab_cotangents`) take
the slab index and count as arguments, so one process can run every slab
in turn and do the sum the collective would (a card hosts one rank).
"""

from __future__ import annotations

from typing import Callable

import torch

from dmesh2_renderer_tpu_torch import geometry as G
from dmesh2_renderer_tpu_torch.functional import render_partial_unchecked
from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
from dmesh2_renderer_tpu_torch.parallel.data_parallel import (
    RankMesh, SceneParams, _check_axis, _gather_axis, _make_1d, _on,
    _reduce_grads,
)
from dmesh2_renderer_tpu_torch.utils.config import RasterConfig
from dmesh2_renderer_tpu_torch.utils.validate import valence_cache, valence_cap


def make_face_mesh(n_devices: int | None = None, axis: str = "fp",
                   device=None) -> RankMesh:
    """The 1-D mesh of face parallelism: every rank on ``axis``, as
    :func:`~dmesh2_renderer_tpu_torch.parallel.make_view_mesh` builds it (a
    world of one without an initialised process group)."""
    return _make_1d(n_devices, axis, device)


@torch.no_grad()
def depth_slab_order(verts, faces, mv, proj, width: int, height: int):
    """Per-view stable depth ranks: (B, F) int32 face ids sorted by the
    unquantized mean depth, dead faces last (the JAX ``_depth_slab_order``)."""
    verts_ndc, _ = G.compute_verts_ndc_image(verts, mv, proj, width, height)
    depth01, _, _, alive = face_depth01(verts_ndc, faces)
    key = torch.where(alive, depth01, torch.full_like(depth01, float("inf")))
    return torch.argsort(key, dim=-1, stable=True).to(torch.int32)


def render_slab(params: SceneParams, faces, faces_intense, mv, proj, order,
                width: int, height: int, aa_temperature: float,
                config: RasterConfig, k: int, n: int):
    """The per-rank body: slab ``k`` of ``n`` of every view, rendered with a
    zero background, one view at a time (slabs differ per view).

    All tensors on one device; ``order`` from :func:`depth_slab_order`.
    Returns background-free partials (Cn (B, H, W, 3), Dn = depth_raw -
    final_t (B, H, W), T = final_t (B, H, W)), differentiable with respect
    to the parameters, and the summed (num_rendered, num_truncated).
    """
    b, f = faces_intense.shape
    fsub = -(-f // n)
    dev = faces.device
    # Ranks padded up to n * fsub with a dummy face (id F: vertex row
    # (0, 0, 0), opacity 0, intensity 0).
    order = torch.cat([order.long(), torch.full((b, n * fsub - f), f, device=dev,
                                                dtype=torch.long)], dim=1)
    faces_pad = torch.cat([faces, faces.new_zeros((1, 3))])
    fo_pad = torch.cat([params.faces_opacity, params.faces_opacity.new_zeros(1)])
    fi_pad = torch.cat([faces_intense, faces_intense.new_zeros((b, 1))], dim=1)
    slab_ids = order[:, k * fsub:(k + 1) * fsub]
    bg0 = params.verts.new_zeros(3)
    cn, dn, t = [], [], []
    nr = nt = torch.zeros((), dtype=torch.int64, device=dev)
    for view in range(b):
        ids = slab_ids[view]
        color, depth_raw, final_t, aux = render_partial_unchecked(
            params.verts, faces_pad[ids], params.verts_color, fo_pad[ids],
            fi_pad[view, ids][None], mv[view:view + 1], proj[view:view + 1], bg0,
            width, height, aa_temperature, config, device=dev)
        cn.append(color[0])
        dn.append(depth_raw[0] - final_t[0])
        t.append(final_t[0])
        nr = nr + aux.num_rendered
        nt = nt + aux.num_truncated
    return torch.stack(cn), torch.stack(dn), torch.stack(t), nr, nt


def composite_slabs(all_c, all_d, all_t):
    """Fold (n, B, H, W, ...) slab partials front to back."""
    c, d, tt = all_c[0], all_d[0], all_t[0]
    for k in range(1, len(all_c)):
        c = c + tt[..., None] * all_c[k]
        d = d + tt * all_d[k]
        tt = tt * all_t[k]
    return c, d, tt


def slab_cotangents(all_c, all_d, all_t, target_color, background):
    """The mean squared error of the combined image and its cotangents with
    respect to every slab's colour and transmittance partials (the depth
    partials do not reach it). Returns (loss, g_c (n, B, H, W, 3), g_t
    (n, B, H, W))."""
    all_c = all_c.detach().requires_grad_(True)
    all_t = all_t.detach().requires_grad_(True)
    c, _, tt = composite_slabs(all_c, all_d.detach(), all_t)
    color = c + tt[..., None] * background[None, None, None, :]
    loss = torch.mean((color - target_color) ** 2)
    g_c, g_t = torch.autograd.grad(loss, (all_c, all_t))
    return loss.detach(), g_c, g_t


def render_faces_sharded(
    mesh: RankMesh,
    verts, faces, verts_color, faces_opacity, faces_intense,
    mv, proj, background,
    width: int, height: int,
    aa_temperature: float = 1.0,
    config: RasterConfig | None = None,
    axis: str = "fp",
):
    """Render B views with the face list sharded over the mesh's ``axis``.

    ``config.binning_capacity`` applies per rank (each bins ~F/n faces).
    Returns (color (B, H, W, 3), depth (B, H, W) in [0, 1], (num_rendered,
    num_truncated) summed over the slabs), all-gathered on every rank.
    """
    _check_axis(mesh, axis)
    config = config or RasterConfig()
    # The whole face list is checked once; the slabs are not.
    valence_cache.check(faces, valence_cap(config), len(verts))
    faces_t = torch.as_tensor(faces, dtype=torch.int32, device=mesh.device).contiguous()
    params = SceneParams(*(_on(mesh, x) for x in (verts, verts_color, faces_opacity)))
    fi, mv, proj, bg = (_on(mesh, x) for x in (faces_intense, mv, proj, background))
    order = depth_slab_order(params.verts, faces_t, mv, proj, width, height)
    with torch.no_grad():
        cn, dn, t, nr, nt = render_slab(
            params, faces_t, fi, mv, proj, order, width, height,
            float(aa_temperature), config, mesh.coord(axis), mesh.axis_size(axis))
    all_c, all_d, all_t = (torch.stack(_gather_axis(mesh, x, axis)) for x in (cn, dn, t))
    counters = sum(_gather_axis(mesh, torch.stack([nr, nt]), axis))
    c, d, tt = composite_slabs(all_c, all_d, all_t)
    color = c + tt[..., None] * bg[None, None, None, :]
    depth = 1.0 - ((d + tt) + 1.0) / 2.0
    return color, depth, (counters[0], counters[1])


def make_face_sharded_train_step(
    mesh: RankMesh,
    optimizer: Callable,
    faces,
    width: int,
    height: int,
    aa_temperature: float = 1.0,
    config: RasterConfig | None = None,
    axis: str = "fp",
):
    """Build the train step with the face list sharded over ``axis``.

    Each rank renders its depth slab of every view; the slab partials are
    all-gathered and combined into the full image, whose mean squared error
    against the target is the loss on every rank. Each rank backpropagates
    its own partials with the combine's cotangents, and the parameter
    gradients are summed over the ranks before the optimizer step.
    ``optimizer`` builds a ``torch.optim.Optimizer`` from the parameter list
    (``step.init(params)`` calls it).

    Returns step(params, opt_state, faces_intense, mv, proj, target_color,
    background) -> (params, opt_state, loss), the JAX signature (no stats);
    the parameters are leaf tensors updated in place, their ``.grad`` the
    summed gradients.
    """
    _check_axis(mesh, axis)
    config = config or RasterConfig()
    tau = float(aa_temperature)
    faces_t = torch.as_tensor(faces, dtype=torch.int32, device=mesh.device).contiguous()
    k, n = mesh.coord(axis), mesh.axis_size(axis)
    # Ranks off the face axis hold replicas of the same slab sums.
    replicas = mesh.world_size // n

    def step(params: SceneParams, opt_state, faces_intense, mv, proj,
             target_color, background):
        valence_cache.check(faces_t, valence_cap(config), params.verts.shape[0])
        opt_state.zero_grad(set_to_none=True)
        fi, mv, proj, tgt, bg = (_on(mesh, x) for x in (
            faces_intense, mv, proj, target_color, background))
        order = depth_slab_order(params.verts.detach(), faces_t, mv, proj, width,
                                 height)
        cn, dn, t, _, _ = render_slab(params, faces_t, fi, mv, proj, order, width,
                                      height, tau, config, k, n)
        all_c, all_d, all_t = (torch.stack(_gather_axis(mesh, x.detach(), axis))
                               for x in (cn, dn, t))
        loss, g_c, g_t = slab_cotangents(all_c, all_d, all_t, tgt, bg)
        torch.autograd.backward([cn, t], [g_c[k], g_t[k]])
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if mesh.world_size > 1:
            _reduce_grads(mesh, params, replicas)
        opt_state.step()
        return params, opt_state, loss

    step.init = lambda params: optimizer(list(params))
    return step
