"""Plain oracle of one multi-view optimisation step (tests only).

One step of ``train.Trainer`` on a world of one, written out from the
port's plain versions in float32 ``torch``, with no kernel of the port and
no JAX: the forward of all B views in one binning (so the packed sort keys
keep the batch's depth bits), the mean squared colour error against the
targets, its analytic gradients through the plain backward compositor and
the reduction, autograd of the projection and the screen triangles back to
the vertices, and an Adam update written from its formulas. TF32 is off.

Where it departs from the port:

* the binning's emission grid is always ``emission_keys_plain`` (on the
  card the port launches ``csrc/bin_emit.cu``, equal element for element);
  the compositors are their plain versions (the port's kernels on the card);
* the colour cotangent ``2 (color - target) / N`` is written out, where the
  port takes it from autograd of ``torch.mean``: equal up to the rounding of
  the product's order;
* the reduction is this module's own ``index_add_`` sums; the port's are the
  same sums, in another order on the card (atomics);
* Adam is ``p - lr m_hat / (sqrt(v_hat) + eps)`` with ``m_hat = m / (1 -
  beta1^t)`` and ``v_hat = v / (1 - beta2^t)``; ``torch.optim.Adam`` divides
  ``sqrt(v)`` by ``sqrt(1 - beta2^t)`` and scales by ``lr / (1 - beta1^t)``,
  which rounds differently;
* no ranks: the port's view parallelism splits the views and averages the
  gradients, which on one rank is the identity.
"""

from __future__ import annotations

import contextlib

import torch

from dmesh2_renderer_tpu_torch import geometry as G
from dmesh2_renderer_tpu_torch.ops.binning import (
    REC_AA, REC_C, REC_OP, REC_V, REC_Z, SENTINEL, contributing_mask,
    emission_keys_plain, pack_stream_plain,
)
from dmesh2_renderer_tpu_torch.ops.composite_bwd import (
    GRAD_COLUMNS, composite_backward_plain,
)
from dmesh2_renderer_tpu_torch.ops.composite_fwd import composite_forward_plain
from dmesh2_renderer_tpu_torch.ops.reference import face_depth01
from dmesh2_renderer_tpu_torch.utils.config import STREAM_BLOCK, RasterConfig

LEAVES = ("verts", "verts_color", "faces_opacity")


@contextlib.contextmanager
def _tf32_off():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _bin(aa, depth01, alive, patch_min, width, height, config):
    """The binning of ``ops/binning.bin_faces`` on the plain emission grid:
    (entry_bf, tile_starts, tile_counts, num_rendered, num_truncated)."""
    bf = depth01.numel()
    capacity = -(-config.binning_capacity // STREAM_BLOCK) * STREAM_BLOCK
    em = emission_keys_plain(
        aa, depth01, alive, patch_min, width, height, capacity,
        config.max_tiles_per_face, config.num_giant_faces, config.giant_tiles,
        config.exact_tile_cull)
    truncated = (em.num_rendered - em.num_emitted - em.num_culled
                 + torch.clamp(em.num_emitted - capacity, min=0))
    keys, order = torch.sort(em.keys, stable=True)
    keys = keys[:capacity]
    entry_bf = torch.where(keys != SENTINEL, em.payload[order[:capacity]], bf)
    bounds = (torch.arange(em.t_total + 1, dtype=torch.int64, device=keys.device)
              << em.bits_d).to(torch.int32)
    edges = torch.searchsorted(keys, bounds, side="left").to(torch.int32)
    return (entry_bf.to(torch.int32), edges[:-1], edges[1:] - edges[:-1],
            em.num_rendered, truncated)


def _reduce(grad_records, entry_bf, keep, faces, n_verts, b):
    """Contributing gradient records summed per (batch, face), per face
    and onto the vertices: (d_verts, d_verts_color, d_opacity, d_ndc_z
    (B, P), d_aa (B, F, 3, 2))."""
    f = faces.shape[0]
    rows = ((entry_bf < b * f) & keep).nonzero().squeeze(1)
    d_face = grad_records.new_zeros((b * f, GRAD_COLUMNS))
    d_face.index_add_(0, entry_bf[rows].long(), grad_records[rows, :GRAD_COLUMNS])
    d_face = d_face.reshape(b, f, GRAD_COLUMNS)
    d_fsum = d_face.sum(dim=0)
    fl = faces.long()
    d_verts = d_face.new_zeros((n_verts, 3))
    d_vcolor = d_face.new_zeros((n_verts, 3))
    d_ndc_z = d_face.new_zeros((b, n_verts))
    for k in range(3):
        d_verts.index_add_(0, fl[:, k], d_fsum[:, REC_V + 3 * k:REC_V + 3 * k + 3])
        d_vcolor.index_add_(0, fl[:, k], d_fsum[:, REC_C + 3 * k:REC_C + 3 * k + 3])
        d_ndc_z.index_add_(1, fl[:, k], d_face[:, :, REC_Z + k])
    return (d_verts, d_vcolor, d_fsum[:, REC_OP], d_ndc_z,
            d_face[:, :, REC_AA:REC_AA + 6].reshape(b, f, 3, 2))


def adam(param, grad, state, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
    """One Adam update from its formulas. ``state``: ``exp_avg``,
    ``exp_avg_sq`` and ``step`` (the updates done so far), or None before
    the first. Returns (new param, new state)."""
    b1, b2 = betas
    m0 = torch.zeros_like(param) if state is None else state["exp_avg"]
    v0 = torch.zeros_like(param) if state is None else state["exp_avg_sq"]
    t = (0 if state is None else int(state["step"])) + 1
    m = b1 * m0 + (1.0 - b1) * grad
    v = b2 * v0 + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - b1 ** t)
    v_hat = v / (1.0 - b2 ** t)
    return param - lr * m_hat / (torch.sqrt(v_hat) + eps), dict(exp_avg=m, exp_avg_sq=v, step=t)


def train_step(params: dict, faces, faces_intense, mv, proj, target_color, background,
               width: int, height: int, aa_temperature: float = 1.0,
               config: RasterConfig | None = None, adam_state: dict | None = None,
               lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8) -> dict:
    """One step from ``params`` (``verts``, ``verts_color``,
    ``faces_opacity``) and ``adam_state`` (per leaf name, as :func:`adam`
    takes it; None or a missing leaf: before the first update).

    Returns ``color`` (B, H, W, 3), ``depth`` in [0, 1], ``loss``, ``grads``
    and ``params`` (the updated leaves) by leaf name, ``adam_state``, and
    the binning's ``num_rendered`` and ``num_truncated``.
    """
    cfg = config or RasterConfig()
    tau = float(aa_temperature)
    faces = faces.to(torch.int32).contiguous()
    b = mv.shape[0]
    dev = mv.device
    with _tf32_off():
        verts = params["verts"].detach().clone().requires_grad_(True)
        vcolor = params["verts_color"].detach()
        opacity = params["faces_opacity"].detach()
        with torch.enable_grad():
            ndc, image = G.compute_verts_ndc_image(verts, mv, proj, width, height)
            # The plain gather, which autograd differentiates.
            aa = G._face_aa_verts_impl(image, faces)[0]
        with torch.no_grad():
            ray_o, ray_d = G.init_rays(mv, proj, width, height)
            ray_o_cam = ray_o[:, 0, 0, :].contiguous()
            ndc_d, aa_d = ndc.detach(), aa.detach()
            patch_min = torch.zeros((b, 2), dtype=torch.int32, device=dev)
            depth01, _, _, alive = face_depth01(ndc_d, faces)
            entry_bf, starts, counts, rendered, truncated = _bin(
                aa_d, depth01, alive, patch_min, width, height, cfg)
            records = pack_stream_plain(entry_bf, faces, verts.detach(), vcolor, ndc_d,
                                        opacity, faces_intense, aa_d)
            color, depth_raw, final_t, prev_t, _, nc_tile = composite_forward_plain(
                records, starts, counts, ray_o_cam, ray_d, background, patch_min, width,
                height, tau)
            diff = color - target_color
            loss = torch.mean(diff ** 2)
            g_color = (2.0 * diff) * (1.0 / diff.numel())
            zero = torch.zeros_like(depth_raw)
            grad_records = composite_backward_plain(
                records, starts, counts, nc_tile, ray_o_cam, ray_d, background, patch_min,
                color, depth_raw, final_t, prev_t, g_color, zero, zero, width, height, tau)
            keep, _ = contributing_mask(starts, counts, nc_tile, entry_bf.shape[0])
            d_verts, d_vcolor, d_op, d_ndc_z, d_aa = _reduce(
                grad_records, entry_bf, keep, faces, verts.shape[0], b)
            d_ndc = torch.zeros_like(ndc_d)
            d_ndc[..., 2] = d_ndc_z
        (chain,) = torch.autograd.grad((ndc, aa), verts, (d_ndc, d_aa))
        grads = dict(verts=d_verts + chain, verts_color=d_vcolor, faces_opacity=d_op)
        new_params, new_state = {}, {}
        with torch.no_grad():
            for k in LEAVES:
                new_params[k], new_state[k] = adam(
                    params[k].detach(), grads[k], (adam_state or {}).get(k), lr, betas, eps)
    return dict(color=color, depth=1.0 - (depth_raw + 1.0) / 2.0, loss=loss, grads=grads,
                params=new_params, adam_state=new_state, num_rendered=rendered,
                num_truncated=truncated)
