"""The plain reference of one multi-view optimisation step, from a snapshot.

``train_step`` works out, from the scene's own tensors and a snapshot of the
parameters and of Adam's state, the step that ``Trainer.step`` takes there:
projection and the CCW screen triangles of every view, one mean-depth
binning of the whole batch (so the packed keys keep the batch's depth
bits), the record table, the forward compositor, the mean squared colour
error against the targets, its cotangent ``2 (color - target) / N``, the
analytic backward compositor, the reduction, autograd of the projection and
the screen triangles back to the vertices, and an Adam update written from
its formulas (``m_hat / (sqrt(v_hat) + eps)``, not ``torch.optim``).

The compositors run a few views at a time (tiles of different views never
meet, and each view's entries are one contiguous run of the sorted table),
which bounds their (tiles, 256) planes. TF32 is off; ``precision="tf32"``
computes the camera products with TF32 operands instead (the control). It
reads nothing the program made but the snapshot, and imports nothing of
the port.
"""

from __future__ import annotations

import torch

from bench_port.reference.binning import bin_faces, contributing_mask, pack_records
from bench_port.reference.composite import (
    composite_backward, composite_forward, scatter_entry_grads,
)
from bench_port.reference.geometry import face_aa_verts_ccw, face_depth01, init_rays, project
from bench_port.reference.render import _binning_args, _tf32_off

LEAVES = ("verts", "verts_color", "faces_opacity")
# Tiles a pass of the compositors takes at most (whole views).
PASS_TILES = 1 << 15


def _passes(binned, views: int, tiles_per_view: int):
    """(view slice, tile slice, first entry, end entry) of each pass."""
    starts, counts = binned.tile_starts.long(), binned.tile_counts.long()
    per = max(1, PASS_TILES // tiles_per_view)
    for v0 in range(0, views, per):
        v1 = min(views, v0 + per)
        t0, t1 = v0 * tiles_per_view, v1 * tiles_per_view
        e0, e1 = int(starts[t0]), int(starts[t1 - 1] + counts[t1 - 1])
        yield slice(v0, v1), slice(t0, t1), e0, max(e1, e0)


def _add_work(total: dict, part: dict):
    for k, v in part.items():
        total[k] = total.get(k, 0) + int(v)


def adam(param, grad, state, lr: float, betas, eps: float):
    """One Adam update from its formulas; ``state`` (``exp_avg``,
    ``exp_avg_sq``, ``step``: the updates done so far) or None before the
    first."""
    b1, b2 = betas
    m0 = torch.zeros_like(param) if state is None else state["exp_avg"]
    v0 = torch.zeros_like(param) if state is None else state["exp_avg_sq"]
    t = (0 if state is None else int(state["step"])) + 1
    m = b1 * m0 + (1.0 - b1) * grad
    v = b2 * v0 + (1.0 - b2) * grad * grad
    m_hat = m / (1.0 - b1 ** t)
    v_hat = v / (1.0 - b2 ** t)
    return param - lr * m_hat / (torch.sqrt(v_hat) + eps)


def train_step(scene, target, width: int, height: int, tau: float, raster: dict,
               snapshot: dict, optimizer: dict, precision: str = "float32") -> dict:
    """The step from ``snapshot`` (``params`` and ``adam`` by leaf name; a
    leaf without Adam state is before its first update) with the
    configuration's ``optimizer`` (``lr``, ``betas``, ``eps``). Returns
    color (B, H, W, 3), depth in [0, 1], ``num_rendered``,
    ``num_truncated``, ``loss``, ``grads`` and ``params`` (the updated
    leaves) by leaf name, ``lr``, and the compositors' ``work``."""
    _tf32_off()
    p0 = snapshot["params"]
    faces, b = scene.faces, scene.views
    verts = p0["verts"].detach().clone().requires_grad_(True)
    vcolor, opacity = p0["verts_color"].detach(), p0["faces_opacity"].detach()
    with torch.enable_grad():
        ndc, img = project(verts, scene.mv, scene.proj, width, height, precision)
        tris = face_aa_verts_ccw(img, faces)
    with torch.no_grad():
        ray_o, ray_d = init_rays(scene.mv, scene.proj, width, height, precision)
        ray_o_cam = ray_o[:, 0, 0, :].contiguous()
        del ray_o
        ndc_d, tris_d = ndc.detach(), tris.detach()
        depth01, _, _, alive = face_depth01(ndc_d, faces)
        binned = bin_faces(tris_d, depth01, alive, width, height, **_binning_args(raster, True))
        records = pack_records(binned.entry_bf, faces, verts.detach(), vcolor, ndc_d, opacity,
                               scene.faces_intense, tris_d)
        tiles_per_view = binned.tile_counts.shape[0] // b
        passes = list(_passes(binned, b, tiles_per_view))
        fwd_work, fwd = {}, []
        for vs, ts, e0, e1 in passes:
            w = {}
            fwd.append(composite_forward(
                records[e0:e1], binned.tile_starts[ts] - e0, binned.tile_counts[ts],
                ray_o_cam[vs], ray_d[vs], scene.background, width, height, tau, work=w))
            _add_work(fwd_work, w)
        color, depth_raw, final_t, prev_t, _, nc_tile = (torch.cat(x) for x in zip(*fwd))
        del fwd
        diff = color - target
        loss = torch.mean(diff ** 2)
        g_color = (2.0 * diff) * (1.0 / diff.numel())
        del diff
        zero = torch.zeros_like(depth_raw)
        grad_records = torch.zeros_like(records)
        bwd_work = {}
        for vs, ts, e0, e1 in passes:
            w = {}
            grad_records[e0:e1] = composite_backward(
                records[e0:e1], binned.tile_starts[ts] - e0, binned.tile_counts[ts],
                nc_tile[ts], ray_o_cam[vs], ray_d[vs], scene.background, color[vs],
                depth_raw[vs], final_t[vs], prev_t[vs], g_color[vs], zero[vs], zero[vs], width,
                height, tau, work=w)
            _add_work(bwd_work, w)
        n_records = records.shape[0]
        del records, g_color
        keep = contributing_mask(binned.tile_starts, binned.tile_counts, nc_tile, n_records)
        d_verts, d_vcolor, d_op, d_ndc_z, _, d_tris = scatter_entry_grads(
            grad_records, binned.entry_bf, faces, verts.shape[0], b, keep)
        del grad_records
        d_ndc = torch.zeros_like(ndc_d)
        d_ndc[..., 2] = d_ndc_z
    (chain,) = torch.autograd.grad((ndc, tris), verts, (d_ndc, d_tris))
    grads = dict(verts=d_verts + chain, verts_color=d_vcolor, faces_opacity=d_op)
    lr, betas, eps = float(optimizer["lr"]), tuple(optimizer["betas"]), float(optimizer["eps"])
    with torch.no_grad():
        params = {k: adam(p0[k].detach(), grads[k], snapshot["adam"].get(k), lr, betas, eps)
                  for k in LEAVES}
    return dict(color=color, depth=1.0 - (depth_raw + 1.0) / 2.0,
                num_rendered=int(binned.num_rendered), num_truncated=int(binned.num_truncated),
                loss=float(loss), grads=grads, params=params, lr=lr,
                work=dict(forward=fwd_work, backward=bwd_work, records=n_records,
                          tiles=binned.tile_counts.shape[0]))
