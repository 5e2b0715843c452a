"""Plain reference compositor (executable spec; slow, obviously correct).

Port of ``dmesh2_renderer_tpu/ops/reference.py``. It renders with exactly
the blending semantics of the tile compositor, but with no binning: every
face is tested against every pixel, in global mean-depth order, one face per
loop step. It is the spec the kernels are held to and the path a caller
selects with ``RasterConfig(use_pallas=False)``.

Semantics:
  * ordering by per-face mean NDC z mapped to [0, 1]
  * culling of faces with max_z < -1 or min_z > 1
  * AA box = unit pixel square at integer image coordinates
  * skip if (tau > 0) and overlap area == 0
  * Moeller-Trumbore + 7-region barycentric clamp
  * alpha = opacity * ((1-tau)*inside + tau*oarea)
  * front-to-back blending while the transmittance before the face is
    >= T_EPS
  * background composited with bg-depth 1.0
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dmesh2_renderer_tpu_torch.aa import tri_box_overlap_area
from dmesh2_renderer_tpu_torch.geometry import clamp_bary_uv, ray_tri_intersection
from dmesh2_renderer_tpu_torch.utils.config import T_EPS


_THIRD = float(torch.tensor(1.0 / 3.0, dtype=torch.float32))


class RenderAux(NamedTuple):
    final_t: torch.Tensor        # (B, H, W)
    final_prev_t: torch.Tensor   # (B, H, W)
    n_contrib: torch.Tensor      # (B, H, W) int32


def face_depth01_from_z(z):
    """Per-(batch, face) mean/min/max NDC z mapped to [0,1], and cull mask.

    From pre-gathered corner depths ``z`` of shape (B, F, 3). Returns
    (depth, min_depth, max_depth, alive) each of shape (B, F).
    """
    # The mean as the sum times the float32 reciprocal of 3: the form XLA
    # evaluates jnp.mean in, so both packages quantize the same sort depth.
    mean_z = (z[..., 0] + z[..., 1] + z[..., 2]) * _THIRD
    min_z = z.amin(dim=-1)
    max_z = z.amax(dim=-1)
    alive = (max_z >= -1.0) & (min_z <= 1.0)

    def to01(d):
        return torch.clamp((d + 1.0) * 0.5, 0.0, 1.0)

    return to01(mean_z), to01(min_z), to01(max_z), alive


def face_depth01(verts_ndc, faces):
    """:func:`face_depth01_from_z` with the corner gather included."""
    return face_depth01_from_z(verts_ndc[:, faces.long(), 2])


def render_reference(
    verts,            # (P, 3)
    faces,            # (F, 3) int
    verts_color,      # (P, 3)
    faces_opacity,    # (F,)
    verts_ndc,        # (B, P, 3)
    faces_intense,    # (B, F)
    aa_face_verts,    # (B, F, 3, 2) CCW screen-space triangles
    background,       # (3,)
    patch_min,        # (B, 2) int
    ray_o,            # (B, H, W, 3)
    ray_d,            # (B, H, W, 3)
    aa_temperature: float,
):
    """Returns (color (B,H,W,3), raw depth (B,H,W), RenderAux)."""
    b, h, w, _ = ray_d.shape
    faces = faces.long()
    dev, dt = ray_d.device, ray_d.dtype

    depth01, _, _, alive = face_depth01(verts_ndc, faces)        # (B, F)
    # Dead faces sort to the end and are masked out of blending.
    sort_key = torch.where(alive, depth01, torch.full_like(depth01, float("inf")))
    order = torch.sort(sort_key, dim=-1, stable=True).indices    # (B, F)

    bi = torch.arange(b, device=dev)[:, None]
    s_fv = verts[faces][order]                                   # (B, F, 3, 3)
    s_fc = verts_color[faces][order]
    s_fz = verts_ndc[:, faces, 2][bi, order]                     # (B, F, 3)
    s_op = faces_opacity[order]                                  # (B, F)
    s_in = faces_intense[bi, order]
    s_aa = aa_face_verts[bi, order]                              # (B, F, 3, 2)
    s_alive = alive[bi, order]

    # Pixel AA boxes in image coordinates (integer corners).
    pm = patch_min.long()
    px = pm[:, 0][:, None, None] + torch.arange(w, device=dev)[None, None, :]
    py = pm[:, 1][:, None, None] + torch.arange(h, device=dev)[None, :, None]
    pxmin = px.expand(b, h, w).to(dt)
    pymin = py.expand(b, h, w).to(dt)

    aa_on = aa_temperature > 0.0
    c_rgb = torch.zeros((b, h, w, 3), dtype=dt, device=dev)
    c_d = torch.zeros((b, h, w), dtype=dt, device=dev)
    t = torch.ones((b, h, w), dtype=dt, device=dev)
    pt = torch.ones((b, h, w), dtype=dt, device=dev)
    last_contrib = torch.zeros((b, h, w), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    for j in range(faces.shape[0]):
        p3, col3, z3 = s_fv[:, j], s_fc[:, j], s_fz[:, j]
        op, intense, aa6, ok = s_op[:, j], s_in[:, j], s_aa[:, j], s_alive[:, j]

        if aa_on:
            oarea = tri_box_overlap_area(
                aa6[:, None, None], pxmin, pxmin + 1.0, pymin, pymin + 1.0
            )
            aa_skip = oarea <= 0.0
        else:
            oarea = torch.zeros((b, h, w), dtype=dt, device=dev)
            aa_skip = torch.zeros((b, h, w), dtype=torch.bool, device=dev)

        # Per-pixel face-bbox rejection: never rejects a true contribution
        # and prunes the backward-ray (t < 0) phantom hits that
        # Moeller-Trumbore admits.
        txmin = aa6[..., 0].amin(dim=-1)[:, None, None]
        txmax = aa6[..., 0].amax(dim=-1)[:, None, None]
        tymin = aa6[..., 1].amin(dim=-1)[:, None, None]
        tymax = aa6[..., 1].amax(dim=-1)[:, None, None]
        bbox_ok = (
            (pxmin + 1.0 >= txmin) & (pxmin <= txmax)
            & (pymin + 1.0 >= tymin) & (pymin <= tymax)
        )

        _, u, v, mt_ok = ray_tri_intersection(
            ray_o, ray_d,
            p3[:, None, None, 0], p3[:, None, None, 1], p3[:, None, None, 2],
        )
        uc, vc, code = clamp_bary_uv(u, v)
        inside = (code == 0).to(dt)
        ratio = (1.0 - aa_temperature) * inside + aa_temperature * oarea

        i0 = 1.0 - uc - vc
        i_c = (
            i0[..., None] * col3[:, None, None, 0]
            + uc[..., None] * col3[:, None, None, 1]
            + vc[..., None] * col3[:, None, None, 2]
        ) * intense[:, None, None, None]
        i_d = (i0 * z3[:, None, None, 0] + uc * z3[:, None, None, 1]
               + vc * z3[:, None, None, 2])

        blend = (
            ok[:, None, None]
            & mt_ok
            & bbox_ok
            & (ratio != 0.0)
            & ~aa_skip
            & (t >= T_EPS)
        )
        alpha = torch.where(blend, op[:, None, None] * ratio, zero)

        c_rgb = c_rgb + i_c * (alpha * t)[..., None]
        c_d = c_d + i_d * alpha * t
        pt = torch.where(blend, t, pt)
        t = t * (1.0 - alpha)
        last_contrib = torch.where(
            blend, torch.full_like(last_contrib, j + 1), last_contrib)

    color = c_rgb + t[..., None] * background[None, None, None, :]
    depth = c_d + t * 1.0
    return color, depth, RenderAux(t, pt, last_contrib)
