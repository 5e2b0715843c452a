"""Camera / projection / screen-space geometry (plain PyTorch).

Port of ``dmesh2_renderer_tpu/geometry.py``: vertex projection, per-pixel
rays, patch ray selection, the CCW screen-triangle precompute,
Moeller-Trumbore and the 7-region barycentric clamp, and the analytic
Jacobians the backward compositor uses (clamp and Moeller-Trumbore). Every
function works on tensors of any device and keeps the JAX package's
layouts, so the tests compare like with like.

The JAX package's hand-written backward of ``face_aa_verts_ccw`` exists only
to avoid an XLA scatter on the TPU; here autograd differentiates the gather
and the CCW swap, which gives the same gradient.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from dmesh2_renderer_tpu_torch.utils.config import AA_EPS, RAY_NORM_EPS, W_EPS
from dmesh2_renderer_tpu_torch.utils.profiling import host_sync


@contextlib.contextmanager
def _full_f32_matmul():
    """Camera products in full float32, never TF32.

    The JAX package pins ``Precision.HIGHEST`` on these einsums: a lower
    precision moves NDC coordinates enough to flip culling and binning
    decisions. PyTorch's default already disables TF32 for float32 matrix
    products on the card; this sets ``torch.backends.cuda.matmul.allow_tf32
    = False`` for the duration so that a caller's global setting cannot
    change the projection, and restores it afterwards.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def compute_verts_ndc_image(verts, mv, proj, width, height):
    """Project vertices to NDC and image (pixel) coordinates.

    Homogeneous transform by mv then proj, clamp ``|w| < 1e-4`` away from
    zero (sign-preserving, w == 0 maps to +eps), divide, and map xy from
    [-1, 1] to pixels.

    Args:
      verts: (P, 3); mv, proj: (B, 4, 4); width, height: image size.
    Returns: verts_ndc (B, P, 3), verts_image (B, P, 2).
    """
    verts_hom = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=-1)
    with _full_f32_matmul():
        verts_view = torch.einsum("pj,bij->bpi", verts_hom, mv)
        verts_proj = torch.einsum("bpj,bij->bpi", verts_view, proj)
    w = verts_proj[..., 3:4]
    w = torch.where((w >= 0.0) & (w < W_EPS), torch.full_like(w, W_EPS), w)
    w = torch.where((w < 0.0) & (w > -W_EPS), torch.full_like(w, -W_EPS), w)
    verts_ndc = verts_proj[..., :3] / w
    # On the card this copies a host list, which waits for the device.
    with host_sync("image_scale"):
        scale = torch.tensor([width, height], dtype=verts_ndc.dtype,
                             device=verts_ndc.device)
    verts_image = (verts_ndc[..., :2] + 1.0) * 0.5 * scale
    return verts_ndc, verts_image


def init_rays(mv, proj, width, height, origin=None, shape=None):
    """Per-pixel world-space camera rays for a batch of cameras.

    Origins are the camera positions (``inv(mv)[:, :3, 3]``); directions go
    through pixel centres (+0.5) unprojected from NDC at the near plane
    (z = -1), divided by w (the JAX package's deliberate fix of the
    reference's undivided ray), and normalized with a +1e-6 length epsilon.
    ``origin=(x0, y0)`` / ``shape=(ph, pw)`` restrict the grid to one window.

    Returns: ray_o, ray_d, each (B, ph, pw, 3).
    """
    b = mv.shape[0]
    ph, pw = shape if shape is not None else (height, width)
    x0, y0 = origin if origin is not None else (0, 0)
    inv_mv = torch.linalg.inv(mv)
    inv_proj = torch.linalg.inv(proj)

    ray_o = inv_mv[:, :3, 3][:, None, None, :].expand(b, ph, pw, 3)

    kw = dict(dtype=mv.dtype, device=mv.device)
    px = (x0 + torch.arange(pw, **kw) + 0.5) / width * 2.0 - 1.0
    py = (y0 + torch.arange(ph, **kw) + 0.5) / height * 2.0 - 1.0
    gx, gy = torch.meshgrid(px, py, indexing="xy")            # (ph, pw)
    ones = torch.ones((ph, pw, 1), **kw)
    pix_ndc_h = torch.cat([gx[..., None], gy[..., None], -ones, ones], dim=-1)
    with _full_f32_matmul():
        pix_view = torch.einsum("hwj,bij->bhwi", pix_ndc_h, inv_proj)
        pix_view = pix_view / pix_view[..., 3:4]
        pix_world = torch.einsum("bhwj,bij->bhwi", pix_view, inv_mv)[..., :3]

    ray_d = pix_world - ray_o
    ray_len = torch.linalg.norm(ray_d, dim=-1, keepdim=True) + RAY_NORM_EPS
    return ray_o, ray_d / ray_len


def select_rays(ray_o, ray_d, batch_idx, patch_min, patch_width, patch_height):
    """Slice per-view patch windows out of full-frame ray maps.

    Args:
      ray_o, ray_d: (Bc, H, W, 3) full-frame rays of the cameras.
      batch_idx: (B,) int indices into the camera axis.
      patch_min: (B, 2) int (x, y) patch origins.
    Returns: (B, ph, pw, 3) sliced ray_o / ray_d.
    """
    dev = ray_d.device
    gy = torch.arange(patch_height, device=dev)[None, :, None]
    gx = torch.arange(patch_width, device=dev)[None, None, :]
    patch_min = patch_min.long()
    y = patch_min[:, 1][:, None, None] + gy
    x = patch_min[:, 0][:, None, None] + gx
    bi = batch_idx.long()[:, None, None]
    return ray_o[bi, y, x], ray_d[bi, y, x]


class Triangles(NamedTuple):
    """Screen-space triangle precompute (CCW ordered)."""

    verts: torch.Tensor           # (..., 3, 2) CCW ordered
    edges: torch.Tensor           # (..., 3, 2) p1-p0, p2-p1, p0-p2
    edges_iszero: torch.Tensor    # (..., 3, 2) bool, |edge component| < 1e-3
    edges_recip: torch.Tensor     # (..., 3, 2) 1/edge (inf where zero)
    edges_normal: torch.Tensor    # (..., 3, 2) inward edge normals
    edges_normal_c: torch.Tensor  # (..., 3) plane offsets


def tri_area2(p0, p1, p2):
    """Twice the signed area (positive for CCW)."""
    return (p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1]) - (
        p2[..., 0] - p0[..., 0]
    ) * (p1[..., 1] - p0[..., 1])


def order_ccw(p0, p1, p2):
    """Swap p1/p2 where the signed area is negative."""
    neg = (tri_area2(p0, p1, p2) < 0.0)[..., None]
    return p0, torch.where(neg, p2, p1), torch.where(neg, p1, p2)


def make_triangles(p0, p1, p2) -> Triangles:
    """Build the CCW triangle precompute."""
    p0, p1, p2 = order_ccw(p0, p1, p2)
    verts = torch.stack([p0, p1, p2], dim=-2)
    edges = torch.stack([p1 - p0, p2 - p1, p0 - p2], dim=-2)
    edges_iszero = torch.abs(edges) < AA_EPS
    edges_recip = 1.0 / edges

    def normal_of(e, p):
        # rotate edge by +90deg: (ex, ey) -> (-ey, ex); inward for CCW.
        n = torch.stack([-e[..., 1], e[..., 0]], dim=-1)
        return n, torch.sum(n * p, dim=-1)

    n0, c0 = normal_of(p1 - p0, p0)
    n1, c1 = normal_of(p2 - p1, p1)
    n2, c2 = normal_of(p0 - p2, p2)
    return Triangles(verts, edges, edges_iszero, edges_recip,
                     torch.stack([n0, n1, n2], dim=-2),
                     torch.stack([c0, c1, c2], dim=-1))


def face_aa_triangles(verts_image, faces) -> Triangles:
    """Per-(batch, face) screen-space triangle precompute.

    Args: verts_image (B, P, 2), faces (F, 3) int.
    Returns: Triangles with leading shape (B, F).
    """
    fv = verts_image[:, faces.long()]                 # (B, F, 3, 2)
    return make_triangles(fv[..., 0, :], fv[..., 1, :], fv[..., 2, :])


def _face_aa_verts_impl(verts_image, faces):
    fv = verts_image[:, faces.long()]                 # (B, F, 3, 2)
    p0, p1, p2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
    neg = tri_area2(p0, p1, p2) < 0.0                 # (B, F)
    q1 = torch.where(neg[..., None], p2, p1)
    q2 = torch.where(neg[..., None], p1, p2)
    return torch.stack([p0, q1, q2], dim=-2), neg


def face_aa_verts_ccw(verts_image, faces):
    """CCW screen-space AA triangles (B, F, 3, 2): the rasterizer input.

    The JAX package's ``face_aa_verts_ccw``; autograd carries its cotangent
    back to ``verts_image`` (un-swapped, summed over incident faces).
    """
    return _face_aa_verts_impl(verts_image, faces)[0]


def ray_tri_intersection(ray_o, ray_d, p0, p1, p2):
    """Moeller-Trumbore, unclamped (t, u, v) + validity.

    ``valid`` is False only when the determinant is exactly zero; (u, v) are
    not required to lie inside the triangle. All args broadcast; the last
    axis is 3. Returns: t, u, v, valid (bool).
    """
    t0 = ray_o - p0
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = torch.linalg.cross(ray_d, e2, dim=-1)
    qvec = torch.linalg.cross(t0, e1, dim=-1)
    denom = torch.sum(pvec * e1, dim=-1)
    valid = denom != 0.0
    inv = 1.0 / torch.where(valid, denom, torch.ones_like(denom))
    t = torch.sum(qvec * e2, dim=-1) * inv
    u = torch.sum(pvec * t0, dim=-1) * inv
    v = torch.sum(qvec * ray_d, dim=-1) * inv
    return t, u, v, valid


def clamp_bary_uv(u, v):
    """Clamp (u, v) barycentrics to the triangle; 7-region code.

    Returns (u_c, v_c, code) with code 0 when (u, v) is already inside. The
    region tests resolve boundaries in this order (inside, 1, ..., 6), so
    the order of the nested selections must not change.
    """
    inside = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    c1 = (u <= 0.0) & (v <= 0.0)
    c2 = ((u >= 1.0) & (v <= 0.0)) | ((v >= 0.0) & (v <= u - 1.0))
    c3 = ((u <= 0.0) & (v >= 1.0)) | ((u >= 0.0) & (v >= u + 1.0))
    c4 = (u <= 0.0) & (v <= 1.0) & (v >= 0.0)
    c5 = (u <= 1.0) & (u >= 0.0) & (v <= 0.0)
    ud = (1.0 + u - v) * 0.5
    vd = (1.0 - u + v) * 0.5

    code = torch.full_like(u, 6, dtype=torch.int32)
    for c, k in ((c5, 5), (c4, 4), (c3, 3), (c2, 2), (c1, 1), (inside, 0)):
        code = torch.where(c, torch.full_like(code, k), code)
    zero = torch.zeros_like(u)
    one = torch.ones_like(u)
    u_sel = (u, zero, one, zero, zero, u, ud)
    v_sel = (v, zero, zero, one, v, zero, vd)
    u_c, v_c = ud, vd
    for k in range(5, -1, -1):
        hit = code == k
        u_c = torch.where(hit, u_sel[k], u_c)
        v_c = torch.where(hit, v_sel[k], v_c)
    return u_c, v_c, code


def clamp_bary_uv_grad(code, dtype=torch.float32):
    """Piecewise-constant Jacobian of the barycentric clamp, by region code.

    Returns (duc_du, duc_dv, dvc_du, dvc_dv): the identity inside (code 0),
    d/dv only on the u = 0 edge (4), d/du only on the v = 0 edge (5), the
    diagonal projection's +-1/2 on the hypotenuse (6), zero at the corners.
    """
    one = torch.ones(code.shape, dtype=dtype, device=code.device)
    zero = torch.zeros_like(one)
    half = 0.5 * one
    duc_du = torch.where((code == 0) | (code == 5), one,
                         torch.where(code == 6, half, zero))
    dvc_dv = torch.where((code == 0) | (code == 4), one,
                         torch.where(code == 6, half, zero))
    duc_dv = torch.where(code == 6, -half, zero)
    dvc_du = torch.where(code == 6, -half, zero)
    return duc_du, duc_dv, dvc_du, dvc_dv


def ray_tri_intersection_uv_grad(ray_o, ray_d, p0, p1, p2):
    """Analytic Jacobians d(u, v)/d(p0, p1, p2) of Moeller-Trumbore.

    ``dv`` is derived from v = dot(cross(t0, e1), d) / denom, the v the
    renderer interpolates with (the JAX package's fix of the CUDA original,
    whose "dv" block differentiates the ray parameter t instead).

    Returns 6 tensors (..., 3): du/dp0, du/dp1, du/dp2, dv/dp0, dv/dp1,
    dv/dp2.
    """
    def cross(a, b):
        return torch.linalg.cross(a, b, dim=-1)

    t0 = ray_o - p0
    e1 = p1 - p0
    e2 = p2 - p0

    rxe2 = cross(ray_d, e2)
    denom_sqrt = torch.sum(rxe2 * e1, dim=-1, keepdim=True)
    denom = denom_sqrt * denom_sqrt
    denom_inv = 1.0 / torch.where(denom == 0.0, torch.ones_like(denom), denom)

    u_num = torch.sum(rxe2 * t0, dim=-1, keepdim=True)
    v1 = denom_sqrt
    qvec = cross(t0, e1)
    v_num = torch.sum(qvec * ray_d, dim=-1, keepdim=True)
    e1xd = cross(e1, ray_d)

    du_de1 = (-rxe2 * u_num) * denom_inv
    du_de2 = (cross(t0, ray_d) * v1 - u_num * e1xd) * denom_inv
    du_dt = (rxe2 * v1) * denom_inv

    dv_de1 = (cross(ray_d, t0) * v1 - v_num * rxe2) * denom_inv
    dv_de2 = (-v_num * e1xd) * denom_inv
    dv_dt = e1xd * v1 * denom_inv

    du_dp0 = -du_de1 - du_de2 - du_dt
    dv_dp0 = -dv_de1 - dv_de2 - dv_dt
    return du_dp0, du_de1, du_de2, dv_dp0, dv_de1, dv_de2
