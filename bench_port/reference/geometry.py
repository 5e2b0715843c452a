"""Camera, projection and screen-space geometry of the plain reference.

A frozen copy of the renderer's geometry (vertex projection, per-pixel
rays, the CCW screen triangles, the barycentric clamp and its Jacobian,
the per-face depth and cull), in plain PyTorch. It keeps the JAX package's
departures from the CUDA original, which are the spec: rays are divided by
w before they are normalised.

``precision`` selects how the camera products are computed: ``"float32"``
(TF32 off, the configuration's precision) or ``"tf32"``, the control, whose
operands are rounded to TF32's 10-bit mantissa before a float32 product,
as the card's TF32 tensor cores round them. The rounding is done here, so
the control reads the same on a CPU as on the card.
"""

from __future__ import annotations

import torch

AA_EPS = 1e-3
W_EPS = 1e-4
RAY_NORM_EPS = 1e-6
PRECISIONS = ("float32", "tf32")

_THIRD = float(torch.tensor(1.0 / 3.0, dtype=torch.float32))


def round_tf32(x):
    """``x`` (float32) rounded to nearest, ties to even, at TF32's 10
    mantissa bits; infinities and NaNs pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) >> 13) << 13
    finite = torch.isfinite(x)
    return torch.where(finite, rounded.view(torch.float32), x)


def matmul_einsum(eq, a, b, precision: str):
    """``torch.einsum(eq, a, b)`` with TF32 off, its operands rounded to
    TF32 first when ``precision == "tf32"``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.einsum(eq, a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def project(verts, mv, proj, width: int, height: int, precision: str = "float32"):
    """Vertices to NDC (B, P, 3) and image coordinates (B, P, 2): mv then
    proj, ``|w| < 1e-4`` clamped away from zero keeping its sign (0 -> +eps),
    divide, xy from [-1, 1] to pixels."""
    verts_hom = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=-1)
    verts_view = matmul_einsum("pj,bij->bpi", verts_hom, mv, precision)
    verts_proj = matmul_einsum("bpj,bij->bpi", verts_view, proj, precision)
    w = verts_proj[..., 3:4]
    w = torch.where((w >= 0.0) & (w < W_EPS), torch.full_like(w, W_EPS), w)
    w = torch.where((w < 0.0) & (w > -W_EPS), torch.full_like(w, -W_EPS), w)
    verts_ndc = verts_proj[..., :3] / w
    scale = torch.tensor([width, height], dtype=verts_ndc.dtype, device=verts_ndc.device)
    return verts_ndc, (verts_ndc[..., :2] + 1.0) * 0.5 * scale


def init_rays(mv, proj, width: int, height: int, precision: str = "float32"):
    """Per-pixel world rays (B, H, W, 3) through pixel centres, unprojected
    at the near plane, divided by w and normalised with a +1e-6 length."""
    b = mv.shape[0]
    inv_mv = torch.linalg.inv(mv)
    inv_proj = torch.linalg.inv(proj)
    ray_o = inv_mv[:, :3, 3][:, None, None, :].expand(b, height, width, 3)
    kw = dict(dtype=mv.dtype, device=mv.device)
    px = (torch.arange(width, **kw) + 0.5) / width * 2.0 - 1.0
    py = (torch.arange(height, **kw) + 0.5) / height * 2.0 - 1.0
    gx, gy = torch.meshgrid(px, py, indexing="xy")
    ones = torch.ones((height, width, 1), **kw)
    pix_ndc_h = torch.cat([gx[..., None], gy[..., None], -ones, ones], dim=-1)
    pix_view = matmul_einsum("hwj,bij->bhwi", pix_ndc_h, inv_proj, precision)
    pix_view = pix_view / pix_view[..., 3:4]
    pix_world = matmul_einsum("bhwj,bij->bhwi", pix_view, inv_mv, precision)[..., :3]
    ray_d = pix_world - ray_o
    ray_len = torch.linalg.norm(ray_d, dim=-1, keepdim=True) + RAY_NORM_EPS
    return ray_o, ray_d / ray_len


def tri_area2(p0, p1, p2):
    """Twice the signed area (positive for CCW)."""
    return ((p1[..., 0] - p0[..., 0]) * (p2[..., 1] - p0[..., 1])
            - (p2[..., 0] - p0[..., 0]) * (p1[..., 1] - p0[..., 1]))


def face_aa_verts_ccw(verts_image, faces):
    """CCW screen triangles (B, F, 3, 2): p1 and p2 swapped where the signed
    area is negative."""
    fv = verts_image[:, faces.long()]
    p0, p1, p2 = fv[..., 0, :], fv[..., 1, :], fv[..., 2, :]
    neg = (tri_area2(p0, p1, p2) < 0.0)[..., None]
    return torch.stack([p0, torch.where(neg, p2, p1), torch.where(neg, p1, p2)], dim=-2)


def face_depth01(verts_ndc, faces):
    """Per-(batch, face) mean, min and max NDC z mapped to [0, 1], and the
    cull mask (max_z >= -1 and min_z <= 1). The mean is the sum times the
    float32 reciprocal of 3."""
    z = verts_ndc[:, faces.long(), 2]
    mean_z = (z[..., 0] + z[..., 1] + z[..., 2]) * _THIRD
    min_z, max_z = z.amin(dim=-1), z.amax(dim=-1)
    alive = (max_z >= -1.0) & (min_z <= 1.0)

    def to01(d):
        return torch.clamp((d + 1.0) * 0.5, 0.0, 1.0)

    return to01(mean_z), to01(min_z), to01(max_z), alive


def clamp_bary_uv(u, v):
    """(u, v) clamped to the triangle and the 7-region code (0 inside);
    the regions are resolved in the order inside, 1, ..., 6."""
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
    zero, one = torch.zeros_like(u), torch.ones_like(u)
    u_sel = (u, zero, one, zero, zero, u, ud)
    v_sel = (v, zero, zero, one, v, zero, vd)
    u_c, v_c = ud, vd
    for k in range(5, -1, -1):
        hit = code == k
        u_c = torch.where(hit, u_sel[k], u_c)
        v_c = torch.where(hit, v_sel[k], v_c)
    return u_c, v_c, code


def clamp_bary_uv_grad(code):
    """The clamp's piecewise-constant Jacobian (duc_du, duc_dv, dvc_du,
    dvc_dv) by region code."""
    one = torch.ones(code.shape, dtype=torch.float32, device=code.device)
    zero = torch.zeros_like(one)
    half = 0.5 * one
    duc_du = torch.where((code == 0) | (code == 5), one, torch.where(code == 6, half, zero))
    dvc_dv = torch.where((code == 0) | (code == 4), one, torch.where(code == 6, half, zero))
    duc_dv = torch.where(code == 6, -half, zero)
    dvc_du = torch.where(code == 6, -half, zero)
    return duc_du, duc_dv, dvc_du, dvc_dv
