"""Analytic anti-aliasing: exact triangle-pixel overlap area (forward).

Port of the area half of ``dmesh2_renderer_tpu/aa.py``. For a CCW triangle
and an axis-aligned box, the overlap area is the sum over the three directed
edges of ``dy * Int clamp(x_e(y) - x0, 0, x1 - x0) dt`` over the edge's part
inside the box's y-slab (the winding-number decomposition), evaluated in a
numerically bounded closed form. The CUDA compositor
(``csrc/composite_fwd.cu``) evaluates the same expressions in the same
order; the gradient half comes with the port's backward pass.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _as_planes(like, *xs):
    return [torch.as_tensor(x, dtype=like.dtype, device=like.device) for x in xs]


def _edge_area(xa, ya, xb, yb, x0, x1, y0, y1):
    """Signed area contribution of one directed edge (a -> b).

    Computes dy * Int_{t in yslab ^ [0,1]} clamp(xa + t*dx - x0, 0, x1-x0) dt
    with every intermediate clamped into [0, x1-x0] times a sub-interval of
    [0, 1], so faraway or huge triangles cannot leave cancellation residue
    (the textbook relu^2 form leaks ~eps*coord^2 of phantom coverage).
    """
    dx = xb - xa
    dy = yb - ya
    dy_safe = torch.where(
        torch.abs(dy) > _EPS, dy,
        torch.where(dy >= 0, torch.full_like(dy, _EPS), torch.full_like(dy, -_EPS)),
    )
    rcp_dy = 1.0 / dy_safe
    # y-slab [y0, y1] in edge parameter t (p = a + t*(b-a)).
    ts0 = (y0 - ya) * rcp_dy
    ts1 = ts0 + (y1 - y0) * rcp_dy
    ta = torch.clamp(torch.minimum(ts0, ts1), 0.0, 1.0)
    tb = torch.clamp(torch.maximum(ts0, ts1), 0.0, 1.0)
    tb = torch.maximum(ta, tb)

    k = xa - x0
    w = x1 - x0
    big = torch.abs(dx) > _EPS
    rcp_dx = 1.0 / torch.where(big, dx, torch.ones_like(dx))
    # crossing parameters where the clamped linear hits 0 and w
    tc0 = -k * rcp_dx
    tc1 = tc0 + w * rcp_dx
    lo = torch.clamp(torch.minimum(tc0, tc1), ta, tb)
    hi = torch.clamp(torch.maximum(tc0, tc1), ta, tb)
    zero = torch.zeros_like(w)
    vlo = torch.clamp(k + lo * dx, zero, w)
    vhi = torch.clamp(k + hi * dx, zero, w)
    vleft = torch.clamp(k + ta * dx, zero, w)
    vright = torch.clamp(k + tb * dx, zero, w)
    integral = (
        vleft * (lo - ta) + 0.5 * (vlo + vhi) * (hi - lo) + vright * (tb - hi)
    )
    flat = torch.clamp(k, zero, w) * (tb - ta)
    return dy * torch.where(big, integral, flat)


def tri_box_overlap_area(tri, x0, x1, y0, y1):
    """Exact overlap area of CCW triangles with axis-aligned boxes.

    Args:
      tri: (..., 3, 2) CCW-ordered screen-space triangle vertices.
      x0, x1, y0, y1: box bounds (tensors), broadcastable against
        ``tri[..., 0, 0]``.
    Returns: (...,) overlap area, clamped into [0, box area].
    """
    x0, x1, y0, y1 = _as_planes(tri, x0, x1, y0, y1)
    area = 0.0
    for e in range(3):
        a = tri[..., e, :]
        b = tri[..., (e + 1) % 3, :]
        area = area + _edge_area(a[..., 0], a[..., 1], b[..., 0], b[..., 1],
                                 x0, x1, y0, y1)
    box = (x1 - x0) * (y1 - y0)
    return torch.clamp(area, torch.zeros_like(box), box)


def tri_box_overlap_area_xy(x0c, y0c, x1c, y1c, x2c, y2c, bx0, bx1, by0, by1):
    """Coordinate-plane variant of :func:`tri_box_overlap_area`.

    Takes the six vertex coordinates as separate broadcastable tensors
    (faces as (C, 1) columns against (1, N) pixel planes).
    """
    bx0, bx1, by0, by1 = _as_planes(x0c, bx0, bx1, by0, by1)
    area = (
        _edge_area(x0c, y0c, x1c, y1c, bx0, bx1, by0, by1)
        + _edge_area(x1c, y1c, x2c, y2c, bx0, bx1, by0, by1)
        + _edge_area(x2c, y2c, x0c, y0c, bx0, bx1, by0, by1)
    )
    box = (bx1 - bx0) * (by1 - by0)
    return torch.clamp(area, torch.zeros_like(box), box)
