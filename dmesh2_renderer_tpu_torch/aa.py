"""Analytic anti-aliasing: exact triangle-pixel overlap area and gradient.

Port of ``dmesh2_renderer_tpu/aa.py``. For a CCW triangle and an
axis-aligned box, the overlap area is the sum over the three directed edges
of ``dy * Int clamp(x_e(y) - x0, 0, x1 - x0) dt`` over the edge's part
inside the box's y-slab (the winding-number decomposition), evaluated in a
numerically bounded closed form. Its gradient is the shape derivative: per
edge, the outward normal times two weights of the edge's Liang-Barsky clip
interval. The CUDA compositors (``csrc/pair_math.cuh``) evaluate the same
expressions in the same order.
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


def _edge_clip_interval(xa, ya, xb, yb, x0, x1, y0, y1):
    """Liang-Barsky t-interval [t0, t1] of segment a -> b inside the box.

    An axis along which the edge does not move (|d| <= 1e-12) gives the slab
    (-inf, inf) when the edge lies inside it and (inf, -inf) otherwise; the
    clip to [0, 1] then turns those into the full or the empty interval.
    """
    def slab(pa, pb, lo, hi):
        d = pb - pa
        big = torch.abs(d) > _EPS
        rcp_d = 1.0 / torch.where(big, d, torch.ones_like(d))
        u0 = (lo - pa) * rcp_d
        u1 = u0 + (hi - lo) * rcp_d
        enter = torch.minimum(u0, u1)
        exit_ = torch.maximum(u0, u1)
        inside0 = (pa >= lo) & (pa <= hi)
        inf = torch.full_like(enter, float("inf"))
        enter = torch.where(big, enter, torch.where(inside0, -inf, inf))
        exit_ = torch.where(big, exit_, torch.where(inside0, inf, -inf))
        return enter, exit_

    ex_, xx = slab(xa, xb, x0, x1)
    ey_, xy = slab(ya, yb, y0, y1)
    t0 = torch.clamp(torch.maximum(ex_, ey_), 0.0, 1.0)
    t1 = torch.clamp(torch.minimum(xx, xy), 0.0, 1.0)
    return t0, torch.maximum(t0, t1)


def tri_box_edge_weights_xy(x0c, y0c, x1c, y1c, x2c, y2c, bx0, bx1, by0, by1):
    """Per-edge shape-derivative weights (j1, j2) of each directed edge.

    For edge e = (a -> b) with clip interval [t0, t1], d area / d a =
    (dy, -dx) * j1 and d area / d b = (dy, -dx) * j2, with j2 = (t1^2 -
    t0^2) / 2 and j1 = (t1 - t0) - j2. (dy, -dx) depends on the face only,
    so the backward compositor reduces the weights over pixels first and
    applies the edge deltas once per face.

    Returns ((j1_0, j2_0), (j1_1, j2_1), (j1_2, j2_2)).
    """
    bx0, bx1, by0, by1 = _as_planes(x0c, bx0, bx1, by0, by1)
    xs = (x0c, x1c, x2c)
    ys = (y0c, y1c, y2c)
    out = []
    for e in range(3):
        j = (e + 1) % 3
        t0, t1 = _edge_clip_interval(xs[e], ys[e], xs[j], ys[j], bx0, bx1, by0, by1)
        j2 = 0.5 * (t1 * t1 - t0 * t0)
        out.append(((t1 - t0) - j2, j2))
    return tuple(out)


def tri_box_overlap_grad_xy(x0c, y0c, x1c, y1c, x2c, y2c, bx0, bx1, by0, by1):
    """Coordinate-plane variant of :func:`tri_box_overlap_area_grad`.

    Returns (gx0, gy0, gx1, gy1, gx2, gy2): d(area)/d(vertex coordinate).
    """
    xs = (x0c, x1c, x2c)
    ys = (y0c, y1c, y2c)
    jw = tri_box_edge_weights_xy(x0c, y0c, x1c, y1c, x2c, y2c, bx0, bx1, by0, by1)
    gx = [0.0, 0.0, 0.0]
    gy = [0.0, 0.0, 0.0]
    for e in range(3):
        j = (e + 1) % 3
        dx = xs[j] - xs[e]
        dy = ys[j] - ys[e]
        j1, j2 = jw[e]
        gx[e] = gx[e] + dy * j1
        gy[e] = gy[e] - dx * j1
        gx[j] = gx[j] + dy * j2
        gy[j] = gy[j] - dx * j2
    return gx[0], gy[0], gx[1], gy[1], gx[2], gy[2]


def tri_box_overlap_area_grad(tri, x0, x1, y0, y1):
    """Exact d(overlap area)/d(triangle vertices), by the shape derivative.

    Moving vertex a of edge (a, b) moves the part of the edge inside the box
    with normal velocity (1 - t) da, so with n|e| = (dy, -dx) (outward for
    CCW) and [t0, t1] the edge's clip interval, d area / d a = n|e| * ((t1 -
    t0) - (t1^2 - t0^2) / 2) and d area / d b = n|e| * (t1^2 - t0^2) / 2.

    Args: tri (..., 3, 2) CCW triangle vertices; box bounds broadcastable
    against ``tri[..., 0, 0]``. Returns the (..., 3, 2) gradient.
    """
    g = tri_box_overlap_grad_xy(*(tri[..., k // 2, k % 2] for k in range(6)),
                                x0, x1, y0, y1)
    return torch.stack(g, dim=-1).unflatten(-1, (3, 2))
