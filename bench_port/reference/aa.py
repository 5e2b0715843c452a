"""Analytic anti-aliasing of the plain reference: the exact overlap area of
a CCW triangle and a pixel box, and its shape-derivative edge weights.

A frozen copy of the renderer's closed forms, in the order the compositors
evaluate them. Each directed edge (a -> b) adds ``dy * Int clamp(x_e(y) -
x0, 0, x1 - x0) dt`` over its part inside the box's y-slab.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _planes(like, *xs):
    return [torch.as_tensor(x, dtype=like.dtype, device=like.device) for x in xs]


def _edge_area(xa, ya, xb, yb, x0, x1, y0, y1):
    dx = xb - xa
    dy = yb - ya
    dy_safe = torch.where(
        torch.abs(dy) > _EPS, dy,
        torch.where(dy >= 0, torch.full_like(dy, _EPS), torch.full_like(dy, -_EPS)))
    rcp_dy = 1.0 / dy_safe
    ts0 = (y0 - ya) * rcp_dy
    ts1 = ts0 + (y1 - y0) * rcp_dy
    ta = torch.clamp(torch.minimum(ts0, ts1), 0.0, 1.0)
    tb = torch.clamp(torch.maximum(ts0, ts1), 0.0, 1.0)
    tb = torch.maximum(ta, tb)
    k = xa - x0
    w = x1 - x0
    big = torch.abs(dx) > _EPS
    rcp_dx = 1.0 / torch.where(big, dx, torch.ones_like(dx))
    tc0 = -k * rcp_dx
    tc1 = tc0 + w * rcp_dx
    lo = torch.clamp(torch.minimum(tc0, tc1), ta, tb)
    hi = torch.clamp(torch.maximum(tc0, tc1), ta, tb)
    zero = torch.zeros_like(w)
    vlo = torch.clamp(k + lo * dx, zero, w)
    vhi = torch.clamp(k + hi * dx, zero, w)
    vleft = torch.clamp(k + ta * dx, zero, w)
    vright = torch.clamp(k + tb * dx, zero, w)
    integral = vleft * (lo - ta) + 0.5 * (vlo + vhi) * (hi - lo) + vright * (tb - hi)
    flat = torch.clamp(k, zero, w) * (tb - ta)
    return dy * torch.where(big, integral, flat)


def overlap_area(x0c, y0c, x1c, y1c, x2c, y2c, bx0, bx1, by0, by1):
    """Overlap area of CCW triangles (corner coordinates as broadcastable
    columns) with boxes [bx0, bx1] x [by0, by1], clamped into [0, box]."""
    bx0, bx1, by0, by1 = _planes(x0c, bx0, bx1, by0, by1)
    area = (_edge_area(x0c, y0c, x1c, y1c, bx0, bx1, by0, by1)
            + _edge_area(x1c, y1c, x2c, y2c, bx0, bx1, by0, by1)
            + _edge_area(x2c, y2c, x0c, y0c, bx0, bx1, by0, by1))
    box = (bx1 - bx0) * (by1 - by0)
    return torch.clamp(area, torch.zeros_like(box), box)


def _edge_clip_interval(xa, ya, xb, yb, x0, x1, y0, y1):
    """Liang-Barsky parameter interval of segment a -> b inside the box."""
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


def edge_weights(x0c, y0c, x1c, y1c, x2c, y2c, bx0, bx1, by0, by1):
    """Per directed edge e, the weights (j1, j2) with d area / d a = (dy,
    -dx) j1 and d area / d b = (dy, -dx) j2: j2 = (t1^2 - t0^2) / 2, j1 =
    (t1 - t0) - j2 over the edge's clip interval [t0, t1]."""
    bx0, bx1, by0, by1 = _planes(x0c, bx0, bx1, by0, by1)
    xs, ys = (x0c, x1c, x2c), (y0c, y1c, y2c)
    out = []
    for e in range(3):
        j = (e + 1) % 3
        t0, t1 = _edge_clip_interval(xs[e], ys[e], xs[j], ys[j], bx0, bx1, by0, by1)
        j2 = 0.5 * (t1 * t1 - t0 * t0)
        out.append(((t1 - t0) - j2, j2))
    return tuple(out)
