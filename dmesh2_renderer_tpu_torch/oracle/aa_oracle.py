"""Slow, trusted oracle for triangle-box overlap area (tests only).

The port's own copy of ``dmesh2_renderer_tpu/oracle/aa_oracle.py`` (numpy
only; the port imports nothing of the JAX package). Independent algorithm
(Sutherland-Hodgman clipping + shoelace) implementing the same
specification as the reference's AA library (``cuda_impl/aa.h`` /
``pyrenderer.py:456-519``): exact area of a triangle intersected with an
axis-aligned pixel box. Used to validate the closed-form winding-integral
implementation in ``dmesh2_renderer_tpu_torch.aa``.
"""

from __future__ import annotations

import numpy as np


def clip_polygon_area(poly: np.ndarray, x0: float, x1: float, y0: float, y1: float) -> float:
    """Exact area of polygon ^ box via Sutherland-Hodgman + shoelace.

    Args:
      poly: (N, 2) CCW polygon vertices.
    Returns: overlap area (float).
    """
    verts = [tuple(p) for p in np.asarray(poly, dtype=np.float64)]

    def clip(vs, inside, intersect):
        out = []
        n = len(vs)
        for i in range(n):
            cur, nxt = vs[i], vs[(i + 1) % n]
            cin, nin = inside(cur), inside(nxt)
            if cin:
                out.append(cur)
                if not nin:
                    out.append(intersect(cur, nxt))
            elif nin:
                out.append(intersect(cur, nxt))
        return out

    def x_cross(c, a, b):
        t = (c - a[0]) / (b[0] - a[0])
        return (c, a[1] + t * (b[1] - a[1]))

    def y_cross(c, a, b):
        t = (c - a[1]) / (b[1] - a[1])
        return (a[0] + t * (b[0] - a[0]), c)

    verts = clip(verts, lambda p: p[0] >= x0, lambda a, b: x_cross(x0, a, b))
    if verts:
        verts = clip(verts, lambda p: p[0] <= x1, lambda a, b: x_cross(x1, a, b))
    if verts:
        verts = clip(verts, lambda p: p[1] >= y0, lambda a, b: y_cross(y0, a, b))
    if verts:
        verts = clip(verts, lambda p: p[1] <= y1, lambda a, b: y_cross(y1, a, b))
    if len(verts) < 3:
        return 0.0
    a = 0.0
    for i in range(len(verts)):
        px, py = verts[i]
        qx, qy = verts[(i + 1) % len(verts)]
        a += px * qy - qx * py
    return 0.5 * a


def tri_box_area_oracle(tri: np.ndarray, x0, x1, y0, y1) -> float:
    """Overlap area of one CCW triangle with one box."""
    return clip_polygon_area(np.asarray(tri, dtype=np.float64), x0, x1, y0, y1)


def tri_box_grad_fd(tri: np.ndarray, x0, x1, y0, y1, eps: float = 1e-5) -> np.ndarray:
    """Central finite-difference gradient of the oracle area w.r.t. vertices."""
    tri = np.asarray(tri, dtype=np.float64)
    g = np.zeros_like(tri)
    for i in range(3):
        for j in range(2):
            tp = tri.copy()
            tp[i, j] += eps
            tm = tri.copy()
            tm[i, j] -= eps
            g[i, j] = (tri_box_area_oracle(tp, x0, x1, y0, y1) - tri_box_area_oracle(tm, x0, x1, y0, y1)) / (2 * eps)
    return g
