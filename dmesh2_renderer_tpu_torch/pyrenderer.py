"""API-parity mirror of the reference's ``dmesh2_renderer.pyrenderer``.

Port of ``dmesh2_renderer_tpu/pyrenderer.py``: DMesh++ imports
``Triangles`` / ``Pixels`` / ``tri_pixel_overlap_area`` from the reference's
pyrenderer module; this module gives the same names and semantics on torch
tensors. The functions are vectorized over any leading batch shape and
evaluate the closed-form overlap integrals of
:mod:`dmesh2_renderer_tpu_torch.aa` (exact for every configuration;
degenerate cases yield subgradients instead of raising).

As in the JAX module:
  * ``tid``/``pid`` may be index tensors. For scalar indices the polygon
    return types mirror the reference exactly (``[]`` / the (4, 2)
    pixel-corner tensor / a list of (2,) points, in the order of the
    reference's edge walk); for index tensors the polygon comes back as a
    padded ``(..., MAX_POLY, 2)`` tensor and a count.
  * The area is always the closed-form winding integral, equal to the
    reference's fan area up to float rounding.
  * Error codes E00-E05 are graceful by default; ``strict=True`` detects
    the reference's degenerate configurations and raises the same
    ``ValueError("[pyrasterizer] Error code NN")``.
  * ``use_autograd=True`` differentiates with torch.autograd, ``False``
    with the analytic shape derivative
    (:func:`tri_pixel_overlap_area_grad`); both give the same areas, so the
    flag changes nothing here.
Inputs may be numpy arrays or tensors; tensors keep their device.
"""

from __future__ import annotations

import torch

from dmesh2_renderer_tpu_torch.aa import (
    tri_box_overlap_area, tri_box_overlap_area_grad,
)
from dmesh2_renderer_tpu_torch.geometry import Triangles as _TrianglesTuple
from dmesh2_renderer_tpu_torch.geometry import make_triangles, order_ccw, tri_area2

EPS = 1e-3

# Clip polygon capacity: a triangle clipped by 4 half-planes has <= 7
# vertices; the reference caps at 10 (``aa.h:11`` MAX_NUM_POLYGONS) and its
# walk can transiently emit duplicates, so the same bound is kept.
MAX_POLY = 10


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def Triangles(p0, p1, p2) -> _TrianglesTuple:
    """CCW triangle precompute; same fields as the reference class
    (verts, edges, edges_iszero, edges_recip, edges_normal, edges_normal_c)."""
    return make_triangles(_tensor(p0), _tensor(p1), _tensor(p2))


class Pixels:
    """Axis-aligned pixel boxes, constructed from (pixmin, pixmax) corner
    arrays exactly like the reference class, so DMesh++'s positional call
    ``Pixels(pixmin, pixmax)`` is a drop-in.

    Attributes:
      verts: (..., 4, 2) corners (min), (xmax, ymin), (max), (xmin, ymax)
      edges: (..., 4, 2) CCW edge vectors
    """

    def __init__(self, pixmin, pixmax):
        pixmin = _tensor(pixmin)
        pixmax = _tensor(pixmax)
        p0 = pixmin
        p1 = torch.stack([pixmax[..., 0], pixmin[..., 1]], dim=-1)
        p2 = pixmax
        p3 = torch.stack([pixmin[..., 0], pixmax[..., 1]], dim=-1)
        self.verts = torch.stack([p0, p1, p2, p3], dim=-2)
        self.edges = torch.stack([p1 - p0, p2 - p1, p3 - p2, p0 - p3], dim=-2)


def make_pixels(pixmin, pixmax) -> Pixels:
    """Alias for :class:`Pixels`."""
    return Pixels(pixmin, pixmax)


def _take(arr, idx):
    """``arr[..., idx[...], :]`` along the second-to-last axis."""
    return torch.gather(arr, -2, idx[..., None, None].expand(
        *idx.shape, 1, arr.shape[-1]))[..., 0, :]


def _clip_polygon_walk(tv, pv, inside_tri):
    """Vectorized mirror of the reference's per-edge clip walk: same vertex
    emission order, masks instead of python branches.

    Args:
      tv: (..., 3, 2) CCW triangle vertices.
      pv: (..., 4, 2) pixel corners (min, (xmax,ymin), max, (xmin,ymax)).
      inside_tri: (..., 4) bool, corner-inside-triangle flags.
    Returns:
      poly:  (..., MAX_POLY, 2) polygon vertices, padded with zeros
      count: (...,) int32 valid vertex count
      flags: dict of E-code condition masks (each (...,) bool)
    """
    xmin, ymin = pv[..., 0, 0], pv[..., 0, 1]
    xmax, ymax = pv[..., 2, 0], pv[..., 2, 1]
    batch = tv.shape[:-2]

    # Endpoint-inside-pixel uses the reference's closed box test.
    vin = ((tv[..., 0] >= xmin[..., None]) & (tv[..., 0] <= xmax[..., None])
           & (tv[..., 1] >= ymin[..., None]) & (tv[..., 1] <= ymax[..., None]))

    slots, active = [], []
    e00 = e01 = e02 = e03 = torch.zeros(batch, dtype=torch.bool, device=tv.device)
    pedge_idx = torch.arange(4, device=tv.device)
    for ti in range(3):
        p0 = tv[..., ti, :]
        p1 = tv[..., (ti + 1) % 3, :]
        e = p1 - p0
        tri_h = torch.abs(e[..., 1]) < EPS
        tri_v = torch.abs(e[..., 0]) < EPS
        p0in = vin[..., ti]
        p1in = vin[..., (ti + 1) % 3]

        ts, ips, valids, corner00 = [], [], [], []
        for pi in range(4):
            pedge_h = pi in (0, 2)
            # Pixel edge pi is the line {axis0 == iaxis0}; the intersection
            # must land within [pmin1, pmax1] along the other axis.
            axis0 = 1 if pedge_h else 0
            axis1 = 1 - axis0
            iaxis0 = pv[..., pi, axis0]
            pmin1 = xmin if pedge_h else ymin
            pmax1 = xmax if pedge_h else ymax
            parallel = tri_h if pedge_h else tri_v
            denom = e[..., axis0]
            t = (iaxis0 - p0[..., axis0]) / torch.where(
                torch.abs(denom) > 0, denom, torch.ones_like(denom))
            iaxis1 = p0[..., axis1] + t * e[..., axis1]
            valid = ((t >= 0) & (t <= 1) & (iaxis1 >= pmin1) & (iaxis1 <= pmax1)
                     & ~parallel & (torch.abs(denom) > 0))
            corner00.append(valid & ((iaxis1 == pmin1) | (iaxis1 == pmax1)))
            ip = torch.stack([iaxis0, iaxis1] if axis0 == 0 else [iaxis1, iaxis0],
                             dim=-1)
            ts.append(torch.where(valid, t, torch.full_like(t, float("inf"))))
            ips.append(ip)
            valids.append(valid)

        tq = torch.stack(ts, dim=-1)                                # (..., 4)
        vq = torch.stack(valids, dim=-1)
        ipq = torch.stack(ips, dim=-2)                              # (..., 4, 2)
        n = vq.sum(dim=-1)
        e00 = e00 | torch.stack(corner00, -1).any(-1)
        e01 = e01 | (n > 2)
        e02 = e02 | ((n == 1) & ~(p0in ^ p1in))
        e03 = e03 | ((n == 0) & (p0in ^ p1in))

        # argmin returns the first minimum, as jnp.argmin does.
        i_lo = torch.argmin(tq, dim=-1)
        tq2 = torch.where(pedge_idx == i_lo[..., None], float("inf"), tq)
        i_hi = torch.argmin(tq2, dim=-1)
        ip_lo = _take(ipq, i_lo)
        ip_hi = _take(ipq, i_hi)

        # Slot A0/A1: intersection points sorted by t (the reference walk
        # appends the lower-t point first for n==2; the single point for n==1).
        slots += [ip_lo, ip_hi]
        active += [n >= 1, n >= 2]

        # Slot B: the edge's head endpoint p1 -- emitted when the edge enters
        # the pixel through an intersection (n==1, p0 out, p1 in) or lies
        # fully inside it (n==0, both in).
        slots.append(p1)
        active.append(((n == 1) & ~p0in & p1in) | ((n == 0) & p0in & p1in))

        # Slots C0..C3: pixel corners walked CCW from the corner after the
        # last crossed pixel edge, while they stay inside the triangle.
        # Applies when the edge exits the pixel: n==2, or n==1 with p0
        # inside and p1 outside.
        corner_case = (n >= 2) | ((n == 1) & p0in & ~p1in)
        last_pedge = torch.where(n >= 2, i_hi, i_lo)
        run = torch.ones_like(corner_case)
        for k in range(4):
            cid = (last_pedge + 1 + k) % 4
            cin = torch.gather(inside_tri, -1, cid[..., None])[..., 0]
            run = run & cin
            slots.append(_take(pv, cid))
            active.append(corner_case & run)

    mask = torch.stack(active, dim=-1)                              # (..., 21)
    verts = torch.stack(slots, dim=-2)                              # (..., 21, 2)
    # Stable compaction: active slots first, original order preserved.
    order = torch.sort((~mask).to(torch.uint8), dim=-1, stable=True).indices
    idx = order[..., :MAX_POLY, None].expand(*batch, MAX_POLY, 2)
    poly = torch.gather(verts, -2, idx)
    count = mask.sum(dim=-1, dtype=torch.int32)
    keep = torch.arange(MAX_POLY, device=tv.device) < count[..., None]
    poly = torch.where(keep[..., None], poly, torch.zeros((), dtype=poly.dtype,
                                                          device=poly.device))
    count = torch.clamp(count, max=MAX_POLY)

    # Fan-triangulation diagnostics (the reference walk's E04/E05).
    subs = []
    for si in range(MAX_POLY - 2):
        a = tri_area(poly[..., 0, :], poly[..., si + 1, :], poly[..., si + 2, :])
        subs.append(torch.where(si + 2 < count, a, torch.zeros_like(a)))
    sub = torch.stack(subs, dim=-1)
    e04 = (sub < 0).any(dim=-1)
    fan_area = sub.sum(dim=-1)
    pxarea = (xmax - xmin) * (ymax - ymin)
    e05 = fan_area > pxarea

    flags = {"e00": e00, "e01": e01, "e02": e02, "e03": e03,
             "e04": e04, "e05": e05}
    return poly, count, flags


def _raise_ecodes(flags, degenerate_mask):
    for code in ("e00", "e01", "e02", "e03", "e04", "e05"):
        if bool(torch.any(flags[code] & degenerate_mask)):
            raise ValueError(f"[pyrasterizer] Error code {code[1:]}")


def tri_pixel_overlap_area(tris: _TrianglesTuple, pixs: Pixels, tid, pid,
                           use_autograd: bool = False, strict: bool = False):
    """Overlap area + clip polygon of triangle ``tid`` with pixel ``pid``.

    Mirrors the reference dispatcher: returns ``(0.0, [])`` when a triangle
    edge separates the pixel, ``(pix_area, pix_corners)`` when the pixel is
    fully inside, else the walked clip polygon. Vectorized: for index
    tensors ``tid``/``pid`` the polygon is returned padded as ``(poly (...,
    MAX_POLY, 2), count (...))`` and the fast paths are folded in per
    element (count 0 / 4).

    ``strict=True`` raises the reference's E00-E05 ``ValueError``s on the
    corresponding degenerate configurations.
    """
    del use_autograd  # identical values either way; kept for signature parity
    tid = _tensor(tid)
    pid = _tensor(pid)
    tv = tris.verts[tid]            # (..., 3, 2)
    nrm = tris.edges_normal[tid]    # (..., 3, 2)
    nc = tris.edges_normal_c[tid]   # (..., 3)
    pv = pixs.verts[pid]            # (..., 4, 2)
    x0, y0 = pv[..., 0, 0], pv[..., 0, 1]
    x1, y1 = pv[..., 2, 0], pv[..., 2, 1]

    area = tri_box_overlap_area(tv, x0, x1, y0, y1)

    # corner-vs-edge half-plane table (..., 3 edges, 4 corners)
    side = torch.einsum("...ek,...ck->...ec", nrm, pv) - nc[..., None]
    corner_in_edge = side >= 0
    reject = (~corner_in_edge).all(dim=-1).any(dim=-1)
    contained = corner_in_edge.all(dim=-1).all(dim=-1)
    inside_tri = corner_in_edge.all(dim=-2)                         # (..., 4)

    poly, count, flags = _clip_polygon_walk(tv, pv, inside_tri)
    if strict:
        _raise_ecodes(flags, ~reject & ~contained)

    if tid.dim() == 0 and pid.dim() == 0:
        if bool(reject):
            return area, []
        if bool(contained):
            return area, pv
        return area, [poly[i] for i in range(int(count))]

    count = torch.where(reject, torch.zeros_like(count), count)
    pad = torch.zeros(pv.shape[:-2] + (MAX_POLY - 4, 2), dtype=pv.dtype,
                      device=pv.device)
    poly = torch.where(contained[..., None, None], torch.cat([pv, pad], dim=-2), poly)
    count = torch.where(contained, torch.full_like(count, 4), count)
    return area, (poly, count)


def tri_pixel_overlap_area_grad(tris: _TrianglesTuple, pixs: Pixels, tid, pid):
    """d(area)/d(tris.verts[tid]) -- the analytic shape derivative the
    reference accumulates into grad_tri_verts."""
    tv = tris.verts[_tensor(tid)]
    pv = pixs.verts[_tensor(pid)]
    x0, y0 = pv[..., 0, 0], pv[..., 0, 1]
    x1, y1 = pv[..., 2, 0], pv[..., 2, 1]
    return tri_box_overlap_area_grad(tv, x0, x1, y0, y1)


def tri_area(p0, p1, p2):
    """Signed triangle area (reference ``pyrenderer.tri_area``)."""
    return 0.5 * tri_area2(p0, p1, p2)


__all__ = [
    "EPS", "MAX_POLY", "Triangles", "Pixels", "make_pixels", "order_ccw",
    "tri_area", "tri_pixel_overlap_area", "tri_pixel_overlap_area_grad",
]
