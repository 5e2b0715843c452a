// Per-(face, pixel) arithmetic shared by the forward and backward tile
// compositors (composite_fwd.cu, composite_bwd.cu).
//
// The backward replays the forward's blend, so both kernels must take the
// same blend decisions on the same inputs: the same alpha, the same clamp
// region code at boundaries, the same sub-resolution AA residues. Both
// include these functions and are built with -fmad=false; every expression
// is written in the operation order of the plain PyTorch versions
// (ops/composite_fwd.py::pair_quantities, aa.py), which round one operation
// at a time, so kernels and plain versions agree to the bit.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace pair_math {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kRec = 32;
constexpr float kTEps = 1e-4f;
constexpr float kAreaEps = 1e-12f;

// Record layout (ops/binning.py REC_*).
constexpr int kV = 0, kC = 9, kOp = 18, kIn = 19, kZ = 20, kAA = 23;

__device__ __forceinline__ float mn(float a, float b) { return a < b ? a : b; }
__device__ __forceinline__ float mx(float a, float b) { return a > b ? a : b; }
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return mn(mx(x, lo), hi);
}

// aa.py::_edge_area, operation for operation.
__device__ __forceinline__ float edge_area(float xa, float ya, float xb,
                                           float yb, float x0, float x1,
                                           float y0, float y1) {
  float dx = xb - xa;
  float dy = yb - ya;
  float dy_safe = fabsf(dy) > kAreaEps ? dy : (dy >= 0.0f ? kAreaEps : -kAreaEps);
  float rcp_dy = 1.0f / dy_safe;
  float ts0 = (y0 - ya) * rcp_dy;
  float ts1 = ts0 + (y1 - y0) * rcp_dy;
  float ta = clip(mn(ts0, ts1), 0.0f, 1.0f);
  float tb = clip(mx(ts0, ts1), 0.0f, 1.0f);
  tb = mx(ta, tb);

  float k = xa - x0;
  float w = x1 - x0;
  bool big = fabsf(dx) > kAreaEps;
  float rcp_dx = 1.0f / (big ? dx : 1.0f);
  float tc0 = -k * rcp_dx;
  float tc1 = tc0 + w * rcp_dx;
  float lo = clip(mn(tc0, tc1), ta, tb);
  float hi = clip(mx(tc0, tc1), ta, tb);
  float vlo = clip(k + lo * dx, 0.0f, w);
  float vhi = clip(k + hi * dx, 0.0f, w);
  float vleft = clip(k + ta * dx, 0.0f, w);
  float vright = clip(k + tb * dx, 0.0f, w);
  float integral =
      vleft * (lo - ta) + 0.5f * (vlo + vhi) * (hi - lo) + vright * (tb - hi);
  float flat = clip(k, 0.0f, w) * (tb - ta);
  return dy * (big ? integral : flat);
}

// aa.py::_edge_clip_interval: Liang-Barsky [t0, t1] of segment a -> b in
// the box. An axis along which the edge does not move gives the slab
// (-inf, inf) when the edge lies inside it and (inf, -inf) otherwise.
__device__ __forceinline__ void clip_slab(float pa, float pb, float lo,
                                          float hi, float& enter,
                                          float& exit_) {
  float d = pb - pa;
  bool big = fabsf(d) > kAreaEps;
  float rcp_d = 1.0f / (big ? d : 1.0f);
  float u0 = (lo - pa) * rcp_d;
  float u1 = u0 + (hi - lo) * rcp_d;
  bool inside0 = (pa >= lo) && (pa <= hi);
  enter = big ? mn(u0, u1) : (inside0 ? -CUDART_INF_F : CUDART_INF_F);
  exit_ = big ? mx(u0, u1) : (inside0 ? CUDART_INF_F : -CUDART_INF_F);
}

// aa.py::tri_box_edge_weights_xy for one directed edge: (j1, j2).
__device__ __forceinline__ void edge_weights(float xa, float ya, float xb,
                                             float yb, float x0, float x1,
                                             float y0, float y1, float& j1,
                                             float& j2) {
  float ex, xx, ey, xy;
  clip_slab(xa, xb, x0, x1, ex, xx);
  clip_slab(ya, yb, y0, y1, ey, xy);
  float t0 = clip(mx(ex, ey), 0.0f, 1.0f);
  float t1 = clip(mn(xx, xy), 0.0f, 1.0f);
  t1 = mx(t0, t1);
  j2 = 0.5f * (t1 * t1 - t0 * t0);
  j1 = (t1 - t0) - j2;
}

// What one (face, pixel) pair contributes, before the transmittance test.
struct Pair {
  float u, v, inv;  // unclamped Moeller-Trumbore barycentrics, 1 / denom
  float uc, vc;     // clamped barycentrics
  float ratio;      // (1 - tau) * inside + tau * area
  int code;         // clamp region (geometry.py::clamp_bary_uv)
  bool bbox_ok;
  bool passes;      // MT valid, AA area > 0, bbox, ratio != 0
};

__device__ __forceinline__ Pair pair_quantities(const float* rec, float ox,
                                                float oy, float oz, float rdx,
                                                float rdy, float rdz,
                                                float px0, float py0,
                                                float tau,
                                                float one_minus_tau) {
  Pair p;
  const float v0x = rec[kV + 0], v0y = rec[kV + 1], v0z = rec[kV + 2];
  const float v1x = rec[kV + 3], v1y = rec[kV + 4], v1z = rec[kV + 5];
  const float v2x = rec[kV + 6], v2y = rec[kV + 7], v2z = rec[kV + 8];

  // Moeller-Trumbore through scalar triple products:
  // den = rd.(e2 x e1), u_num = rd.(e2 x t0), v_num = rd.(t0 x e1).
  const float e1x = v1x - v0x, e1y = v1y - v0y, e1z = v1z - v0z;
  const float e2x = v2x - v0x, e2y = v2y - v0y, e2z = v2z - v0z;
  const float t0x = ox - v0x, t0y = oy - v0y, t0z = oz - v0z;
  const float nx = e2y * e1z - e2z * e1y;
  const float ny = e2z * e1x - e2x * e1z;
  const float nz = e2x * e1y - e2y * e1x;
  const float mx_ = e2y * t0z - e2z * t0y;
  const float my_ = e2z * t0x - e2x * t0z;
  const float mz_ = e2x * t0y - e2y * t0x;
  const float qx = t0y * e1z - t0z * e1y;
  const float qy = t0z * e1x - t0x * e1z;
  const float qz = t0x * e1y - t0y * e1x;
  const float denom = nx * rdx + ny * rdy + nz * rdz;
  const bool mt_ok = denom != 0.0f;
  p.inv = 1.0f / (mt_ok ? denom : 1.0f);
  const float u = (mx_ * rdx + my_ * rdy + mz_ * rdz) * p.inv;
  const float v = (qx * rdx + qy * rdy + qz * rdz) * p.inv;
  p.u = u;
  p.v = v;

  // 7-region clamp (geometry.py::clamp_bary_uv); tests in this order.
  const bool inside = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
  const bool c1 = (u <= 0.0f) && (v <= 0.0f);
  const bool c2 = ((u >= 1.0f) && (v <= 0.0f)) || ((v >= 0.0f) && (v <= u - 1.0f));
  const bool c3 = ((u <= 0.0f) && (v >= 1.0f)) || ((u >= 0.0f) && (v >= u + 1.0f));
  const bool c4 = (u <= 0.0f) && (v <= 1.0f) && (v >= 0.0f);
  const bool c5 = (u <= 1.0f) && (u >= 0.0f) && (v <= 0.0f);
  if (inside) { p.uc = u; p.vc = v; p.code = 0; }
  else if (c1) { p.uc = 0.0f; p.vc = 0.0f; p.code = 1; }
  else if (c2) { p.uc = 1.0f; p.vc = 0.0f; p.code = 2; }
  else if (c3) { p.uc = 0.0f; p.vc = 1.0f; p.code = 3; }
  else if (c4) { p.uc = 0.0f; p.vc = v; p.code = 4; }
  else if (c5) { p.uc = u; p.vc = 0.0f; p.code = 5; }
  else { p.uc = (1.0f + u - v) * 0.5f; p.vc = (1.0f - u + v) * 0.5f; p.code = 6; }

  // Per-pixel face-bbox reject.
  const float ax0 = rec[kAA + 0], ay0 = rec[kAA + 1];
  const float ax1 = rec[kAA + 2], ay1 = rec[kAA + 3];
  const float ax2 = rec[kAA + 4], ay2 = rec[kAA + 5];
  const float txmin = mn(mn(ax0, ax1), ax2);
  const float txmax = mx(mx(ax0, ax1), ax2);
  const float tymin = mn(mn(ay0, ay1), ay2);
  const float tymax = mx(mx(ay0, ay1), ay2);
  const float px1 = px0 + 1.0f, py1 = py0 + 1.0f;
  p.bbox_ok = (px1 >= txmin) && (px0 <= txmax) && (py1 >= tymin) && (py0 <= tymax);

  const float inside_f = inside ? 1.0f : 0.0f;
  bool aa_ok = true;
  if (tau > 0.0f) {
    float area = edge_area(ax0, ay0, ax1, ay1, px0, px1, py0, py1) +
                 edge_area(ax1, ay1, ax2, ay2, px0, px1, py0, py1) +
                 edge_area(ax2, ay2, ax0, ay0, px0, px1, py0, py1);
    const float box = (px1 - px0) * (py1 - py0);
    const float oarea = clip(area, 0.0f, box);
    aa_ok = oarea > 0.0f;
    p.ratio = one_minus_tau * inside_f + tau * oarea;
  } else {
    p.ratio = inside_f;
  }
  p.passes = mt_ok && aa_ok && p.bbox_ok && (p.ratio != 0.0f);
  return p;
}

// Interpolated colour (before intensity) and NDC depth at (uc, vc).
struct Interp {
  float m_r, m_g, m_b, i_d;
};

__device__ __forceinline__ Interp interpolate(const float* rec, float uc,
                                              float vc) {
  const float i0 = 1.0f - uc - vc;
  Interp s;
  s.m_r = i0 * rec[kC + 0] + uc * rec[kC + 3] + vc * rec[kC + 6];
  s.m_g = i0 * rec[kC + 1] + uc * rec[kC + 4] + vc * rec[kC + 7];
  s.m_b = i0 * rec[kC + 2] + uc * rec[kC + 5] + vc * rec[kC + 8];
  s.i_d = i0 * rec[kZ + 0] + uc * rec[kZ + 1] + vc * rec[kZ + 2];
  return s;
}

}  // namespace pair_math
