// Per-(face, pixel) arithmetic shared by the forward and backward tile
// compositors (composite_fwd.cu, composite_bwd.cu), and the staging of the
// record stream that both use.
//
// The backward replays the forward's blend, so both kernels must take the
// same blend decisions on the same inputs: the same alpha, the same clamp
// region code at boundaries, the same sub-resolution AA residues. Both
// include these functions and are built with -fmad=false; every expression
// is written in the operation order of the plain PyTorch versions
// (ops/composite_fwd.py::pair_quantities, aa.py), which round one operation
// at a time, so kernels and plain versions agree to the bit.
//
// What bounds both compositors is the per-(face, pixel) arithmetic: a tile
// walks hundreds of faces for each of its 256 pixels, and a face's 128-byte
// record is shared by all of them. What this header does about it:
//   * Staging. A block copies its tile's records kChunk at a time into
//     shared memory with cp.async (16 bytes per thread, coalesced), the next
//     chunk in flight while the current one is composited (two buffers).
//   * Per-face terms. Whatever does not depend on the pixel -- the edges,
//     the origin offset t0 (a tile belongs to one view), the cross products
//     n, m, q of the Moeller-Trumbore triple products, the AA bbox, and per
//     AA edge dx, dy and the reciprocals that the area and the Liang-Barsky
//     clip divide by -- is computed once per face into a FaceTerms in
//     shared memory, one face per thread, with the expressions the plain
//     versions evaluate per pair, so they round identically.
//   * Early out. pair_quantities tests the per-pixel bbox first and returns
//     before any Moeller-Trumbore or AA arithmetic: a pair outside the bbox
//     can never pass, and most of a tile's (face, pixel) pairs are outside.
//     The comparisons are the plain version's (>=, <=), so a pixel box that
//     touches the bbox goes on. A warp none of whose lanes is inside the
//     bbox takes the early return together and skips the per-pair work.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace pair_math {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kRec = 32;
constexpr int kChunk = 64;  // records staged per round (8 KB)
constexpr float kTEps = 1e-4f;
constexpr float kAreaEps = 1e-12f;

// Record layout (ops/binning.py REC_*).
constexpr int kV = 0, kC = 9, kOp = 18, kIn = 19, kZ = 20, kAA = 23;

__device__ __forceinline__ float mn(float a, float b) { return a < b ? a : b; }
__device__ __forceinline__ float mx(float a, float b) { return a > b ? a : b; }
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return mn(mx(x, lo), hi);
}

// The pixel of a tile that lane `lane` of warp `warp` (of 8) composites:
// warp w covers the 8x4 block at ((w % 2) * 8, (w / 2) * 4), so a face a
// few pixels across meets fewer warps than it would as 16x2 rows, and the
// bbox early out skips more warps.
__device__ __forceinline__ int warp_pixel_x(int warp, int lane) {
  return (warp % 2) * 8 + lane % 8;
}
__device__ __forceinline__ int warp_pixel_y(int warp, int lane) {
  return (warp / 2) * 4 + lane / 8;
}

// Ray-independent terms of one face, for the view of the block's tile.
struct __align__(16) FaceTerms {
  float e1[3], e2[3], t0[3];         // v1 - v0, v2 - v0, o - v0
  float n[3], m[3], q[3];            // e2 x e1, e2 x t0, t0 x e1
  float txmin, txmax, tymin, tymax;  // AA bbox
  // AA edge e runs from corner e to corner (e + 1) % 3.
  float dx[3], dy[3];
  float rcp_dx[3];  // 1 / dx, or 1 where |dx| <= eps
  float rcp_dy[3];  // 1 / dy_safe (aa.py::_edge_area)
  unsigned flags;   // bit e: |dx_e| > eps; bit 3 + e: |dy_e| > eps
};

__device__ __forceinline__ bool big_dx(const FaceTerms& f, int e) {
  return (f.flags >> e) & 1u;
}
__device__ __forceinline__ bool big_dy(const FaceTerms& f, int e) {
  return (f.flags >> (3 + e)) & 1u;
}

// Fill ``f`` from one record and the view's ray origin.
__device__ __forceinline__ void face_terms(const float* rec, float ox, float oy,
                                           float oz, FaceTerms& f) {
  const float v0x = rec[kV + 0], v0y = rec[kV + 1], v0z = rec[kV + 2];
  const float e1x = rec[kV + 3] - v0x, e1y = rec[kV + 4] - v0y, e1z = rec[kV + 5] - v0z;
  const float e2x = rec[kV + 6] - v0x, e2y = rec[kV + 7] - v0y, e2z = rec[kV + 8] - v0z;
  const float t0x = ox - v0x, t0y = oy - v0y, t0z = oz - v0z;
  f.e1[0] = e1x; f.e1[1] = e1y; f.e1[2] = e1z;
  f.e2[0] = e2x; f.e2[1] = e2y; f.e2[2] = e2z;
  f.t0[0] = t0x; f.t0[1] = t0y; f.t0[2] = t0z;
  // Moeller-Trumbore through scalar triple products:
  // den = rd.(e2 x e1), u_num = rd.(e2 x t0), v_num = rd.(t0 x e1).
  f.n[0] = e2y * e1z - e2z * e1y;
  f.n[1] = e2z * e1x - e2x * e1z;
  f.n[2] = e2x * e1y - e2y * e1x;
  f.m[0] = e2y * t0z - e2z * t0y;
  f.m[1] = e2z * t0x - e2x * t0z;
  f.m[2] = e2x * t0y - e2y * t0x;
  f.q[0] = t0y * e1z - t0z * e1y;
  f.q[1] = t0z * e1x - t0x * e1z;
  f.q[2] = t0x * e1y - t0y * e1x;

  const float* aa = rec + kAA;
  f.txmin = mn(mn(aa[0], aa[2]), aa[4]);
  f.txmax = mx(mx(aa[0], aa[2]), aa[4]);
  f.tymin = mn(mn(aa[1], aa[3]), aa[5]);
  f.tymax = mx(mx(aa[1], aa[3]), aa[5]);
  unsigned flags = 0u;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int e1 = e == 2 ? 0 : e + 1;
    const float dx = aa[2 * e1] - aa[2 * e];
    const float dy = aa[2 * e1 + 1] - aa[2 * e + 1];
    const float dy_safe =
        fabsf(dy) > kAreaEps ? dy : (dy >= 0.0f ? kAreaEps : -kAreaEps);
    const bool bx = fabsf(dx) > kAreaEps;
    f.dx[e] = dx;
    f.dy[e] = dy;
    f.rcp_dy[e] = 1.0f / dy_safe;
    f.rcp_dx[e] = 1.0f / (bx ? dx : 1.0f);
    flags |= (bx ? 1u : 0u) << e;
    flags |= (fabsf(dy) > kAreaEps ? 1u : 0u) << (3 + e);
  }
  f.flags = flags;
}

// aa.py::_edge_area for edge e, operation for operation, with the face's
// terms (dx, dy, 1 / dy_safe, 1 / dx) staged.
__device__ __forceinline__ float edge_area(const FaceTerms& f, const float* aa,
                                           int e, float x0, float x1, float y0,
                                           float y1) {
  const float xa = aa[2 * e], ya = aa[2 * e + 1];
  const float dx = f.dx[e], rcp_dy = f.rcp_dy[e];
  float ts0 = (y0 - ya) * rcp_dy;
  float ts1 = ts0 + (y1 - y0) * rcp_dy;
  float ta = clip(mn(ts0, ts1), 0.0f, 1.0f);
  float tb = clip(mx(ts0, ts1), 0.0f, 1.0f);
  tb = mx(ta, tb);

  float k = xa - x0;
  float w = x1 - x0;
  const bool big = big_dx(f, e);
  float rcp_dx = f.rcp_dx[e];
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
  return f.dy[e] * (big ? integral : flat);
}

// aa.py::_edge_clip_interval's slab: Liang-Barsky [enter, exit] of the
// segment from pa along d in [lo, hi], with rcp_d = 1 / (big ? d : 1). An
// axis along which the edge does not move gives (-inf, inf) when the edge
// lies inside the slab and (inf, -inf) otherwise.
__device__ __forceinline__ void clip_slab(float pa, float rcp_d, bool big,
                                          float lo, float hi, float& enter,
                                          float& exit_) {
  float u0 = (lo - pa) * rcp_d;
  float u1 = u0 + (hi - lo) * rcp_d;
  bool inside0 = (pa >= lo) && (pa <= hi);
  enter = big ? mn(u0, u1) : (inside0 ? -CUDART_INF_F : CUDART_INF_F);
  exit_ = big ? mx(u0, u1) : (inside0 ? CUDART_INF_F : -CUDART_INF_F);
}

// aa.py::tri_box_edge_weights_xy for edge e: (j1, j2). The y slab divides
// by 1 / (big ? dy : 1), which is the staged 1 / dy_safe where |dy| > eps.
__device__ __forceinline__ void edge_weights(const FaceTerms& f, const float* aa,
                                             int e, float x0, float x1,
                                             float y0, float y1, float& j1,
                                             float& j2) {
  const bool bx = big_dx(f, e), by = big_dy(f, e);
  float ex, xx, ey, xy;
  clip_slab(aa[2 * e], f.rcp_dx[e], bx, x0, x1, ex, xx);
  clip_slab(aa[2 * e + 1], by ? f.rcp_dy[e] : 1.0f, by, y0, y1, ey, xy);
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
};

// True iff the pair passes every skip test of the blend rule (bbox, MT
// valid, AA area > 0, ratio != 0); ``p`` is filled only then. Tests in
// order of cost, each returning as soon as the pair cannot pass: the
// values of a passing pair are those of the plain version.
__device__ __forceinline__ bool pair_quantities(const FaceTerms& f,
                                                const float* rec, float rdx,
                                                float rdy, float rdz,
                                                float px0, float py0,
                                                float tau, float one_minus_tau,
                                                Pair& p) {
  const float px1 = px0 + 1.0f, py1 = py0 + 1.0f;
  if (!((px1 >= f.txmin) && (px0 <= f.txmax) && (py1 >= f.tymin) &&
        (py0 <= f.tymax)))
    return false;

  float oarea = 0.0f;
  if (tau > 0.0f) {
    const float* aa = rec + kAA;
    float area = edge_area(f, aa, 0, px0, px1, py0, py1) +
                 edge_area(f, aa, 1, px0, px1, py0, py1) +
                 edge_area(f, aa, 2, px0, px1, py0, py1);
    const float box = (px1 - px0) * (py1 - py0);
    oarea = clip(area, 0.0f, box);
    if (!(oarea > 0.0f)) return false;
  }

  const float denom = f.n[0] * rdx + f.n[1] * rdy + f.n[2] * rdz;
  if (denom == 0.0f) return false;
  p.inv = 1.0f / denom;
  const float u = (f.m[0] * rdx + f.m[1] * rdy + f.m[2] * rdz) * p.inv;
  const float v = (f.q[0] * rdx + f.q[1] * rdy + f.q[2] * rdz) * p.inv;
  p.u = u;
  p.v = v;

  // 7-region clamp (geometry.py::clamp_bary_uv); tests in this order.
  const bool inside = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
  if (!(tau > 0.0f)) {
    // ratio = inside: only code 0 can pass.
    if (!inside) return false;
    p.uc = u; p.vc = v; p.code = 0;
    p.ratio = 1.0f;
    return true;
  }
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

  p.ratio = one_minus_tau * (inside ? 1.0f : 0.0f) + tau * oarea;
  return p.ratio != 0.0f;
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

// One staging buffer: a chunk of records and their faces' terms.
struct Stage {
  float rec[kChunk * kRec];
  FaceTerms face[kChunk];
};

// Start copying records [0, n) of ``src`` into ``dst`` (n <= kChunk; both
// 16-byte aligned), one 16-byte cp.async per thread per step, as one
// commit group.
__device__ __forceinline__ void load_chunk_async(float* dst, const float* src,
                                                 int n) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  for (int i = threadIdx.x; i < n * (kRec / 4); i += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16u * i),
                 "l"(src + 4 * i));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's copies; a __syncthreads() must follow before any
// thread reads the chunk.
__device__ __forceinline__ void wait_chunk() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The terms of the landed chunk's n faces, one face per thread.
__device__ __forceinline__ void stage_faces(Stage& s, int n, float ox,
                                            float oy, float oz) {
  const int j = threadIdx.x;
  if (j < n) face_terms(s.rec + j * kRec, ox, oy, oz, s.face[j]);
}

}  // namespace pair_math
