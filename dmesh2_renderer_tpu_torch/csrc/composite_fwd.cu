// Forward tile compositor: per-entry face records -> pixels.
//
// Replaces: dmesh2_renderer_tpu/ops/pallas_fwd.py::_fwd_kernel (reached via
// composite_forward). For each 16x16 tile it walks the tile's depth-sorted
// entry range [start, start + count) of the (R, 32) record stream and, for
// every (face, pixel) pair, evaluates Moeller-Trumbore u, v (factored
// through scalar triple products), the 7-region barycentric clamp, the
// per-pixel bbox reject, the closed-form AA overlap area with the unit pixel
// box and alpha = op * ((1 - tau) * inside + tau * area); it blends front to
// back and composites the background.
//
// Blend rule (the JAX package is the spec): a face blends iff it passes every
// test AND the transmittance in front of it is >= T_EPS. prev_t is the
// transmittance before the last blended face, n_contrib the 1-based rank (in
// the tile's list) of the last blended face, and nc_tile the tile's largest
// n_contrib.
//
// Layout: one block per tile, one thread per pixel, each thread blending
// serially -- the layout the TPU kernel was rewritten away from (its
// log-step prefix-product blend, field-major 128-entry blocks, unaligned head
// rows and double-buffered DMA are TPU machinery and are not ported). The
// block stages kChunk records (8 KB) in shared memory per round with
// coalesced 16-byte loads; every thread of a warp then reads the same record
// word (a broadcast). The block stops once no pixel still has T >= T_EPS
// (__syncthreads_or). Pixels outside the patch (ragged right/bottom tiles)
// never read ray_d and never blend, like the TPU kernel's zero-padded rays.
//
// Bound: arithmetic. Each (face, pixel) pair costs ~150 float operations of
// pixel-dependent work (the AA area alone ~100) against 128 bytes of record
// per face shared by 256 pixels, so the kernel sits far above the card's
// ridge point; the early exit is what limits the pairs evaluated. This first
// version keeps the per-face terms (edge reciprocals, cross products) in each
// thread's arithmetic rather than precomputing them per face.
//
// Built with -fmad=false: every expression below is written in the operation
// order of the plain PyTorch version (ops/composite_fwd.py), which runs one
// rounded operation at a time, so kernel and plain version agree to the bit
// and the clamp region codes at boundaries resolve identically.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kRec = 32;
constexpr int kChunk = 64;
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

__global__ void __launch_bounds__(kPixels) composite_fwd_kernel(
    const float* __restrict__ records, long long n_records,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ bg, const int* __restrict__ patch_min, int H,
    int W, int gx, int gy, float tau, float one_minus_tau,
    float* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ final_t, float* __restrict__ prev_t,
    int* __restrict__ n_contrib, int* __restrict__ nc_tile) {
  __shared__ float4 s_rec[kChunk * kRec / 4];
  __shared__ int s_nc;

  const int tile = blockIdx.x;
  const int tiles_per_batch = gx * gy;
  const int b = tile / tiles_per_batch;
  const int rem = tile - b * tiles_per_batch;
  const int ty = rem / gx;
  const int tx = rem - ty * gx;
  const int lx = threadIdx.x % kTile;
  const int ly = threadIdx.x / kTile;
  const int x = tx * kTile + lx;
  const int y = ty * kTile + ly;
  const bool in_patch = x < W && y < H;

  // Pixel box min corner: integer image coordinates (rays go through the
  // pixel centres, the AA box spans [px0, px0 + 1]).
  const float px0 = (float)(patch_min[2 * b] + x);
  const float py0 = (float)(patch_min[2 * b + 1] + y);
  const float ox = ray_o[3 * b], oy = ray_o[3 * b + 1], oz = ray_o[3 * b + 2];
  float rdx = 0.0f, rdy = 0.0f, rdz = 0.0f;
  long long pix = 0;
  if (in_patch) {
    pix = ((long long)b * H + y) * W + x;
    rdx = ray_d[3 * pix];
    rdy = ray_d[3 * pix + 1];
    rdz = ray_d[3 * pix + 2];
  }

  const long long start = tile_starts[tile];
  long long count = tile_counts[tile];
  if (start + count > n_records) count = n_records - start;

  float T = 1.0f, pt = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  int nc = 0;
  if (threadIdx.x == 0) s_nc = 0;

  for (long long base = 0; base < count; base += kChunk) {
    // Whole-tile early exit: stop once no pixel can still blend.
    if (!__syncthreads_or(in_patch && T >= kTEps)) break;
    const int n = (int)(count - base < kChunk ? count - base : kChunk);
    const float4* src = reinterpret_cast<const float4*>(records + (start + base) * kRec);
    for (int i = threadIdx.x; i < n * (kRec / 4); i += kPixels) s_rec[i] = src[i];
    __syncthreads();

    if (in_patch && T >= kTEps) {
      const float* rec_base = reinterpret_cast<const float*>(s_rec);
      for (int j = 0; j < n; ++j) {
        if (T < kTEps) break;
        const float* rec = rec_base + j * kRec;
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
        const float inv = 1.0f / (mt_ok ? denom : 1.0f);
        const float u = (mx_ * rdx + my_ * rdy + mz_ * rdz) * inv;
        const float v = (qx * rdx + qy * rdy + qz * rdz) * inv;

        // 7-region clamp (geometry.py::clamp_bary_uv); tests in this order.
        const bool inside = (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f);
        const bool c1 = (u <= 0.0f) && (v <= 0.0f);
        const bool c2 = ((u >= 1.0f) && (v <= 0.0f)) || ((v >= 0.0f) && (v <= u - 1.0f));
        const bool c3 = ((u <= 0.0f) && (v >= 1.0f)) || ((u >= 0.0f) && (v >= u + 1.0f));
        const bool c4 = (u <= 0.0f) && (v <= 1.0f) && (v >= 0.0f);
        const bool c5 = (u <= 1.0f) && (u >= 0.0f) && (v <= 0.0f);
        float uc, vc;
        if (inside) { uc = u; vc = v; }
        else if (c1) { uc = 0.0f; vc = 0.0f; }
        else if (c2) { uc = 1.0f; vc = 0.0f; }
        else if (c3) { uc = 0.0f; vc = 1.0f; }
        else if (c4) { uc = 0.0f; vc = v; }
        else if (c5) { uc = u; vc = 0.0f; }
        else { uc = (1.0f + u - v) * 0.5f; vc = (1.0f - u + v) * 0.5f; }

        // Per-pixel face-bbox reject.
        const float ax0 = rec[kAA + 0], ay0 = rec[kAA + 1];
        const float ax1 = rec[kAA + 2], ay1 = rec[kAA + 3];
        const float ax2 = rec[kAA + 4], ay2 = rec[kAA + 5];
        const float txmin = mn(mn(ax0, ax1), ax2);
        const float txmax = mx(mx(ax0, ax1), ax2);
        const float tymin = mn(mn(ay0, ay1), ay2);
        const float tymax = mx(mx(ay0, ay1), ay2);
        const float px1 = px0 + 1.0f, py1 = py0 + 1.0f;
        const bool bbox_ok = (px1 >= txmin) && (px0 <= txmax) &&
                             (py1 >= tymin) && (py0 <= tymax);

        const float inside_f = inside ? 1.0f : 0.0f;
        float ratio;
        bool aa_ok = true;
        if (tau > 0.0f) {
          float area = edge_area(ax0, ay0, ax1, ay1, px0, px1, py0, py1) +
                       edge_area(ax1, ay1, ax2, ay2, px0, px1, py0, py1) +
                       edge_area(ax2, ay2, ax0, ay0, px0, px1, py0, py1);
          const float box = (px1 - px0) * (py1 - py0);
          const float oarea = clip(area, 0.0f, box);
          aa_ok = oarea > 0.0f;
          ratio = one_minus_tau * inside_f + tau * oarea;
        } else {
          ratio = inside_f;
        }
        const bool passes = mt_ok && aa_ok && bbox_ok && (ratio != 0.0f);
        if (!passes) continue;

        const float i0 = 1.0f - uc - vc;
        const float intense = rec[kIn];
        const float m_r = i0 * rec[kC + 0] + uc * rec[kC + 3] + vc * rec[kC + 6];
        const float m_g = i0 * rec[kC + 1] + uc * rec[kC + 4] + vc * rec[kC + 7];
        const float m_b = i0 * rec[kC + 2] + uc * rec[kC + 5] + vc * rec[kC + 8];
        const float i_d = i0 * rec[kZ + 0] + uc * rec[kZ + 1] + vc * rec[kZ + 2];
        const float alpha = rec[kOp] * ratio;
        const float wgt = alpha * T;
        cr = cr + (m_r * intense) * wgt;
        cg = cg + (m_g * intense) * wgt;
        cb = cb + (m_b * intense) * wgt;
        cd = cd + i_d * wgt;
        pt = T;
        T = T * (1.0f - alpha);
        nc = (int)(base + j) + 1;
      }
    }
  }

  if (in_patch) {
    color[3 * pix] = cr + T * bg[0];
    color[3 * pix + 1] = cg + T * bg[1];
    color[3 * pix + 2] = cb + T * bg[2];
    depth[pix] = cd + T * 1.0f;
    final_t[pix] = T;
    prev_t[pix] = pt;
    n_contrib[pix] = nc;
  }
  __syncthreads();
  if (nc > 0) atomicMax(&s_nc, nc);
  __syncthreads();
  if (threadIdx.x == 0) nc_tile[tile] = s_nc;
}

}  // namespace

extern "C" int composite_fwd_launch(
    const void* records, long long n_records, const void* tile_starts,
    const void* tile_counts, const void* ray_o, const void* ray_d,
    const void* bg, const void* patch_min, int B, int H, int W, int gx, int gy,
    float tau, float one_minus_tau, void* color, void* depth, void* final_t,
    void* prev_t, void* n_contrib, void* nc_tile, void* stream) {
  const long long n_tiles = (long long)B * gx * gy;
  composite_fwd_kernel<<<(unsigned)n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
      (const float*)records, n_records, (const int*)tile_starts,
      (const int*)tile_counts, (const float*)ray_o, (const float*)ray_d,
      (const float*)bg, (const int*)patch_min, H, W, gx, gy, tau,
      one_minus_tau, (float*)color, (float*)depth, (float*)final_t,
      (float*)prev_t, (int*)n_contrib, (int*)nc_tile);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
