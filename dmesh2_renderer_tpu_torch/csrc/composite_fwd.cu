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
// Built with -fmad=false: every expression below and in pair_math.cuh (the
// per-pair arithmetic, shared with the backward compositor composite_bwd.cu)
// is written in the operation order of the plain PyTorch version
// (ops/composite_fwd.py), which runs one rounded operation at a time, so
// kernel and plain version agree to the bit and the clamp region codes at
// boundaries resolve identically.

#include "pair_math.cuh"

namespace {

using namespace pair_math;

constexpr int kChunk = 64;

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
        const Pair q = pair_quantities(rec, ox, oy, oz, rdx, rdy, rdz, px0,
                                       py0, tau, one_minus_tau);
        if (!q.passes) continue;

        const Interp s = interpolate(rec, q.uc, q.vc);
        const float intense = rec[kIn];
        const float alpha = rec[kOp] * q.ratio;
        const float wgt = alpha * T;
        cr = cr + (s.m_r * intense) * wgt;
        cg = cg + (s.m_g * intense) * wgt;
        cb = cb + (s.m_b * intense) * wgt;
        cd = cd + s.i_d * wgt;
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
