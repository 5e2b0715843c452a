// Forward tile compositor: per-entry face records -> pixels.
//
// Replaces: dmesh2_renderer_tpu/ops/pallas_fwd.py::_fwd_kernel (reached via
// composite_forward). For each 16x16 tile it walks the tile's depth-sorted
// entry range [start, start + count) of the (R, 32) record stream and, for
// every (face, pixel) pair, evaluates the per-pixel bbox reject,
// Moeller-Trumbore u, v (factored through scalar triple products), the
// 7-region barycentric clamp, the closed-form AA overlap area with the unit
// pixel box and alpha = op * ((1 - tau) * inside + tau * area); it blends
// front to back and composites the background.
//
// Blend rule (the JAX package is the spec): a face blends iff it passes every
// test AND the transmittance in front of it is >= T_EPS. prev_t is the
// transmittance before the last blended face, n_contrib the 1-based rank (in
// the tile's list) of the last blended face, and nc_tile the tile's largest
// n_contrib.
//
// Bound: arithmetic. A tile's records are shared by its 256 pixels, so the
// kernel sits far above the card's ridge point; what it pays is per-pair
// instructions. The design (pair_math.cuh):
//   * one block per tile, one thread per pixel blending serially -- the
//     layout the TPU kernel was rewritten away from (its log-step
//     prefix-product blend, field-major 128-entry blocks, unaligned head
//     rows and DMA are TPU machinery and are not ported); each warp takes
//     an 8x4 block of the tile's pixels (warp_pixel_x/y);
//   * records staged kChunk (64) at a time with cp.async into one of two
//     shared buffers while the other chunk is composited, so the copy
//     overlaps the arithmetic; the ray-independent per-face terms (edges,
//     cross products, bbox, AA edge reciprocals) are computed once per face
//     when a chunk lands, one face per thread, instead of once per pair;
//   * the bbox is tested before any other per-pair work: most pairs a pixel
//     still needs lie outside the face's bbox and cost a handful of
//     instructions, and a warp with no lane inside skips the rest;
//   * the block stops once no pixel still has T >= T_EPS
//     (__syncthreads_or at each chunk boundary), and each thread stops
//     walking once its own pixel does;
//   * occupancy: 64 registers and 34,820 bytes of static shared memory per
//     block, no spills: four resident 256-thread blocks per SM
//     (__launch_bounds__ asks for two at least).
// Pixels outside the patch (ragged right/bottom tiles) never read ray_d and
// never blend, like the TPU kernel's zero-padded rays.
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

__global__ void __launch_bounds__(kPixels, 2) composite_fwd_kernel(
    const float* __restrict__ records, long long n_records,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const float* __restrict__ ray_o, const float* __restrict__ ray_d,
    const float* __restrict__ bg, const int* __restrict__ patch_min, int H,
    int W, int gx, int gy, float tau, float one_minus_tau,
    float* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ final_t, float* __restrict__ prev_t,
    int* __restrict__ n_contrib, int* __restrict__ nc_tile) {
  __shared__ Stage s[2];
  __shared__ int s_nc;

  const int tile = blockIdx.x;
  const int tiles_per_batch = gx * gy;
  const int b = tile / tiles_per_batch;
  const int rem = tile - b * tiles_per_batch;
  const int ty = rem / gx;
  const int tx = rem - ty * gx;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int x = tx * kTile + warp_pixel_x(warp, lane);
  const int y = ty * kTile + warp_pixel_y(warp, lane);
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
  const float* src = records + start * kRec;

  float T = 1.0f, pt = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, cd = 0.0f;
  int nc = 0;
  if (threadIdx.x == 0) s_nc = 0;

  if (count > 0) {
    const int n0 = (int)(count < kChunk ? count : kChunk);
    load_chunk_async(s[0].rec, src, n0);
    wait_chunk();
    __syncthreads();
    stage_faces(s[0], n0, ox, oy, oz);
  }
  int buf = 0;
  for (long long base = 0; base < count; base += kChunk, buf ^= 1) {
    // The chunk's faces are staged; every reader of the other buffer is done.
    __syncthreads();
    const int n = (int)(count - base < kChunk ? count - base : kChunk);
    const long long next = base + kChunk;
    const int n_next = (int)(next >= count ? 0 : (count - next < kChunk ? count - next : kChunk));
    if (n_next > 0) load_chunk_async(s[buf ^ 1].rec, src + next * kRec, n_next);

    if (in_patch && T >= kTEps) {
      const Stage& st = s[buf];
      for (int j = 0; j < n; ++j) {
        if (T < kTEps) break;
        const float* rec = st.rec + j * kRec;
        Pair q;
        if (!pair_quantities(st.face[j], rec, rdx, rdy, rdz, px0, py0, tau,
                             one_minus_tau, q))
          continue;

        const Interp si = interpolate(rec, q.uc, q.vc);
        const float intense = rec[kIn];
        const float alpha = rec[kOp] * q.ratio;
        const float wgt = alpha * T;
        cr = cr + (si.m_r * intense) * wgt;
        cg = cg + (si.m_g * intense) * wgt;
        cb = cb + (si.m_b * intense) * wgt;
        cd = cd + si.i_d * wgt;
        pt = T;
        T = T * (1.0f - alpha);
        nc = (int)(base + j) + 1;
      }
    }

    if (n_next == 0) break;
    wait_chunk();
    // Whole-tile early exit: stop once no pixel can still blend.
    if (!__syncthreads_or(in_patch && T >= kTEps)) break;
    stage_faces(s[buf ^ 1], n_next, ox, oy, oz);
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

// Registers, static and dynamic shared memory, local (spill) bytes per
// thread and resident 256-thread blocks per SM of the kernel, into out[5].
extern "C" int composite_fwd_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, composite_fwd_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, composite_fwd_kernel,
                                                      kPixels, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = 0;
  out[3] = (int)a.localSizeBytes;
  out[4] = blocks;
  return (int)err;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
