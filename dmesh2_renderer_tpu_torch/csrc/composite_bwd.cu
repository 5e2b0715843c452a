// Backward tile compositor: per-entry gradient records.
//
// Replaces: dmesh2_renderer_tpu/ops/pallas_bwd.py::_bwd_kernel (reached via
// composite_backward). For each 16x16 tile it replays the forward blend
// front to back over the first min(count, nc_tile) entries of the tile's
// range of the (R, 32) record stream (entries past nc_tile blend into no
// pixel, so their records are zero) and writes, for each entry, a 29-column
// gradient record summed over the tile's 256 pixels into that entry's row of
// the (R, 32) output (zero-initialised by the wrapper; columns 29-31 stay
// zero). Columns mirror the face record: dp0, dp1, dp2 (9), vertex colours
// (9), opacity, intensity, vertex NDC z (3), AA corners (6).
//
// Per (entry, pixel) pair (pallas_bwd.py:155-326):
//   * replay: T before the face carried exactly (no division), with the
//     colour/depth prefix sums P; the part behind the face is
//     (C_nobg - P) / T_after, C_nobg = color - final_t * bg, D_n = depth -
//     final_t, known from the forward's outputs;
//   * dL/dalpha from colour and depth, plus the background / final_t term
//     -T_fin / (1 - alpha) * (bg . g_c + g_d + g_T), which is -prev_T *
//     (...) when alpha == 1 (then T_fin == 0 and the face is the last);
//   * the per-pixel fields: 9 vertex-colour, opacity, intensity and 3
//     vertex-z gradients, the three Moeller-Trumbore moments sum(s * ray_d)
//     of s_ab, s_a3, s_b1 (the Jacobian of u, v is a pixel scalar times a
//     cross product of ray_d with a face vector, so only these moments need
//     the pixel sum), and at tau > 0 the six AA edge weights j1, j2 of
//     tri_box_edge_weights_xy times dL/d area = dL/dalpha * op * tau.
// The per-entry epilogue turns the moments into dp0, dp1, dp2 by cross
// products with e1, e2, t0, and the edge weights into AA-corner gradients
// with the face's edge deltas.
//
// Bound: arithmetic -- the forward's per-pair work again, the gradient
// fields of each blending pair, and a 29-column sum over 256 pixels per
// entry; the bytes (contributing records, the (R, 32) output, 14 floats per
// pixel) are a small part. The design:
//   * the forward's layout and staging (pair_math.cuh): one block per tile,
//     one thread per pixel replaying serially, a warp per 8x4 pixels;
//     records in chunks of kChunk
//     copied with cp.async into one of two shared buffers while the other is
//     replayed; per-face terms (edges, origin offset, cross products, bbox,
//     AA edge reciprocals) computed once per face when a chunk lands; the
//     bbox tested before any other per-pair work, so a warp with no lane
//     inside the face's bbox skips the pair;
//   * the block sum, batched: per entry each warp runs one transposed
//     (reduce-scatter) butterfly over its 32 field slots (29 columns and 3
//     zeros): at each step a lane keeps half of its values and adds the
//     partner's copy of them, 16 + 8 + 4 + 2 + 1 = 31 shuffles in all, and
//     lane c ends with the warp's sum of column c. A warp with no blending
//     pixel skips the butterfly. Each warp stores that one float per lane
//     for entry g of a group of kGroup (8) entries; one __syncthreads per
//     group; then warp w sums entry w's 8 warp partials, in warp order,
//     runs its epilogue (one column per lane, cross-lane terms by shuffle)
//     and writes its 128-byte row, while the other warps' epilogues run
//     beside it. The partials are double-buffered per group, so the group
//     barrier is the only one. Every entry of the prefix gets its row, a
//     zero row when no pixel of the tile blends it;
//   * deterministic output: every sum runs in a fixed order (the butterfly's
//     pairing, then warps 0..7), no atomics, so the table has the same bits
//     on every run;
//   * occupancy: 50 KB of dynamic shared memory per block (two stages of
//     17 KB and the 16 KB of partials, allowed above 48 KB by the launch
//     function) and __launch_bounds__(256, 3): 80 registers with 12 bytes
//     spilled, three resident blocks per SM. Capped for two blocks it uses
//     90 registers and spills nothing, and runs ~10% slower on the 1080p
//     headline (compositor_variants.py; the numbers are in PERF.md).
// Pixels outside the patch contribute zero. The TPU kernel's field-major
// 128-entry blocks, unaligned head rows with their read-modify-write,
// log-step blend scan, subchunks and zero-block tail loop are TPU machinery
// and are not ported: each tile owns exactly its rows [start, start + count).
//
// The replay must take the forward's blend decisions bit for bit, or a
// pixel's blended set stops matching its final_t and prev_t: the per-pair
// arithmetic comes from pair_math.cuh, shared with composite_fwd.cu, and
// both are built with -fmad=false.

#include "pair_math.cuh"

namespace {

using namespace pair_math;

constexpr int kWarps = kPixels / 32;
constexpr int kFields = 29;
constexpr int kGroup = kWarps;  // entries per block barrier
static_assert(kChunk % kGroup == 0, "a group never straddles two chunks");

// Per-pixel fields, in the order of their block sums: the moments M_ab,
// M_a3, M_b1 (x, y, z each); the columns that are plain sums (vertex
// colours, opacity, intensity, vertex z: output columns 9..22); the AA edge
// weights j1_0, j2_0, j1_1, j2_1, j1_2, j2_2 times dL/d area.
constexpr int kMab = 0, kMa3 = 3, kMb1 = 6, kDirect = 9, kDop = 18,
              kDint = 19, kDz = 20, kJ = 23;

struct Shared {
  Stage stage[2];
  float part[2][kGroup][kWarps][32];  // [group parity][entry][warp][column]
};

// One step of the transposed butterfly: a lane keeps the half of v[0, 2 *
// kHalf) its lane bit kHalf selects, plus the partner's copy of it, in
// v[0, kHalf). Constant bounds keep v in registers.
template <int kHalf>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

// Transposed butterfly: on return, lane c holds the sum over the warp's
// lanes of v[c].
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[32], int lane) {
  reduce_scatter_step<16>(v, lane);
  reduce_scatter_step<8>(v, lane);
  reduce_scatter_step<4>(v, lane);
  reduce_scatter_step<2>(v, lane);
  reduce_scatter_step<1>(v, lane);
  return v[0];
}

__global__ void __launch_bounds__(kPixels, 3) composite_bwd_kernel(
    const float* __restrict__ records, long long n_records,
    const int* __restrict__ tile_starts, const int* __restrict__ tile_counts,
    const int* __restrict__ nc_tile, const float* __restrict__ ray_o,
    const float* __restrict__ ray_d, const float* __restrict__ bg,
    const int* __restrict__ patch_min, const float* __restrict__ color,
    const float* __restrict__ depth, const float* __restrict__ final_t,
    const float* __restrict__ prev_t, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_final_t,
    int H, int W, int gx, int gy, float tau, float one_minus_tau,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);

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

  const float px0 = (float)(patch_min[2 * b] + x);
  const float py0 = (float)(patch_min[2 * b + 1] + y);
  const float px1 = px0 + 1.0f, py1 = py0 + 1.0f;
  const float ox = ray_o[3 * b], oy = ray_o[3 * b + 1], oz = ray_o[3 * b + 2];
  float rdx = 0.0f, rdy = 0.0f, rdz = 0.0f;
  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f, g_d = 0.0f, g_t = 0.0f;
  float cn_r = 0.0f, cn_g = 0.0f, cn_b = 0.0f, dn = 0.0f;
  float t_fin = 0.0f, pt_fin = 0.0f;
  if (in_patch) {
    const long long pix = ((long long)b * H + y) * W + x;
    rdx = ray_d[3 * pix];
    rdy = ray_d[3 * pix + 1];
    rdz = ray_d[3 * pix + 2];
    g_r = g_color[3 * pix];
    g_g = g_color[3 * pix + 1];
    g_b = g_color[3 * pix + 2];
    g_d = g_depth[pix];
    g_t = g_final_t[pix];
    t_fin = final_t[pix];
    pt_fin = prev_t[pix];
    cn_r = color[3 * pix] - t_fin * bg[0];
    cn_g = color[3 * pix + 1] - t_fin * bg[1];
    cn_b = color[3 * pix + 2] - t_fin * bg[2];
    dn = depth[pix] - t_fin;
  }
  const float bg_dot = bg[0] * g_r + bg[1] * g_g + bg[2] * g_b + g_d + g_t;

  const long long start = tile_starts[tile];
  long long count = tile_counts[tile];
  if (start + count > n_records) count = n_records - start;
  const long long ncmax = nc_tile[tile] > 0 ? nc_tile[tile] : 0;
  const long long n_loop = count < ncmax ? count : ncmax;
  const float* src = records + start * kRec;

  float T = 1.0f;
  float p_r = 0.0f, p_g = 0.0f, p_b = 0.0f, p_d = 0.0f;
  int parity = 0;

  if (n_loop > 0) {
    const int n0 = (int)(n_loop < kChunk ? n_loop : kChunk);
    load_chunk_async(sh.stage[0].rec, src, n0);
    wait_chunk();
    __syncthreads();
    stage_faces(sh.stage[0], n0, ox, oy, oz);
  }
  int buf = 0;
  for (long long base = 0; base < n_loop; base += kChunk, buf ^= 1) {
    // The chunk's faces are staged; every reader of the other buffer is done.
    __syncthreads();
    const int n = (int)(n_loop - base < kChunk ? n_loop - base : kChunk);
    const long long next = base + kChunk;
    const int n_next = (int)(next >= n_loop ? 0 : (n_loop - next < kChunk ? n_loop - next : kChunk));
    if (n_next > 0) load_chunk_async(sh.stage[buf ^ 1].rec, src + next * kRec, n_next);
    const Stage& st = sh.stage[buf];

    for (int g0 = 0; g0 < n; g0 += kGroup) {
      const int g_end = n - g0 < kGroup ? n - g0 : kGroup;
      for (int g = 0; g < g_end; ++g) {
        const int j = g0 + g;
        const float* rec = st.rec + j * kRec;
        float f[32];
#pragma unroll
        for (int c = 0; c < 32; ++c) f[c] = 0.0f;
        bool active = false;
        Pair q;

        if (in_patch && T >= kTEps &&
            pair_quantities(st.face[j], rec, rdx, rdy, rdz, px0, py0, tau,
                            one_minus_tau, q)) {
          active = true;
          // Replay: the forward's blend with its prefix sums.
          const Interp s = interpolate(rec, q.uc, q.vc);
          const float intense = rec[kIn];
          const float alpha = rec[kOp] * q.ratio;
          const float wgt = alpha * T;
          const float ic_r = s.m_r * intense;
          const float ic_g = s.m_g * intense;
          const float ic_b = s.m_b * intense;
          p_r = p_r + ic_r * wgt;
          p_g = p_g + ic_g * wgt;
          p_b = p_b + ic_b * wgt;
          p_d = p_d + s.i_d * wgt;
          const float t_before = T;
          const float t_after = T * (1.0f - alpha);
          T = t_after;

          // dL/dalpha.
          const float inv_after = t_after > 0.0f ? 1.0f / t_after : 0.0f;
          const float ar_r = (cn_r - p_r) * inv_after;
          const float ar_g = (cn_g - p_g) * inv_after;
          const float ar_b = (cn_b - p_b) * inv_after;
          const float ar_d = (dn - p_d) * inv_after;
          float dl_da = t_before * ((ic_r - ar_r) * g_r + (ic_g - ar_g) * g_g +
                                    (ic_b - ar_b) * g_b + (s.i_d - ar_d) * g_d);
          const float bg_fac = alpha < 1.0f ? -t_fin / (1.0f - alpha) : -pt_fin;
          dl_da = dl_da + bg_fac * bg_dot;

          // Colour, depth, intensity and opacity fields.
          const float dic_r = g_r * wgt, dic_g = g_g * wgt, dic_b = g_b * wgt;
          const float did = g_d * wgt;
          const float i0 = 1.0f - q.uc - q.vc;
          const float ik[3] = {i0, q.uc, q.vc};
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            f[kDirect + 3 * v + 0] = (ik[v] * dic_r) * intense;
            f[kDirect + 3 * v + 1] = (ik[v] * dic_g) * intense;
            f[kDirect + 3 * v + 2] = (ik[v] * dic_b) * intense;
            f[kDz + v] = ik[v] * did;
          }
          f[kDop] = dl_da * q.ratio;
          f[kDint] = s.m_r * dic_r + s.m_g * dic_g + s.m_b * dic_b;

          // Barycentric chain, clamp Jacobian, Moeller-Trumbore moments.
          float dl_di[3];
#pragma unroll
          for (int v = 0; v < 3; ++v)
            dl_di[v] = (rec[kC + 3 * v] * dic_r + rec[kC + 3 * v + 1] * dic_g +
                        rec[kC + 3 * v + 2] * dic_b) * intense +
                       rec[kZ + v] * did;
          float duc_du = 0.0f, duc_dv = 0.0f, dvc_du = 0.0f, dvc_dv = 0.0f;
          if (q.code == 0) { duc_du = 1.0f; dvc_dv = 1.0f; }
          else if (q.code == 4) { dvc_dv = 1.0f; }
          else if (q.code == 5) { duc_du = 1.0f; }
          else if (q.code == 6) {
            duc_du = 0.5f; dvc_dv = 0.5f; duc_dv = -0.5f; dvc_du = -0.5f;
          }
          const float dl_duc = dl_di[1] - dl_di[0];
          const float dl_dvc = dl_di[2] - dl_di[0];
          const float dl_du = dl_duc * duc_du + dl_dvc * dvc_du;
          const float dl_dv = dl_duc * duc_dv + dl_dvc * dvc_dv;
          const float sm[3] = {(dl_du * q.u + dl_dv * q.v) * q.inv,
                               dl_du * q.inv, dl_dv * q.inv};
#pragma unroll
          for (int m = 0; m < 3; ++m) {
            f[kMab + 3 * m + 0] = sm[m] * rdx;
            f[kMab + 3 * m + 1] = sm[m] * rdy;
            f[kMab + 3 * m + 2] = sm[m] * rdz;
          }

          // AA edge weights (shape derivative of the overlap area).
          if (tau > 0.0f) {
            const float dl_doarea = (dl_da * rec[kOp]) * tau;
#pragma unroll
            for (int e = 0; e < 3; ++e) {
              float j1, j2;
              edge_weights(st.face[j], rec + kAA, e, px0, px1, py0, py1, j1, j2);
              f[kJ + 2 * e] = dl_doarea * j1;
              f[kJ + 2 * e + 1] = dl_doarea * j2;
            }
          }
        }

        // This warp's sum of column `lane`, for entry g of the group.
        float col = 0.0f;
        if (__any_sync(0xffffffffu, active)) col = warp_reduce_scatter(f, lane);
        sh.part[parity][g][warp][lane] = col;
      }
      __syncthreads();

      // Warp w: entry g0 + w's block sum and epilogue.
      const int j = g0 + warp;
      if (j < n) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += sh.part[parity][warp][w][lane];
        const FaceTerms& fc = st.face[j];
        // Lane roles. Lanes 0..8: dp_vi[k] from cross(a, b)[k] = a[k1] b[k2]
        // - a[k2] b[k1]. Lanes 23..28: AA corner ck, edge ck -> ck+1 leaves
        // it (weight j1), edge ck-1 -> ck enters it (weight j2).
        const int vi = lane / 3, k = lane - 3 * (lane / 3);
        const int k1 = k == 2 ? 0 : k + 1, k2 = k == 0 ? 2 : k - 1;
        const int ck = lane >= kJ ? (lane - kJ) / 2 : 0;
        const int ckp = ck == 0 ? 2 : ck - 1;
        const float ab1 = __shfl_sync(0xffffffffu, v, kMab + k1);
        const float ab2 = __shfl_sync(0xffffffffu, v, kMab + k2);
        const float a31 = __shfl_sync(0xffffffffu, v, kMa3 + k1);
        const float a32 = __shfl_sync(0xffffffffu, v, kMa3 + k2);
        const float b11 = __shfl_sync(0xffffffffu, v, kMb1 + k1);
        const float b12 = __shfl_sync(0xffffffffu, v, kMb1 + k2);
        const float r1 = __shfl_sync(0xffffffffu, v, kJ + 2 * ck);
        const float r2 = __shfl_sync(0xffffffffu, v, kJ + 2 * ckp + 1);
        float o = 0.0f;
        if (lane < 9) {
          const float e1_1 = fc.e1[k1], e1_2 = fc.e1[k2];
          const float e2_1 = fc.e2[k1], e2_2 = fc.e2[k2];
          const float t0_1 = fc.t0[k1], t0_2 = fc.t0[k2];
          const float c_ab_e2 = ab1 * e2_2 - ab2 * e2_1;
          const float c_t0_b1 = t0_1 * b12 - t0_2 * b11;
          const float c_t0_a3 = t0_1 * a32 - t0_2 * a31;
          const float c_e1_ab = e1_1 * ab2 - e1_2 * ab1;
          const float c_a3_e2 = a31 * e2_2 - a32 * e2_1;
          const float c_e1_b1 = e1_1 * b12 - e1_2 * b11;
          const float dp1 = -c_ab_e2 - c_t0_b1;
          const float dp2 = c_t0_a3 - c_e1_ab;
          const float dp0 = -dp1 - dp2 - c_a3_e2 - c_e1_b1;
          o = vi == 0 ? dp0 : (vi == 1 ? dp1 : dp2);
        } else if (lane < kJ) {
          o = v;
        } else if (lane < kFields && tau > 0.0f) {
          // (dy, -dx) of the edge leaving corner ck and of the edge entering it.
          if ((lane - kJ) % 2 == 0) {
            o = fc.dy[ck] * r1 + fc.dy[ckp] * r2;
          } else {
            o = -fc.dx[ck] * r1 - fc.dx[ckp] * r2;
          }
        }
        out[(start + base + j) * kRec + lane] = o;
      }
      parity ^= 1;
    }

    if (n_next == 0) break;
    wait_chunk();
    __syncthreads();
    stage_faces(sh.stage[buf ^ 1], n_next, ox, oy, oz);
  }
}

}  // namespace

extern "C" int composite_bwd_launch(
    const void* records, long long n_records, const void* tile_starts,
    const void* tile_counts, const void* nc_tile, const void* ray_o,
    const void* ray_d, const void* bg, const void* patch_min,
    const void* color, const void* depth, const void* final_t,
    const void* prev_t, const void* g_color, const void* g_depth,
    const void* g_final_t, int B, int H, int W, int gx, int gy, float tau,
    float one_minus_tau, void* out, void* stream) {
  const long long n_tiles = (long long)B * gx * gy;
  // Above 48 KB, dynamic shared memory must be allowed per kernel.
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Shared));
  if (err != cudaSuccess) return (int)err;
  composite_bwd_kernel<<<(unsigned)n_tiles, kPixels, sizeof(Shared),
                         (cudaStream_t)stream>>>(
      (const float*)records, n_records, (const int*)tile_starts,
      (const int*)tile_counts, (const int*)nc_tile, (const float*)ray_o,
      (const float*)ray_d, (const float*)bg, (const int*)patch_min,
      (const float*)color, (const float*)depth, (const float*)final_t,
      (const float*)prev_t, (const float*)g_color, (const float*)g_depth,
      (const float*)g_final_t, H, W, gx, gy, tau, one_minus_tau,
      (float*)out);
  return (int)cudaGetLastError();
}

// Registers, static and dynamic shared memory, local (spill) bytes per
// thread and resident 256-thread blocks per SM of the kernel, into out[5].
extern "C" int composite_bwd_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Shared));
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, composite_bwd_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, composite_bwd_kernel, kPixels, sizeof(Shared));
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = (int)sizeof(Shared);
  out[3] = (int)a.localSizeBytes;
  out[4] = blocks;
  return (int)err;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
