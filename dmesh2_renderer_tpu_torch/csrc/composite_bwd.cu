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
// Layout: the forward's (composite_fwd.cu): one block per tile, one thread
// per pixel replaying serially, records staged in shared memory kChunk at a
// time. Per entry the 29 fields are summed over the block: warp shuffles
// (skipped by a warp with no blending pixel), one partial per warp in shared
// memory (double-buffered, so one __syncthreads per entry), then warp 0 sums
// the partials, one lane per column, runs the epilogue and writes the row
// with one coalesced 128-byte store. Pixels outside the patch contribute
// zero. The TPU kernel's field-major 128-entry blocks, unaligned head rows
// with their read-modify-write, log-step blend scan, subchunks and zero-block
// tail loop are TPU machinery and are not ported: each tile owns exactly
// its rows [start, start + count).
//
// The replay must take the forward's blend decisions bit for bit, or a
// pixel's blended set stops matching its final_t and prev_t: the per-pair
// arithmetic comes from pair_math.cuh, shared with composite_fwd.cu, and
// both are built with -fmad=false.
//
// Bound: arithmetic. Each blending (entry, pixel) pair costs the forward's
// per-pair work again plus ~110 float operations of gradient fields (~150
// more for the AA weights at tau > 0), and each entry a 29-column block sum;
// the bytes are the contributing records, the (R, 32) output and 14 floats
// per pixel.

#include "pair_math.cuh"

namespace {

using namespace pair_math;

constexpr int kChunk = 64;
constexpr int kWarps = kPixels / 32;
constexpr int kFields = 29;

// Per-pixel fields, in the order of their block sums: the moments M_ab,
// M_a3, M_b1 (x, y, z each); the columns that are plain sums (vertex
// colours, opacity, intensity, vertex z: output columns 9..22); the AA edge
// weights j1_0, j2_0, j1_1, j2_1, j1_2, j2_2 times dL/d area.
constexpr int kMab = 0, kMa3 = 3, kMb1 = 6, kDirect = 9, kDop = 18,
              kDint = 19, kDz = 20, kJ = 23;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kPixels) composite_bwd_kernel(
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
  __shared__ float4 s_rec[kChunk * kRec / 4];
  __shared__ float s_part[2][kWarps][32];
  __shared__ float s_red[32];

  const int tile = blockIdx.x;
  const int tiles_per_batch = gx * gy;
  const int b = tile / tiles_per_batch;
  const int rem = tile - b * tiles_per_batch;
  const int ty = rem / gx;
  const int tx = rem - ty * gx;
  const int x = tx * kTile + (int)threadIdx.x % kTile;
  const int y = ty * kTile + (int)threadIdx.x / kTile;
  const bool in_patch = x < W && y < H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

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

  float T = 1.0f;
  float p_r = 0.0f, p_g = 0.0f, p_b = 0.0f, p_d = 0.0f;
  int parity = 0;

  for (long long base = 0; base < n_loop; base += kChunk) {
    __syncthreads();  // every reader of the previous chunk is done
    const int n = (int)(n_loop - base < kChunk ? n_loop - base : kChunk);
    const float4* src = reinterpret_cast<const float4*>(records + (start + base) * kRec);
    for (int i = threadIdx.x; i < n * (kRec / 4); i += kPixels) s_rec[i] = src[i];
    __syncthreads();
    const float* rec_base = reinterpret_cast<const float*>(s_rec);

    for (int j = 0; j < n; ++j) {
      const float* rec = rec_base + j * kRec;
      float f[kFields];
#pragma unroll
      for (int c = 0; c < kFields; ++c) f[c] = 0.0f;
      bool active = false;

      if (in_patch && T >= kTEps) {
        const Pair q = pair_quantities(rec, ox, oy, oz, rdx, rdy, rdz, px0,
                                       py0, tau, one_minus_tau);
        if (q.passes) {
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
          for (int vi = 0; vi < 3; ++vi) {
            f[kDirect + 3 * vi + 0] = (ik[vi] * dic_r) * intense;
            f[kDirect + 3 * vi + 1] = (ik[vi] * dic_g) * intense;
            f[kDirect + 3 * vi + 2] = (ik[vi] * dic_b) * intense;
            f[kDz + vi] = ik[vi] * did;
          }
          f[kDop] = dl_da * q.ratio;
          f[kDint] = s.m_r * dic_r + s.m_g * dic_g + s.m_b * dic_b;

          // Barycentric chain, clamp Jacobian, Moeller-Trumbore moments.
          float dl_di[3];
#pragma unroll
          for (int vi = 0; vi < 3; ++vi)
            dl_di[vi] = (rec[kC + 3 * vi] * dic_r + rec[kC + 3 * vi + 1] * dic_g +
                         rec[kC + 3 * vi + 2] * dic_b) * intense +
                        rec[kZ + vi] * did;
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
              const int e1 = e == 2 ? 0 : e + 1;
              float j1, j2;
              edge_weights(rec[kAA + 2 * e], rec[kAA + 2 * e + 1],
                           rec[kAA + 2 * e1], rec[kAA + 2 * e1 + 1], px0, px1,
                           py0, py1, j1, j2);
              f[kJ + 2 * e] = dl_doarea * j1;
              f[kJ + 2 * e + 1] = dl_doarea * j2;
            }
          }
        }
      }

      // Block sum of the fields: warps, then one partial per warp.
      if (__any_sync(0xffffffffu, active)) {
#pragma unroll
        for (int c = 0; c < kFields; ++c) f[c] = warp_sum(f[c]);
      }
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kFields; ++c) s_part[parity][warp][c] = f[c];
      }
      __syncthreads();

      if (warp == 0) {
        float v = 0.0f;
        if (lane < kFields) {
#pragma unroll
          for (int w = 0; w < kWarps; ++w) v += s_part[parity][w][lane];
        }
        s_red[lane] = v;
        __syncwarp();

        // Epilogue: one output column per lane.
        float o = 0.0f;
        if (lane < 9) {
          // dp_vi[k] from cross(a, b)[k] = a[k1] b[k2] - a[k2] b[k1].
          const int vi = lane / 3, k = lane - 3 * (lane / 3);
          const int k1 = k == 2 ? 0 : k + 1, k2 = k == 0 ? 2 : k - 1;
          const float o1 = k1 == 0 ? ox : (k1 == 1 ? oy : oz);
          const float o2 = k2 == 0 ? ox : (k2 == 1 ? oy : oz);
          const float e1_1 = rec[kV + 3 + k1] - rec[kV + k1];
          const float e1_2 = rec[kV + 3 + k2] - rec[kV + k2];
          const float e2_1 = rec[kV + 6 + k1] - rec[kV + k1];
          const float e2_2 = rec[kV + 6 + k2] - rec[kV + k2];
          const float t0_1 = o1 - rec[kV + k1];
          const float t0_2 = o2 - rec[kV + k2];
          const float* m_ab = s_red + kMab;
          const float* m_a3 = s_red + kMa3;
          const float* m_b1 = s_red + kMb1;
          const float c_ab_e2 = m_ab[k1] * e2_2 - m_ab[k2] * e2_1;
          const float c_t0_b1 = t0_1 * m_b1[k2] - t0_2 * m_b1[k1];
          const float c_t0_a3 = t0_1 * m_a3[k2] - t0_2 * m_a3[k1];
          const float c_e1_ab = e1_1 * m_ab[k2] - e1_2 * m_ab[k1];
          const float c_a3_e2 = m_a3[k1] * e2_2 - m_a3[k2] * e2_1;
          const float c_e1_b1 = e1_1 * m_b1[k2] - e1_2 * m_b1[k1];
          const float dp1 = -c_ab_e2 - c_t0_b1;
          const float dp2 = c_t0_a3 - c_e1_ab;
          const float dp0 = -dp1 - dp2 - c_a3_e2 - c_e1_b1;
          o = vi == 0 ? dp0 : (vi == 1 ? dp1 : dp2);
        } else if (lane < kJ) {
          o = s_red[lane];
        } else if (lane < kFields && tau > 0.0f) {
          // Corner k: edge k -> k+1 leaves it (weight j1), edge k-1 -> k
          // enters it (weight j2); (dy, -dx) of each edge.
          const int k = (lane - kJ) / 2;
          const int kn = k == 2 ? 0 : k + 1, kp = k == 0 ? 2 : k - 1;
          const float r1 = s_red[kJ + 2 * k], r2 = s_red[kJ + 2 * kp + 1];
          if ((lane - kJ) % 2 == 0) {
            const float dyo = rec[kAA + 2 * kn + 1] - rec[kAA + 2 * k + 1];
            const float dyi = rec[kAA + 2 * k + 1] - rec[kAA + 2 * kp + 1];
            o = dyo * r1 + dyi * r2;
          } else {
            const float dxo = rec[kAA + 2 * kn] - rec[kAA + 2 * k];
            const float dxi = rec[kAA + 2 * k] - rec[kAA + 2 * kp];
            o = -dxo * r1 - dxi * r2;
          }
        }
        out[(start + base + j) * kRec + lane] = o;
        __syncwarp();
      }
      parity ^= 1;
    }
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
  composite_bwd_kernel<<<(unsigned)n_tiles, kPixels, 0, (cudaStream_t)stream>>>(
      (const float*)records, n_records, (const int*)tile_starts,
      (const int*)tile_counts, (const int*)nc_tile, (const float*)ray_o,
      (const float*)ray_d, (const float*)bg, (const int*)patch_min,
      (const float*)color, (const float*)depth, (const float*)final_t,
      (const float*)prev_t, (const float*)g_color, (const float*)g_depth,
      (const float*)g_final_t, H, W, gx, gy, tau, one_minus_tau,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
