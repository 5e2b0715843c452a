// Backward tile compositor: per-entry gradient records.
//
// Replaces: dmesh2_renderer_tpu/ops/pallas_bwd.py::_bwd_kernel (reached via
// composite_backward). For each 16x16 tile it replays the forward blend
// front to back over the first min(count, nc_tile) entries of the tile's
// range of the (R, 32) record stream (entries past nc_tile blend into no
// pixel, so their records are zero) and writes, for each entry, a 29-column
// gradient record summed over the tile's 256 pixels into that entry's row of
// the (R, 32) output (columns 29-31 stay zero). Columns mirror the face
// record: dp0, dp1, dp2 (9), vertex colours (9), opacity, intensity, vertex
// NDC z (3), AA corners (6).
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
// Bound: instructions executed, not bytes and not the float rate. The replay
// is serial per pixel and runs on every lane of a warp that meets the face's
// bbox; of those lanes only some blend (on the 1080p soup 44.9M blending
// pairs over 2.99M (entry, 8x4-pixel warp) pairs: 15 of 32 lanes). Run one
// thread per pixel, the gradient arithmetic and a 31-shuffle butterfly
// would run on every touching warp with the rest of its lanes idle. So each
// group of entries runs in two passes:
//   1. Replay, one thread per pixel (a warp per 8x4 pixels), serially over
//      the group's entries as the forward does (pair_math.cuh): the blend
//      decisions, prefix sums and dL/dalpha. A blending pair is queued in
//      shared memory: ratio, alpha * T, dL/dalpha and a tag (pixel, clamp
//      region), 14 bytes. Its slot comes from the warp's ballot and the
//      faces' bbox pixels in the tile, which bound the pairs of each (entry,
//      warp): entry e, warp w write from (bbox pixels of the group's entries
//      before e) + (those of e in warps before w), with no exchange.
//   2. Gradient pass, after a barrier. Every warp scans the ballots (lane l
//      for entry l): each entry's pairs in the order (warp, lane), cut into
//      batches of up to 32 that hold one entry each. Warp w takes batches w,
//      w + 8, ...; a lane finds its pair through the ballots and computes
//      its 29 fields from the queue, the staged record and face terms (1 /
//      denom, u, v and the clamped uc, vc again, with pair_quantities'
//      expressions, so with its bits) and a table of the pixels' rays and
//      cotangents. One transposed butterfly per batch (reduce-scatter: 16 +
//      8 + 4 + 2 + 1 shuffles, lane c ends with column c) writes the batch's
//      partial sums; after a second barrier warp w sums entries w, w + 8,
//      ... of the group over their batches in order, runs the epilogue (one
//      column per lane, cross-lane terms by shuffle) and writes the 128-byte
//      row, a zero row when no pixel of the tile blends the entry.
// A group is the longest run of at most kGroupMax entries of one staged
// chunk whose bbox pixels fit the queue's kQueue pairs (an entry has at most
// 256, so every group takes one at least); two barriers a group, so the
// queue is as large as three resident blocks allow. On the 1080p soup the
// 44.9M pairs fill 1.91M batches (73% of their lanes, against 47% one
// thread per pixel) and the kernel takes 4.16 ms against 4.76 (H100, 700
// W); queuing within each warp, whose pairs fill fewer batches and split
// across entries, spilled and took 5.96.
//
// Deterministic: the queue's order, the batches, the butterfly's pairing
// and the sums over batches are fixed by the inputs; no float atomics, so
// the table has the same bits on every run. An optional tally (pairs
// queued, batches, butterflies) is added once per block with integer
// atomics.
//
// Staging as the forward's (pair_math.cuh): records in chunks of kChunk,
// copied with cp.async into one of two shared buffers while the other is
// replayed; per-face terms computed once per face when a chunk lands (one
// buffer: the chunk in flight needs none yet), beside each face's bbox
// pixels per warp; the bbox tested before any other per-pair work, so a
// warp with no lane inside the face's bbox skips the pair. Occupancy:
// 75,520 bytes of dynamic shared memory per block (records 16 KB, face
// terms 9 KB, pixel table 7 KB, queue 28 KB, ballots 1 KB, partial sums 12
// KB; allowed above 48 KB by the launch function) and
// __launch_bounds__(256, 3): 80 registers, 16 bytes of stack, three
// resident blocks per SM (two, with 127 registers and a larger queue, ran
// slower).
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

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kPixels / 32;
constexpr int kFields = 29;
constexpr int kQueue = 2048;    // blending pairs one group may queue
constexpr int kGroupMax = 32;   // entries per group: one lane each in the scan
// Gradient batches of one group: an entry's pairs start a batch of their own.
constexpr int kBatches = (kQueue + 31) / 32 + kGroupMax;
static_assert(kPixels <= kQueue, "every group takes one entry at least");
static_assert(kGroupMax <= 32 && kGroupMax <= kChunk, "one lane per entry");

// Per-pixel fields, in the order of their block sums: the moments M_ab,
// M_a3, M_b1 (x, y, z each); the columns that are plain sums (vertex
// colours, opacity, intensity, vertex z: output columns 9..22); the AA edge
// weights j1_0, j2_0, j1_1, j2_1, j1_2, j2_2 times dL/d area.
constexpr int kMab = 0, kMa3 = 3, kMb1 = 6, kDirect = 9, kDop = 18,
              kDint = 19, kDz = 20, kJ = 23;

// Rows of the queue (one float per pair each) and of the pixel table.
enum { kQRatio, kQWgt, kQDlDa, kQRows };
enum { kPRdx, kPRdy, kPRdz, kPGr, kPGg, kPGb, kPGd, kPRows };

struct Shared {
  // Records: the chunk being replayed and the next one in flight. Face
  // terms: the chunk being replayed, staged once it has landed.
  float rec[2][kChunk * kRec];
  FaceTerms face[kChunk];
  // Per staged face: byte w = the tile's pixels inside its bbox and the
  // patch in the warps before w; and all such pixels of the tile.
  unsigned long long before[kChunk];
  int bound[kChunk];
  float pix[kPRows][kPixels];
  float q[kQRows][kQueue];
  unsigned short q_tag[kQueue];  // pixel (thread) | clamp code << 8
  alignas(16) unsigned mask[kGroupMax][kWarps];  // blending lanes
  float part[kBatches][32];                      // [batch][column]
};

// The terms of the landed chunk's n faces (records rec[buf]), one face per
// thread, and their bbox pixels, with the comparisons of pair_quantities'
// bbox test: a queue bound per warp.
__device__ __forceinline__ void stage_chunk(Shared& sh, int buf, int n, float ox,
                                            float oy, float oz, int x_org,
                                            int y_org, int cols, int rows) {
  const int j = threadIdx.x;
  if (j >= n) return;
  FaceTerms& f = sh.face[j];
  face_terms(sh.rec[buf] + j * kRec, ox, oy, oz, f);
  unsigned cm = 0u, rm = 0u;
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    const float p0 = (float)(x_org + c), q0 = (float)(y_org + c);
    if (c < cols && (p0 + 1.0f >= f.txmin) && (p0 <= f.txmax)) cm |= 1u << c;
    if (c < rows && (q0 + 1.0f >= f.tymin) && (q0 <= f.tymax)) rm |= 1u << c;
  }
  // Warp w covers columns (w % 2) * 8 .. +8 and rows (w / 2) * 4 .. +4.
  const int n_cols = __popc(cm), n_left = __popc(cm & 0xffu);
  unsigned long long packed = 0ull;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int quarter = w / 2;
    int b = __popc(rm & ((1u << (4 * quarter)) - 1u)) * n_cols;
    if (w % 2) b += __popc(rm & (0xfu << (4 * quarter))) * n_left;
    packed |= (unsigned long long)b << (8 * w);
  }
  sh.before[j] = packed;
  sh.bound[j] = n_cols * __popc(rm);
}

__device__ __forceinline__ int bbox_before(const Shared& sh, int j, int warp) {
  return (int)((sh.before[j] >> (8 * warp)) & 0xffull);
}

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
    v[i] = keep + __shfl_xor_sync(kFull, send, kHalf);
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

// The 29 fields of queue slot s (pixel table, staged record and face terms).
__device__ __forceinline__ void pair_fields(const Shared& sh, const float* recs,
                                            int j, int s, int x_org, int y_org,
                                            float tau, float (&f)[32]) {
  const unsigned tag = sh.q_tag[s];
  const int t = (int)(tag & 0xffu), code = (int)(tag >> 8);
  const float rdx = sh.pix[kPRdx][t], rdy = sh.pix[kPRdy][t], rdz = sh.pix[kPRdz][t];
  // 1 / denom, u, v and the clamped barycentrics, as pair_quantities
  // computes them.
  const FaceTerms& fc = sh.face[j];
  const float denom = fc.n[0] * rdx + fc.n[1] * rdy + fc.n[2] * rdz;
  const float inv = 1.0f / denom;
  const float u = (fc.m[0] * rdx + fc.m[1] * rdy + fc.m[2] * rdz) * inv;
  const float v = (fc.q[0] * rdx + fc.q[1] * rdy + fc.q[2] * rdz) * inv;
  float uc = u, vc = v;
  if (code == 1) { uc = 0.0f; vc = 0.0f; }
  else if (code == 2) { uc = 1.0f; vc = 0.0f; }
  else if (code == 3) { uc = 0.0f; vc = 1.0f; }
  else if (code == 4) { uc = 0.0f; }
  else if (code == 5) { vc = 0.0f; }
  else if (code == 6) { uc = (1.0f + u - v) * 0.5f; vc = (1.0f - u + v) * 0.5f; }
  const float ratio = sh.q[kQRatio][s], wgt = sh.q[kQWgt][s];
  const float dl_da = sh.q[kQDlDa][s];
  const float g_r = sh.pix[kPGr][t], g_g = sh.pix[kPGg][t], g_b = sh.pix[kPGb][t];
  const float g_d = sh.pix[kPGd][t];
  const float* rec = recs + j * kRec;
  const float intense = rec[kIn];
  const Interp si = interpolate(rec, uc, vc);

  // Colour, depth, intensity and opacity fields.
  const float dic_r = g_r * wgt, dic_g = g_g * wgt, dic_b = g_b * wgt;
  const float did = g_d * wgt;
  const float i0 = 1.0f - uc - vc;
  const float ik[3] = {i0, uc, vc};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f[kDirect + 3 * k + 0] = (ik[k] * dic_r) * intense;
    f[kDirect + 3 * k + 1] = (ik[k] * dic_g) * intense;
    f[kDirect + 3 * k + 2] = (ik[k] * dic_b) * intense;
    f[kDz + k] = ik[k] * did;
  }
  f[kDop] = dl_da * ratio;
  f[kDint] = si.m_r * dic_r + si.m_g * dic_g + si.m_b * dic_b;

  // Barycentric chain, clamp Jacobian, Moeller-Trumbore moments.
  float dl_di[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dl_di[k] = (rec[kC + 3 * k] * dic_r + rec[kC + 3 * k + 1] * dic_g +
                rec[kC + 3 * k + 2] * dic_b) * intense +
               rec[kZ + k] * did;
  float duc_du = 0.0f, duc_dv = 0.0f, dvc_du = 0.0f, dvc_dv = 0.0f;
  if (code == 0) { duc_du = 1.0f; dvc_dv = 1.0f; }
  else if (code == 4) { dvc_dv = 1.0f; }
  else if (code == 5) { duc_du = 1.0f; }
  else if (code == 6) {
    duc_du = 0.5f; dvc_dv = 0.5f; duc_dv = -0.5f; dvc_du = -0.5f;
  }
  const float dl_duc = dl_di[1] - dl_di[0];
  const float dl_dvc = dl_di[2] - dl_di[0];
  const float dl_du = dl_duc * duc_du + dl_dvc * dvc_du;
  const float dl_dv = dl_duc * duc_dv + dl_dvc * dvc_dv;
  const float sm[3] = {(dl_du * u + dl_dv * v) * inv, dl_du * inv, dl_dv * inv};
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    f[kMab + 3 * m + 0] = sm[m] * rdx;
    f[kMab + 3 * m + 1] = sm[m] * rdy;
    f[kMab + 3 * m + 2] = sm[m] * rdz;
  }

  // AA edge weights (shape derivative of the overlap area).
  if (tau > 0.0f) {
    const int w = t / 32, l = t % 32;
    const float px0 = (float)(x_org + warp_pixel_x(w, l));
    const float py0 = (float)(y_org + warp_pixel_y(w, l));
    const float px1 = px0 + 1.0f, py1 = py0 + 1.0f;
    const float dl_doarea = (dl_da * rec[kOp]) * tau;
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      float j1, j2;
      edge_weights(fc, rec + kAA, e, px0, px1, py0, py1, j1, j2);
      f[kJ + 2 * e] = dl_doarea * j1;
      f[kJ + 2 * e + 1] = dl_doarea * j2;
    }
  }
}

// Entry epilogue: the block sum v of column `lane` -> output column `lane`.
__device__ __forceinline__ float grad_column(const FaceTerms& fc, float v,
                                             int lane, float tau) {
  // Lane roles. Lanes 0..8: dp_vi[k] from cross(a, b)[k] = a[k1] b[k2]
  // - a[k2] b[k1]. Lanes 23..28: AA corner ck, edge ck -> ck+1 leaves
  // it (weight j1), edge ck-1 -> ck enters it (weight j2).
  const int vi = lane / 3, k = lane - 3 * (lane / 3);
  const int k1 = k == 2 ? 0 : k + 1, k2 = k == 0 ? 2 : k - 1;
  const int ck = lane >= kJ ? (lane - kJ) / 2 : 0;
  const int ckp = ck == 0 ? 2 : ck - 1;
  const float ab1 = __shfl_sync(kFull, v, kMab + k1);
  const float ab2 = __shfl_sync(kFull, v, kMab + k2);
  const float a31 = __shfl_sync(kFull, v, kMa3 + k1);
  const float a32 = __shfl_sync(kFull, v, kMa3 + k2);
  const float b11 = __shfl_sync(kFull, v, kMb1 + k1);
  const float b12 = __shfl_sync(kFull, v, kMb1 + k2);
  const float r1 = __shfl_sync(kFull, v, kJ + 2 * ck);
  const float r2 = __shfl_sync(kFull, v, kJ + 2 * ckp + 1);
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
  return o;
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
    float* __restrict__ out, unsigned long long* __restrict__ tally) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);

  const int tile = blockIdx.x;
  const int tiles_per_batch = gx * gy;
  const int b = tile / tiles_per_batch;
  const int rem = tile - b * tiles_per_batch;
  const int ty = rem / gx;
  const int tx = rem - ty * gx;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lanes_below = (1u << lane) - 1u;
  const int x = tx * kTile + warp_pixel_x(warp, lane);
  const int y = ty * kTile + warp_pixel_y(warp, lane);
  const bool in_patch = x < W && y < H;
  const int x_org = patch_min[2 * b] + tx * kTile;
  const int y_org = patch_min[2 * b + 1] + ty * kTile;
  const int cols = W - tx * kTile < kTile ? W - tx * kTile : kTile;
  const int rows = H - ty * kTile < kTile ? H - ty * kTile : kTile;

  const float px0 = (float)(patch_min[2 * b] + x);
  const float py0 = (float)(patch_min[2 * b + 1] + y);
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
  // The gradient pass reads any pixel's ray and cotangents from here.
  sh.pix[kPRdx][threadIdx.x] = rdx;
  sh.pix[kPRdy][threadIdx.x] = rdy;
  sh.pix[kPRdz][threadIdx.x] = rdz;
  sh.pix[kPGr][threadIdx.x] = g_r;
  sh.pix[kPGg][threadIdx.x] = g_g;
  sh.pix[kPGb][threadIdx.x] = g_b;
  sh.pix[kPGd][threadIdx.x] = g_d;

  const long long start = tile_starts[tile];
  long long count = tile_counts[tile];
  if (start + count > n_records) count = n_records - start;
  const long long ncmax = nc_tile[tile] > 0 ? nc_tile[tile] : 0;
  const long long n_loop = count < ncmax ? count : ncmax;
  const float* src = records + start * kRec;

  float T = 1.0f;
  float p_r = 0.0f, p_g = 0.0f, p_b = 0.0f, p_d = 0.0f;
  // Warp 0's count of the pairs the block queued and its gradient batches.
  unsigned long long queued_pairs = 0ull, queued_batches = 0ull;

  if (n_loop > 0) {
    const int n0 = (int)(n_loop < kChunk ? n_loop : kChunk);
    load_chunk_async(sh.rec[0], src, n0);
    wait_chunk();
    __syncthreads();
    stage_chunk(sh, 0, n0, ox, oy, oz, x_org, y_org, cols, rows);
  }
  int buf = 0;
  for (long long base = 0; base < n_loop; base += kChunk, buf ^= 1) {
    // The chunk's faces are staged; every reader of the other records is
    // done.
    __syncthreads();
    const int n = (int)(n_loop - base < kChunk ? n_loop - base : kChunk);
    const long long next = base + kChunk;
    const int n_next = (int)(next >= n_loop ? 0 : (n_loop - next < kChunk ? n_loop - next : kChunk));
    if (n_next > 0) load_chunk_async(sh.rec[buf ^ 1], src + next * kRec, n_next);
    const float* recs = sh.rec[buf];

    for (int g0 = 0; g0 < n;) {
      int n_group = 0, bbox_sum = 0;
      while (g0 + n_group < n && n_group < kGroupMax &&
             bbox_sum + sh.bound[g0 + n_group] <= kQueue) {
        bbox_sum += sh.bound[g0 + n_group];
        ++n_group;
      }

      // 1. Replay: the forward's blend, dL/dalpha, and the queue.
      int q_base = 0;
      for (int e = 0; e < n_group; ++e) {
        const int j = g0 + e;
        const float* rec = recs + j * kRec;
        bool active = false;
        Pair q;
        float wgt = 0.0f, dl_da = 0.0f;
        if (in_patch && T >= kTEps &&
            pair_quantities(sh.face[j], rec, sh.pix[kPRdx][threadIdx.x],
                            sh.pix[kPRdy][threadIdx.x], sh.pix[kPRdz][threadIdx.x],
                            px0, py0, tau, one_minus_tau, q)) {
          active = true;
          const Interp s = interpolate(rec, q.uc, q.vc);
          const float intense = rec[kIn];
          const float alpha = rec[kOp] * q.ratio;
          wgt = alpha * T;
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

          const float inv_after = t_after > 0.0f ? 1.0f / t_after : 0.0f;
          const float ar_r = (cn_r - p_r) * inv_after;
          const float ar_g = (cn_g - p_g) * inv_after;
          const float ar_b = (cn_b - p_b) * inv_after;
          const float ar_d = (dn - p_d) * inv_after;
          dl_da = t_before * ((ic_r - ar_r) * sh.pix[kPGr][threadIdx.x] +
                              (ic_g - ar_g) * sh.pix[kPGg][threadIdx.x] +
                              (ic_b - ar_b) * sh.pix[kPGb][threadIdx.x] +
                              (s.i_d - ar_d) * sh.pix[kPGd][threadIdx.x]);
          const float bg_fac = alpha < 1.0f ? -t_fin / (1.0f - alpha) : -pt_fin;
          dl_da = dl_da + bg_fac * bg_dot;
        }
        const unsigned m = __ballot_sync(kFull, active);
        if (lane == 0) sh.mask[e][warp] = m;
        if (active) {
          const int s = q_base + bbox_before(sh, j, warp) + __popc(m & lanes_below);
          sh.q[kQRatio][s] = q.ratio;
          sh.q[kQWgt][s] = wgt;
          sh.q[kQDlDa][s] = dl_da;
          sh.q_tag[s] = (unsigned short)(threadIdx.x | (q.code << 8));
        }
        q_base += sh.bound[j];
      }
      __syncthreads();

      // 2. Every warp scans the ballots, lane l for entry l: its pairs, its
      // first batch and its queue base (the group's bbox pixels before it).
      int n_l = 0, bbox_l = 0;
      if (lane < n_group) {
        const uint4 lo = *reinterpret_cast<const uint4*>(&sh.mask[lane][0]);
        const uint4 hi = *reinterpret_cast<const uint4*>(&sh.mask[lane][4]);
        n_l = __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) +
              __popc(hi.x) + __popc(hi.y) + __popc(hi.z) + __popc(hi.w);
        bbox_l = sh.bound[g0 + lane];
      }
      const int nb_l = (n_l + 31) / 32;
      int b_incl = nb_l, q_incl = bbox_l;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int a = __shfl_up_sync(kFull, b_incl, d);
        const int c = __shfl_up_sync(kFull, q_incl, d);
        if (lane >= d) { b_incl += a; q_incl += c; }
      }
      const int n_batch = __shfl_sync(kFull, b_incl, 31);
      const int b0_l = b_incl - nb_l, q0_l = q_incl - bbox_l;
      if (tally != nullptr && warp == 0) {
        queued_pairs += __reduce_add_sync(kFull, (unsigned)n_l);
        queued_batches += n_batch;
      }

      // 3. Gradient pass: each batch holds up to 32 pairs of one entry, in
      // the order (warp, lane).
      for (int bt = warp; bt < n_batch; bt += kWarps) {
        const int e = 31 - __clz(__ballot_sync(kFull, nb_l > 0 && b0_l <= bt));
        const int i = (bt - __shfl_sync(kFull, b0_l, e)) * 32 + lane;
        const int n_e = __shfl_sync(kFull, n_l, e);
        const int q0 = __shfl_sync(kFull, q0_l, e);
        float f[32];
#pragma unroll
        for (int c = 0; c < 32; ++c) f[c] = 0.0f;
        if (i < n_e) {
          // Pair i of the entry: the warp whose ballots hold it, its rank.
          const uint4 lo = *reinterpret_cast<const uint4*>(&sh.mask[e][0]);
          const uint4 hi = *reinterpret_cast<const uint4*>(&sh.mask[e][4]);
          const unsigned mk[kWarps] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
          int w = 0, below = 0, acc = 0;
#pragma unroll
          for (int ww = 0; ww < kWarps - 1; ++ww) {
            acc += __popc(mk[ww]);
            if (i >= acc) { below = acc; w = ww + 1; }
          }
          const int s = q0 + bbox_before(sh, g0 + e, w) + (i - below);
          pair_fields(sh, recs, g0 + e, s, x_org, y_org, tau, f);
        }
        sh.part[bt][lane] = warp_reduce_scatter(f, lane);
      }
      __syncthreads();

      // 4. Warp w: entries w, w + 8, ...: the block sum over the entry's
      // batches in order, the epilogue and the row.
      for (int e = warp; e < n_group; e += kWarps) {
        const int b0 = __shfl_sync(kFull, b0_l, e), b1 = b0 + __shfl_sync(kFull, nb_l, e);
        float v = 0.0f;
        for (int bb = b0; bb < b1; ++bb) v += sh.part[bb][lane];
        out[(start + base + g0 + e) * kRec + lane] = grad_column(sh.face[g0 + e], v, lane, tau);
      }
      g0 += n_group;
    }

    if (n_next == 0) break;
    wait_chunk();
    __syncthreads();
    stage_chunk(sh, buf ^ 1, n_next, ox, oy, oz, x_org, y_org, cols, rows);
  }
  if (tally != nullptr && threadIdx.x == 0 && queued_pairs > 0ull) {
    atomicAdd(&tally[0], queued_pairs);
    atomicAdd(&tally[1], queued_batches);
    atomicAdd(&tally[2], queued_batches);  // one butterfly per batch
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
    float one_minus_tau, void* out, void* tally, void* stream) {
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
      (float*)out, (unsigned long long*)tally);
  return (int)cudaGetLastError();
}

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
