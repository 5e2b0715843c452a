// Binning's emission grid: every slot's packed sort key and payload.
//
// Replaces: the eager PyTorch ops of ops/binning.py::emission_keys_plain,
// the port of the emission in dmesh2_renderer_tpu/ops/binning.py::bin_faces
// (plain XLA there, which fuses it; no Pallas kernel). Eagerly it is one
// pass over the whole (B*F, Kt) grid per op, ~115 ops without the exact tile
// cull and ~280 with it, most of them int64. This kernel computes the same
// keys and payloads, element for element, in one pass:
//
//   * per face (b, f): the clamped tile rect, as face_tile_rects computes it
//     (amin / amax of the corners, minus the patch origin, / 16, floor or
//     ceil, clamped in float, then converted), and touched = w * h where the
//     face is alive;
//   * per slot k (y-major, dy = k / max(w, 1)): valid while k < touched;
//     with the exact tile cull (kCull), the triangle-vs-tile-box test of
//     _tri_tile_overlaps in its operation order (sign of the doubled area,
//     the box corner picked by ex > 0 and ey > 0, the slack
//     (float)-1e-3 * (|ex| + |ey|)); the key (tile << bits_d) | dq, with dq
//     the depth quantised in the integer domain,
//     clamp((int)(depth01 * (float)dmax), 0, dmax), where the conversion
//     saturates as .to(torch.int32) does on the card; else the sentinel;
//   * the payload b*F + f (the giant rows: the face, or 0 for an unused row).
//
// One body, two launches. The dense launch covers the (B*F, Kt) grid and
// writes each face's giant-selection key (Kt - touched where touched > Kt,
// else the sentinel) and the sentinel padding up to the capacity. The giant
// launch covers the (M2, Kt2) rows of the faces that the wrapper's stable
// sort of those keys selected, slots Kt .. Kt + Kt2 - 1 of each, and writes
// giant_ids. Both add num_rendered (dense only), num_emitted and num_culled
// into three int64 counters: per-thread sums, then a block reduction, then
// one atomicAdd per block and counter (integer sums, so exact in any order).
// Two instances, with and without the cull (kCull); which launch it is, is
// an argument. Built with -fmad=false: the cull's products and differences
// round one by one, as the eager ops do.
//
// Bound: memory. Each slot writes 8 bytes (an int32 key and an int32
// payload); each face's 29 bytes (corners, depth, alive) are read once.
// Everything that depends on the face alone (the rect, the tile and depth
// bits, the cull's edge vectors and slacks, a divider for dy) is worked out
// once per face: each block takes up to 256 rows (fewer where that would
// leave under 1024 blocks, as the giant rows would: 16,384 rows of 88 slots
// in 64 blocks kept most SMs idle), one thread per row puts them in shared
// memory, then the block's 256 threads take the rows' slots in order, so
// consecutive threads write consecutive slots (coalesced) and a slot costs
// a few shared loads, a multiply-shift for its (dx, dy), its tile test and
// its key. Working the face out again for every slot, one thread per slot,
// read 24-27% of the byte bound on the H100 (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 256;  // threads per block, and the most rows a block takes
constexpr int kBlocks = 1024;  // blocks a launch aims at: fewer rows per block below that
constexpr int kSentinel = 0x7FFFFFFF;
constexpr float kTile = 16.0f;  // TILE_X == TILE_Y

struct Args {
  const float2* aa;           // (B*F, 3) screen corners
  const float* depth01;       // (B*F,)
  const unsigned char* alive; // (B*F,) bool
  const int* patch_min;       // (B, 2)
  int F, BF, gx, gy;
  int kt;                     // dense slots per face
  int bits_d;
  // Giant launch: the rows' sorted selection keys and face ids (null for
  // the dense launch).
  const int* giant_keys;
  const long long* giant_order;
  int rows, cols;             // grid rows and slots per row
  int block_rows;             // rows per block
  long long pad_base, n_pad;  // dense launch: the sentinel padding
  int* keys;
  int* payload;
  int* select_keys;           // dense: (B*F,) giant-selection keys, or null
  int* giant_ids;             // giant: (M2,)
  unsigned long long* counts; // rendered, emitted, culled
};

// n / d for n, d in [1, 2^31) as a multiply-high, an add and a shift (the
// magic-number division of PyTorch's IntDivider).
struct Divider {
  unsigned magic, shift;
  __device__ explicit Divider(unsigned d) {
    shift = 0;
    while (shift < 32 && (1u << shift) < d) ++shift;
    const unsigned long long one = 1;
    magic = (unsigned)(((one << 32) * ((one << shift) - d)) / d + 1);
  }
  __device__ Divider(unsigned m, unsigned s) : magic(m), shift(s) {}
  __device__ unsigned operator()(unsigned n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

// torch.amin / amax: a NaN anywhere gives NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// torch.clamp(x, 0, hi).to(torch.int32): the clamp keeps a NaN and the
// card's conversion makes it 0, as fmaxf(NaN, 0) does here.
__device__ __forceinline__ int cell(float x, int hi) {
  return (int)fminf(fmaxf(x, 0.0f), (float)hi);
}

// A block's rows in shared memory, one entry per row: what its slots read.
struct Rows {
  int lim[kRows];         // the row's valid slots: column < lim
  int tile0[kRows];       // the rect's first tile, b * gx * gy + y0 * gx + x0
  int w[kRows];           // max(rect width, 1) ...
  unsigned magic[kRows];  // ... and its divider
  unsigned shift[kRows];
  int dq[kRows];
  int face[kRows];        // the payload
};
// The cull's per-face terms: the rect's corner, the patch origin, and per
// edge e its first corner (ax, ay), its sign-corrected vector (ex, ey) and
// its slack.
struct CullRows {
  int x0[kRows], y0[kRows];
  float px[kRows], py[kRows];
  float ax[3][kRows], ay[3][kRows], ex[3][kRows], ey[3][kRows], slack[3][kRows];
};
template <bool kCull>
struct Shared {
  Rows rows;
};
template <>
struct Shared<true> {
  Rows rows;
  CullRows cull;
};

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <bool kCull>
__global__ void __launch_bounds__(kRows) bin_emit_kernel(const Args a) {
  __shared__ Shared<kCull> sh;
  __shared__ unsigned long long part[3][kRows / 32];
  Rows& rs = sh.rows;
  const bool giant = a.giant_order != nullptr;
  const int koff = giant ? a.kt : 0;  // column 0's slot k
  const int dmax = (1 << a.bits_d) - 1;
  const int t = threadIdx.x;
  unsigned long long rendered = 0, emitted = 0, culled = 0;

  // The block's rows, one per thread.
  const int row0 = blockIdx.x * a.block_rows;
  const int n_rows = min(a.block_rows, a.rows - row0);
  if (t < n_rows) {
    const int r = row0 + t;
    int face = r;
    bool used = true;
    if (giant) {
      used = a.giant_keys[r] != kSentinel;
      face = used ? (int)a.giant_order[r] : 0;
      a.giant_ids[r] = used ? face : a.BF;
    }
    const int b = face / a.F;
    const float px = (float)a.patch_min[2 * b];
    const float py = (float)a.patch_min[2 * b + 1];
    const float2 c0 = a.aa[3LL * face], c1 = a.aa[3LL * face + 1],
                 c2 = a.aa[3LL * face + 2];
    const float mnx = min_nan(min_nan(c0.x, c1.x), c2.x);
    const float mny = min_nan(min_nan(c0.y, c1.y), c2.y);
    const float mxx = max_nan(max_nan(c0.x, c1.x), c2.x);
    const float mxy = max_nan(max_nan(c0.y, c1.y), c2.y);
    const int x0 = cell(floorf((mnx - px) / kTile), a.gx);
    const int y0 = cell(floorf((mny - py) / kTile), a.gy);
    const int w = max(cell(ceilf((mxx - px) / kTile), a.gx) - x0, 0);
    const int h = max(cell(ceilf((mxy - py) / kTile), a.gy) - y0, 0);
    const int touched = a.alive[face] ? w * h : 0;
    if (!giant) {
      rendered = (unsigned long long)touched;
      if (a.select_keys != nullptr)
        a.select_keys[face] = touched > a.kt ? a.kt - touched : kSentinel;
    }
    const int dq = (int)(a.depth01[face] * (float)dmax);
    const Divider dw((unsigned)max(w, 1));
    rs.lim[t] = used ? touched - koff : 0;
    rs.tile0[t] = b * (a.gx * a.gy) + y0 * a.gx + x0;
    rs.w[t] = max(w, 1);
    rs.magic[t] = dw.magic;
    rs.shift[t] = dw.shift;
    rs.dq[t] = min(max(dq, 0), dmax);
    rs.face[t] = face;
    if constexpr (kCull) {
      // _tri_tile_overlaps' per-face terms, in its operation order.
      const float ax[3] = {c0.x, c1.x, c2.x}, ay[3] = {c0.y, c1.y, c2.y};
      const float d = (ax[1] - ax[0]) * (ay[2] - ay[0]) - (ay[1] - ay[0]) * (ax[2] - ax[0]);
      const float sgn = (float)((0.0f < d) - (d < 0.0f));  // torch.sign
      CullRows& c = sh.cull;
      c.x0[t] = x0;
      c.y0[t] = y0;
      c.px[t] = px;
      c.py[t] = py;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const int j = (e + 1) % 3;
        const float ex = sgn * (ax[j] - ax[e]);
        const float ey = sgn * (ay[j] - ay[e]);
        c.ax[e][t] = ax[e];
        c.ay[e][t] = ay[e];
        c.ex[e][t] = ex;
        c.ey[e][t] = ey;
        // The double -1e-3 cast to float, as torch casts a Python scalar.
        c.slack[e][t] = (float)-1e-3 * (fabsf(ex) + fabsf(ey));
      }
    }
  }
  __syncthreads();

  // Their slots, in order.
  const Divider per_row((unsigned)max(a.cols, 1));
  const long long slot0 = (giant ? (long long)a.BF * a.kt : 0) + (long long)row0 * a.cols;
  const int n_slots = max(n_rows, 0) * a.cols;
  for (int s = t; s < n_slots; s += kRows) {
    const int i = (int)per_row((unsigned)s);
    const int col = s - i * a.cols;
    int key = kSentinel;
    if (col < rs.lim[i]) {
      const unsigned k = (unsigned)(col + koff);
      const int dy = (int)Divider(rs.magic[i], rs.shift[i])(k);
      const int dx = (int)k - dy * rs.w[i];
      bool ok = true;
      if constexpr (kCull) {
        // The tile box's corner, then per edge the box corner farthest
        // along its normal.
        const CullRows& c = sh.cull;
        const float x0 = (float)(c.x0[i] + dx) * kTile + c.px[i];
        const float y0 = (float)(c.y0[i] + dy) * kTile + c.py[i];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float ex = c.ex[e][i], ey = c.ey[e][i];
          const float cy = y0 + (ex > 0.0f ? kTile : 0.0f);
          const float cx = x0 + (ey > 0.0f ? 0.0f : kTile);
          const float smax = ex * (cy - c.ay[e][i]) - ey * (cx - c.ax[e][i]);
          ok &= smax >= c.slack[e][i];
        }
      }
      if (ok) {
        ++emitted;
        const unsigned tile = (unsigned)(rs.tile0[i] + dy * a.gx + dx);
        key = (int)((tile << a.bits_d) | (unsigned)rs.dq[i]);
      } else {
        ++culled;
      }
    }
    a.keys[slot0 + s] = key;
    a.payload[slot0 + s] = rs.face[i];
  }

  // The sentinel padding up to the capacity (dense launch).
  for (long long p = (long long)blockIdx.x * kRows + t; p < a.n_pad;
       p += (long long)gridDim.x * kRows) {
    a.keys[a.pad_base + p] = kSentinel;
    a.payload[a.pad_base + p] = 0;
  }

  // Block sums of the three counts, then one atomic per block and count.
  const int lane = t & 31, warp = t >> 5;
  rendered = warp_sum(rendered);
  emitted = warp_sum(emitted);
  culled = warp_sum(culled);
  if (lane == 0) {
    part[0][warp] = rendered;
    part[1][warp] = emitted;
    part[2][warp] = culled;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const unsigned long long v = warp_sum(lane < kRows / 32 ? part[q][lane] : 0ULL);
      if (lane == 0 && v != 0) atomicAdd(a.counts + q, v);
    }
  }
}

}  // namespace

// One launch over the dense grid (giant_order null: rows = B*F, cols = Kt,
// the padding after both grids) or over the giant rows (rows = M2, cols =
// Kt2, no padding).
extern "C" int bin_emit_launch(
    const void* aa, const void* depth01, const void* alive, const void* patch_min,
    int F, int BF, int gx, int gy, int kt, int bits_d, int cull,
    const void* giant_keys, const void* giant_order, int rows, int cols,
    long long pad_base, long long n_pad, void* keys, void* payload,
    void* select_keys, void* giant_ids, void* counts, void* stream) {
  Args a;
  a.aa = (const float2*)aa;
  a.depth01 = (const float*)depth01;
  a.alive = (const unsigned char*)alive;
  a.patch_min = (const int*)patch_min;
  a.F = F;
  a.BF = BF;
  a.gx = gx;
  a.gy = gy;
  a.kt = kt;
  a.bits_d = bits_d;
  a.giant_keys = (const int*)giant_keys;
  a.giant_order = (const long long*)giant_order;
  a.rows = rows;
  a.cols = cols;
  a.pad_base = pad_base;
  a.n_pad = n_pad;
  a.keys = (int*)keys;
  a.payload = (int*)payload;
  a.select_keys = (int*)select_keys;
  a.giant_ids = (int*)giant_ids;
  a.counts = (unsigned long long*)counts;
  const long long per_block = ((long long)rows + kBlocks - 1) / kBlocks;
  a.block_rows = per_block < 1 ? 1 : (per_block > kRows ? kRows : (int)per_block);
  // One block for the padding alone.
  const long long blocks =
      rows > 0 ? ((long long)rows + a.block_rows - 1) / a.block_rows : (n_pad > 0 ? 1 : 0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    if (cull)
      bin_emit_kernel<true><<<(unsigned)blocks, kRows, 0, s>>>(a);
    else
      bin_emit_kernel<false><<<(unsigned)blocks, kRows, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// Resources of the culling instance: registers, static and dynamic shared
// memory, local (spill) bytes, resident blocks per SM.
extern "C" int bin_emit_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, bin_emit_kernel<true>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, bin_emit_kernel<true>, kRows, 0);
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
