// Gradient reduction: per-entry gradient records -> the rasterizer's input
// gradients, and AA-corner gradients -> screen-space vertex gradients.
//
// Replaces: dmesh2_renderer_tpu/ops/pallas_bwd.py::scatter_entry_grads and
// dmesh2_renderer_tpu/geometry.py::aa_cotangent_to_verts_image, which are
// XLA sorts and segmented scans, no Pallas kernel: the TPU has no fast
// scatter. On this card both are sums with atomics.
//
// grad_reduce_kernel, entries -> faces and vertices. composite_bwd writes
// one 29-column record per entry of each tile's contributing prefix, the
// first min(count, nc_tile) entries of the tile's range (clipped to the
// table, as composite_bwd clips it); every other row of the (R, 32) table is
// never read, so the table need not be zeroed. Each record is added once to
// its destinations (the inverse of pack_stream's gather, with e =
// entry_bf[r], b = e / F, f = e % F, v_i = faces[f][i]):
//
//   [0:9)   d_vert8[v_i][0:3]          summed over views
//   [9:18)  d_vert8[v_i][4:7]          summed over views
//   [18]    d_op[f]                    summed over views
//   [19]    d_int[b][f]
//   [20:23) d_vndc[b][v_i][2]          the z column of (B, P, 3)
//   [23:29) d_aa[b][f][0:6]
//
// d_vert8 (P, 8) holds each vertex's position and colour gradients side by
// side, each padded to a 16-byte float4 (the wrapper copies them out). The
// sentinel (e == B*F) adds nothing, nor does an all-zero atomic (adding +-0
// to a sum that starts at +0 cannot change it), which skips the AA columns
// at tau = 0 and the rows no pixel blends.
//
// Bound: atomic operations. It reads the prefixes' records (128 bytes each)
// and their entry ids once, and adds 29 floats a record into outputs that
// at the 16-view headline (1.5 GB) do not fit in the 50 MB L2. Measured on
// the H100 at that step's inputs (16.1M records): the loads alone 0.8 ms;
// 29 scalar atomics a record 7.2 ms, and 4.9 ms with every address folded
// into 4 MB of L2, so the count of atomic operations, not the bytes, set
// the time; the 14 below 3.9 ms. Design:
//   * one warp per tile; eight lanes load a record's eight 16-byte words
//     with streaming loads (nothing reads a record again; the L2 keeps the
//     outputs), so a warp reads 4 consecutive records, 512 contiguous bytes,
//     and stages them in shared memory;
//   * 14 atomics a record in place of 29, by sm_90's vector atomics: per
//     vertex one float4 for the position and one for the colour, the AA
//     corners as three float2; the opacity, the intensity and the three
//     z are scalars. Lanes 0-2 take a vertex each, 3-5 a z (and the
//     opacity, the intensity), 6-7 the AA corners;
//   * no compaction, no sort, no host sync: the tile arrays name the rows.
// Sums with atomics run in no fixed order, so the last bits of a gradient
// change from run to run (as index_add_'s do on this card).
//
// corner_reduce_kernel, AA corners -> vertices: face_aa_verts_ccw gathered
// verts_image[b][faces[f][i]] and swapped corners 1 and 2 where the screen
// triangle was clockwise (neg[b][f]); its backward un-swaps the (B, F, 3, 2)
// cotangent and adds each corner's float2 to its vertex of the (B, P, 2)
// gradient: one thread per corner, one 8-byte vector atomic (sm_90). Bound:
// memory, 8 bytes read and 8 read-modify-written per corner.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                  // lanes per record
constexpr int kRowsPerStep = 32 / kGroup;  // records a warp reads at once
constexpr int kQuads = 32 / 4;             // float4 words of a record

__device__ __forceinline__ void add(float* p, float v) {
  if (v != 0.0f) atomicAdd(p, v);
}

__device__ __forceinline__ void add2(float2* p, float x, float y) {
  if (x != 0.0f || y != 0.0f) atomicAdd(p, make_float2(x, y));
}

__device__ __forceinline__ void add3(float4* p, float x, float y, float z) {
  if (x != 0.0f || y != 0.0f || z != 0.0f) atomicAdd(p, make_float4(x, y, z, 0.0f));
}

__global__ void __launch_bounds__(kThreads) grad_reduce_kernel(
    const float4* __restrict__ records, long long R,
    const int* __restrict__ entry_bf, const int* __restrict__ tile_starts,
    const int* __restrict__ tile_counts, const int* __restrict__ nc_tile,
    int n_tiles, const int* __restrict__ faces, int B, int F, int P,
    float4* __restrict__ d_vert8, float* __restrict__ d_op,
    float* __restrict__ d_vndc, float* __restrict__ d_int,
    float2* __restrict__ d_aa) {
  __shared__ float4 stage[kWarps][kRowsPerStep][kQuads];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * kWarps + warp;
  if (tile >= n_tiles) return;
  const int g = lane / kGroup;                // record of the step
  const int k = lane & (kGroup - 1);          // word quad, then role
  const long long start = tile_starts[tile];
  long long count = tile_counts[tile];
  if (start + count > R) count = R - start;
  const long long nc = nc_tile[tile] > 0 ? nc_tile[tile] : 0;
  const long long end = start + (count < nc ? count : nc);
  const int bf = B * F;
  for (long long base = start; base < end; base += kRowsPerStep) {
    const long long r = base + g;
    int e = bf;
    if (r < end) {
      e = __ldg(entry_bf + r);
      stage[warp][g][k] = __ldcs(records + r * kQuads + k);
    }
    __syncwarp();
    if (e >= 0 && e < bf) {                   // not past the prefix, not the sentinel
      const float* c = reinterpret_cast<const float*>(stage[warp][g]);
      const int b = e / F;
      const int f = e - b * F;
      const int* fv = faces + 3LL * f;
      float* z = d_vndc + 3LL * b * P + 2;
      switch (k) {
        case 0: case 1: case 2: {
          const long long v = __ldg(fv + k);
          add3(d_vert8 + 2 * v, c[3 * k], c[3 * k + 1], c[3 * k + 2]);
          add3(d_vert8 + 2 * v + 1, c[9 + 3 * k], c[10 + 3 * k], c[11 + 3 * k]);
          break;
        }
        case 3: add(z + 3LL * __ldg(fv), c[20]); add(d_op + f, c[18]); break;
        case 4: add(z + 3LL * __ldg(fv + 1), c[21]); add(d_int + e, c[19]); break;
        case 5: add(z + 3LL * __ldg(fv + 2), c[22]); break;
        case 6: add2(d_aa + 3LL * e, c[23], c[24]); add2(d_aa + 3LL * e + 1, c[25], c[26]);
                break;
        default: add2(d_aa + 3LL * e + 2, c[27], c[28]); break;   // words 29..31: zero
      }
    }
    __syncwarp();                             // the stage is read before it is refilled
  }
}

__global__ void __launch_bounds__(kThreads) corner_reduce_kernel(
    const float2* __restrict__ g, const unsigned char* __restrict__ neg,
    const int* __restrict__ faces, long long n_corners, int F, int P,
    float2* __restrict__ d_image) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_corners) return;
  const long long e = i / 3;                  // b * F + f
  const int c = (int)(i - 3 * e);
  const int b = (int)(e / F);
  const int f = (int)(e - (long long)b * F);
  // The CCW reorder swapped corners 1 and 2: corner c came from slot s.
  const int s = (c != 0 && neg[e]) ? 3 - c : c;
  const long long v = __ldg(faces + 3LL * f + s);
  const float2 val = __ldcs(g + i);
  if (val.x != 0.0f || val.y != 0.0f) atomicAdd(d_image + (long long)b * P + v, val);
}

}  // namespace

extern "C" int grad_reduce_launch(
    const void* records, long long R, const void* entry_bf,
    const void* tile_starts, const void* tile_counts, const void* nc_tile,
    int n_tiles, const void* faces, int B, int F, int P, void* d_vert8,
    void* d_op, void* d_vndc, void* d_int, void* d_aa, void* stream) {
  const int blocks = (n_tiles + kWarps - 1) / kWarps;
  grad_reduce_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)records, R, (const int*)entry_bf, (const int*)tile_starts,
      (const int*)tile_counts, (const int*)nc_tile, n_tiles, (const int*)faces,
      B, F, P, (float4*)d_vert8, (float*)d_op, (float*)d_vndc, (float*)d_int,
      (float2*)d_aa);
  return (int)cudaGetLastError();
}

extern "C" int corner_reduce_launch(
    const void* g, const void* neg, const void* faces, long long n_corners,
    int F, int P, void* d_image, void* stream) {
  const long long blocks = (n_corners + kThreads - 1) / kThreads;
  corner_reduce_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float2*)g, (const unsigned char*)neg, (const int*)faces, n_corners,
      F, P, (float2*)d_image);
  return (int)cudaGetLastError();
}

// Resources of grad_reduce_kernel: registers, static and dynamic shared
// memory, local (spill) bytes, resident blocks per SM.
extern "C" int grad_reduce_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, grad_reduce_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, grad_reduce_kernel,
                                                      kThreads, 0);
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
