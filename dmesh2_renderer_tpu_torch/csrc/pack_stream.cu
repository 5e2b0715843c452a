// Record pack: sorted binning entries -> (R, 32) f32 per-entry face records.
//
// Replaces: dmesh2_renderer_tpu/ops/binning.py::materialize (the Pallas
// identity copy _copy_kernel, called three times per render from
// build_face_table_from_corners) together with the row gather that follows
// it (gather_stream). The TPU copy exists only so that XLA gathers from real
// contiguous split tables; this kernel takes over that role by building each
// entry's 128-byte record directly from the scene tensors:
//
//   [0:9)   v0.xyz v1.xyz v2.xyz   world-space triangle   verts[faces[f]]
//   [9:18)  c0.rgb c1.rgb c2.rgb   vertex colors          verts_color[faces[f]]
//   [18]    opacity                                      faces_opacity[f]
//   [19]    intensity                                    faces_intense[b, f]
//   [20:23) z0 z1 z2               NDC depths             verts_ndc[b, faces[f], 2]
//   [23:29) aa x0 y0 x1 y1 x2 y2   CCW screen triangle    aa_face_verts[b, f]
//   [29:32) zeros
//
// with (b, f) from e = min(entry_bf[r], B*F - 1) (sentinel entries, == B*F,
// read the last row, as the JAX package's gather_stream does).
//
// Bound: memory. It writes R * 128 bytes and gathers ~116 bytes per record
// from tables (verts, colours, NDC z, AA corners) that at the headline's
// size (1M faces) do not fit in the 50 MB L2, in an order that is random
// within a tile; it does no arithmetic beyond index math. The gathers are
// what is left to pay: each record's rows are 32-byte sectors scattered
// over ~150 MB. Design:
//   * eight lanes per record: lane k of a group writes words 4k..4k+3 with
//     one 16-byte store, so a warp writes 4 consecutive records, 512
//     contiguous bytes;
//   * per-record work once per warp instruction: the group's lanes read
//     entry_bf[r] and the three vertex ids in the same load instructions
//     (one transaction per record for the four records of the warp), so
//     the lanes of a group execute them together; each lane then issues its
//     four independent gathers through the read-only path before the store
//     that needs them;
//   * one record per group and no loop, so every record of the launch is in
//     flight as soon as the card has room for its warp;
//   * the records are stored with the streaming hint: nothing reads them
//     back before they would be evicted (537 MB at the headline, ten times
//     the L2), and the L2 keeps more of the gathered tables.
// Measured on the H100 (PERF.md): a grid-stride loop that prefetches
// the next record's entry and vertex ids, and vertex ids loaded once per
// group and handed on with __shfl_sync, were each no faster than this. The
// sentinel tail needs no case of its own: its records all gather the same
// row, which stays in L1.

#include <cuda_runtime.h>

namespace {

constexpr int kWords = 32;
constexpr int kGroup = 8;                      // lanes per record
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) pack_stream_kernel(
    const int* __restrict__ entry_bf, long long R,
    const int* __restrict__ faces, const float* __restrict__ verts,
    const float* __restrict__ verts_color, const float* __restrict__ verts_ndc,
    const float* __restrict__ opacity, const float* __restrict__ intense,
    const float* __restrict__ aa, int B, int F, int P,
    float4* __restrict__ out) {
  const long long r = ((long long)blockIdx.x * kThreads + threadIdx.x) / kGroup;
  if (r >= R) return;
  const int k = threadIdx.x & (kGroup - 1);    // word quad of this lane
  const int bf = B * F;
  int e = __ldg(entry_bf + r);
  e = e < bf - 1 ? e : bf - 1;
  e = e > 0 ? e : 0;
  const int b = e / F;
  const int f = e - b * F;
  const long long v0 = __ldg(faces + 3LL * f), v1 = __ldg(faces + 3LL * f + 1),
                  v2 = __ldg(faces + 3LL * f + 2);
  const float* p0;
  const float* p1;
  const float* p2;
  const float* p3;
  switch (k) {
    case 0:
      p0 = verts + 3 * v0; p1 = p0 + 1; p2 = p0 + 2; p3 = verts + 3 * v1;
      break;
    case 1:
      p0 = verts + 3 * v1 + 1; p1 = p0 + 1; p2 = verts + 3 * v2; p3 = p2 + 1;
      break;
    case 2:
      p0 = verts + 3 * v2 + 2; p1 = verts_color + 3 * v0; p2 = p1 + 1; p3 = p1 + 2;
      break;
    case 3:
      p0 = verts_color + 3 * v1; p1 = p0 + 1; p2 = p0 + 2; p3 = verts_color + 3 * v2;
      break;
    case 4:
      p0 = verts_color + 3 * v2 + 1; p1 = p0 + 1; p2 = opacity + f; p3 = intense + e;
      break;
    case 5: {
      const float* z = verts_ndc + 3LL * b * P + 2;
      p0 = z + 3 * v0; p1 = z + 3 * v1; p2 = z + 3 * v2; p3 = aa + 6LL * e;
      break;
    }
    case 6:
      p0 = aa + 6LL * e + 1; p1 = p0 + 1; p2 = p0 + 2; p3 = p0 + 3;
      break;
    default:
      p0 = p1 = p2 = p3 = aa + 6LL * e + 5;
      break;
  }
  float4 val = make_float4(__ldg(p0), __ldg(p1), __ldg(p2), __ldg(p3));
  if (k == kGroup - 1) val.y = val.z = val.w = 0.0f;
  __stcs(out + r * (kWords / 4) + k, val);  // streamed: keep L2 for the tables
}

}  // namespace

extern "C" int pack_stream_launch(
    const void* entry_bf, long long R, const void* faces, const void* verts,
    const void* verts_color, const void* verts_ndc, const void* opacity,
    const void* intense, const void* aa, int B, int F, int P, void* out,
    void* stream) {
  const long long blocks = (R * kGroup + kThreads - 1) / kThreads;
  pack_stream_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)entry_bf, R, (const int*)faces, (const float*)verts,
      (const float*)verts_color, (const float*)verts_ndc,
      (const float*)opacity, (const float*)intense, (const float*)aa, B, F, P,
      (float4*)out);
  return (int)cudaGetLastError();
}

// Resources: registers, static and dynamic shared memory, local (spill)
// bytes, resident blocks per SM.
extern "C" int pack_stream_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, pack_stream_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pack_stream_kernel,
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
