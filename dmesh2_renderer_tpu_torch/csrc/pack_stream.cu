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
// from tables that sit in L2 at the sizes the renderer uses; it does no
// arithmetic beyond index math. Design: one warp per record, one thread per
// word, so every warp's store is one fully coalesced 128-byte line; the
// gathered reads of a warp hit at most 3 vertex rows plus the face's rows.

#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 32;

__global__ void pack_stream_kernel(
    const int* __restrict__ entry_bf, long long n_words,
    const int* __restrict__ faces, const float* __restrict__ verts,
    const float* __restrict__ verts_color, const float* __restrict__ verts_ndc,
    const float* __restrict__ opacity, const float* __restrict__ intense,
    const float* __restrict__ aa, int B, int F, int P,
    float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  long long r = i / kWidth;
  int w = (int)(i - r * kWidth);
  int bf = B * F;
  int e = entry_bf[r];
  e = e < bf - 1 ? e : bf - 1;
  e = e > 0 ? e : 0;
  int b = e / F;
  int f = e - b * F;
  float val = 0.0f;
  if (w < 9) {
    val = verts[(long long)faces[f * 3 + w / 3] * 3 + w % 3];
  } else if (w < 18) {
    int c = w - 9;
    val = verts_color[(long long)faces[f * 3 + c / 3] * 3 + c % 3];
  } else if (w == 18) {
    val = opacity[f];
  } else if (w == 19) {
    val = intense[e];
  } else if (w < 23) {
    long long vid = faces[f * 3 + (w - 20)];
    val = verts_ndc[((long long)b * P + vid) * 3 + 2];
  } else if (w < 29) {
    val = aa[(long long)e * 6 + (w - 23)];
  }
  out[i] = val;
}

}  // namespace

extern "C" int pack_stream_launch(
    const void* entry_bf, long long R, const void* faces, const void* verts,
    const void* verts_color, const void* verts_ndc, const void* opacity,
    const void* intense, const void* aa, int B, int F, int P, void* out,
    void* stream) {
  long long n_words = R * kWidth;
  const int threads = 256;
  long long blocks = (n_words + threads - 1) / threads;
  pack_stream_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)entry_bf, n_words, (const int*)faces, (const float*)verts,
      (const float*)verts_color, (const float*)verts_ndc,
      (const float*)opacity, (const float*)intense, (const float*)aa, B, F, P,
      (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
