// Float32 rate calibration: the quadratic map x <- a - x*x, elementwise.
//
// Replaces: benchmarks/micro_vpu.py::make_kernel.kernel (the Pallas kernel
// that calibrates the TPU's sustained float32 VPU rate). For a float32 block
// x it computes a = x * 1e-7 + 1.62, then iters times x = a - x*x, and
// writes the final x. The map has no closed form and a loop-invariant a, so
// the compiler can neither fold the loop away nor reassociate it; iters is a
// runtime argument, so it cannot unroll the whole loop either.
//
// Two instances of one kernel, so that one build gives both:
//   * uncontracted (contract = 0): x = __fsub_rn(a, __fmul_rn(x, x)), two
//     instructions per iteration, each rounded. The intrinsics are never
//     fused into an FMA, whatever -fmad says. This is the port's function
//     and matches how every other port kernel is built (-fmad=false): it
//     equals its plain PyTorch version bit for bit at every iters.
//   * contracted (contract = 1): x = __fmaf_rn(-x, x, a), one FMA, rounded
//     once.
// Both count 2 operations per element per iteration (micro_vpu.py:78), so
// the data-sheet peak (67e12/s, which counts an FMA as two) is the ceiling
// of the contracted instance; the uncontracted one issues twice the
// instructions for the same count.
//
// Bound: operations. Each element is read once and written once (8 bytes)
// and costs 2 * iters operations. Design: one thread per element, x and a in
// registers, one dependent chain per thread, the loop unrolled deep. A
// (512, 1024) block is 16,384 warps, about 124 per SM over 132 SMs; 64
// resident warps per SM, 16 per scheduler, hide the 4-cycle float32 latency
// of one chain each.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The loop's counter, compare and branch take issue slots that the float32
// pipe needs: with 64 map steps per trip the contracted instance read
// below 90% of the data-sheet peak on the H100, with 256 near 96% (PERF.md),
// and two independent chains per thread gave no more than the deeper
// unroll. The remainder runs one step per trip.
constexpr int kUnroll = 256;

template <bool kContract>
__device__ __forceinline__ float map_step(float x, float a) {
  return kContract ? __fmaf_rn(-x, x, a) : __fsub_rn(a, __fmul_rn(x, x));
}

template <bool kContract>
__global__ void __launch_bounds__(kThreads) quad_map_kernel(
    const float* __restrict__ x_in, long long n, int iters,
    float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float x = x_in[i];
  const float a = __fadd_rn(__fmul_rn(x, 1e-7f), 1.62f);
  int k = 0;
  for (; k + kUnroll <= iters; k += kUnroll) {
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) x = map_step<kContract>(x, a);
  }
#pragma unroll 1
  for (; k < iters; ++k) x = map_step<kContract>(x, a);
  out[i] = x;
}

}  // namespace

extern "C" int quad_map_launch(const void* x, long long n, int iters,
                               int contract, void* out, void* stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (contract) {
    quad_map_kernel<true><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, n, iters, (float*)out);
  } else {
    quad_map_kernel<false><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, n, iters, (float*)out);
  }
  return (int)cudaGetLastError();
}

// Resources of the uncontracted instance: registers, static and dynamic
// shared memory, local (spill) bytes, resident blocks per SM.
extern "C" int quad_map_occupancy(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, quad_map_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, quad_map_kernel<false>, kThreads, 0);
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
