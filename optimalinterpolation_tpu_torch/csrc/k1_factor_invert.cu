// K1: batched 128x128 factor + inverse.
//
// Replaces optimalinterpolation_tpu/ops/blocked_gp.py::_factor_invert_pallas
// (body _factor_kernel -> pallas_gp._factor_invert_inplace). Input: B
// symmetric blocks (B, 128, 128) f32. Output: L (lower, zeros above), W = L^-1,
// logdet (B,), ok (B,) bool.
//
// Bound on this card: one block is 128 sequential pivot steps with a barrier
// each; the arithmetic (~128^3/3 FMAs) is small next to that latency chain.
// Design: one CTA per block, both 64 KB operands in dynamic shared memory for
// the whole factorization (so the kernel reads each block once and writes L
// and W once), the factorization itself in factor_invert.cuh. The TPU
// kernel's padding of B to a multiple of 8 (its (8, 128) tiling) is not
// carried over.
#include <cuda_runtime.h>

#include "factor_invert.cuh"

namespace {

constexpr int kThreads = 1024;  // 32 warps: the pivot chain is latency-bound

__global__ void __launch_bounds__(kThreads)
    k1_factor_invert_kernel(const float* __restrict__ d, float* __restrict__ l,
                            float* __restrict__ w, float* __restrict__ logdet,
                            bool* __restrict__ ok) {
  using oi::BLK;
  using oi::LDS;
  extern __shared__ float smem[];
  float* sd = smem;
  float* sw = smem + BLK * LDS;
  const size_t base = static_cast<size_t>(blockIdx.x) * BLK * BLK;
  for (int e = threadIdx.x; e < BLK * BLK; e += blockDim.x) {
    const int r = e / BLK;
    const int c = e % BLK;
    sd[r * LDS + c] = d[base + e];
    sw[r * LDS + c] = (r == c) ? 1.f : 0.f;
  }
  __syncthreads();
  float ld;
  bool good;
  oi::factor_invert_128(sd, sw, ld, good);
  for (int e = threadIdx.x; e < BLK * BLK; e += blockDim.x) {
    const int r = e / BLK;
    const int c = e % BLK;
    l[base + e] = (c <= r) ? sd[r * LDS + c] : 0.f;
    w[base + e] = sw[r * LDS + c];
  }
  if (threadIdx.x == 0) {
    logdet[blockIdx.x] = ld;
    ok[blockIdx.x] = good;
  }
}

}  // namespace

extern "C" int oi_k1_factor_invert(const float* d, float* l, float* w,
                                   float* logdet, bool* ok, int b, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  const int smem = 2 * oi::BLK * oi::LDS * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(k1_factor_invert_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_factor_invert_kernel<<<b, kThreads, smem, stream>>>(d, l, w, logdet, ok);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* oi_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
