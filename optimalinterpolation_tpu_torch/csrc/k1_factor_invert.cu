// K1: batched 128x128 factor + inverse.
//
// Replaces optimalinterpolation_tpu/ops/blocked_gp.py::_factor_invert_pallas
// (body _factor_kernel -> pallas_gp._factor_invert_inplace). Input: B
// symmetric blocks (B, 128, 128) f32. Output: L (lower, zeros above), W = L^-1,
// logdet (B,), ok (B,) bool.
//
// Bound on this card: latency. One block is ~2 x 128^3 / 3 FMAs, small next
// to the sequential pivot chain. Design: one CTA per block, both 66 KB
// operands (d and W, row stride 129) in dynamic shared memory for the whole
// factorization, so the kernel reads each block once and writes L and W
// once; the factorization itself is factor_invert.cuh (32-wide warp panels,
// 11 CTA barriers). 512 threads, not 1024: the warp that factors a diagonal
// 32x32 block keeps a row of A and of W in registers (64 floats a lane),
// which needs up to 128 registers a thread, and 1024 threads would allow 64.
// One CTA per SM: the two operands take 132 KB of the SM's 228 KB, so a
// second CTA would need W packed into the upper triangle that the routine
// uses as scratch; not done. The TPU kernel's padding of B to a multiple of 8
// (its (8, 128) tiling) is not carried over.
#include <cuda_runtime.h>

#include "factor_invert.cuh"

namespace {

constexpr int kThreads = 512;  // 16 warps; see the note above

__global__ void __launch_bounds__(kThreads, 1)
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
