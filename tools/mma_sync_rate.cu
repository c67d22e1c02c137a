// Tensor-core rates one CTA of 512 threads per SM reaches with mma.sync, for
// the tile engine of csrc/gp_common.cuh. Build and run on a machine with an
// H100, from the root of the repository:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -o /tmp/mma_sync_rate tools/mma_sync_rate.cu && /tmp/mma_sync_rate
//
// Prints one JSON line with, for 132 CTAs (one per SM) of 16 warps:
//   raw_*      mma.sync m16n8k8 TF32 on register operands, 8 independent
//              accumulator tiles a warp (the engine's 2 x 4), no loads;
//   engine_*   the engine's inner step, warp_mma_k16 (float4 fragment loads
//              from a shared-memory slice, the 3xTF32 split, 48 mma.sync and
//              the FADDs of the chunk sums a warp), over the 8 chunks of one
//              128x128x128 product, with no barrier and no copy;
// each as TFLOP/s of tensor-core work (2 x 1024 FLOP an m16n8k8) and as
// microseconds per 128x128x128 product in 3xTF32 (6,144 mma.sync a CTA).
#include <cstdio>

#include "../optimalinterpolation_tpu_torch/csrc/gp_common.cuh"

namespace {

constexpr int kIters = 2000;

__global__ void __launch_bounds__(oi::kThreads, 1) raw_mma(float* out) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x - i));
  float acc[8][4] = {};
  for (int it = 0; it < kIters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) oi::mma_tf32(acc[j], a, b);
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(oi::kThreads, 1) engine_step(float* out) {
  __shared__ __align__(16) float slice[oi::kSliceFloats];  // a and b rows
  for (int e = threadIdx.x; e < oi::kSliceFloats; e += blockDim.x)
    slice[e] = 1e-3f * (e % 97);
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const float* sa = slice + 32 * (warp / 4) * oi::KS;
  const float* sb = slice + 32 * (warp % 4) * oi::KS;
  float acc[2][4][4];
  oi::frag_zero(acc);
  for (int it = 0; it < kIters / 8; ++it)
    for (int c = 0; c < 8; ++c)  // 8 chunks of 16 columns: one product
      oi::warp_mma_k16<false, oi::KS, oi::KS>(sa, sb, 16 * (c % 4), acc);
  float s = 0.f;
  for (int mt = 0; mt < 2; ++mt)
    for (int nt = 0; nt < 4; ++nt)
      for (int e = 0; e < 4; ++e) s += acc[mt][nt][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <class K>
float time_ms(K kernel, float* out) {
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  kernel<<<132, oi::kThreads>>>(out);
  cudaEventRecord(t0);
  for (int r = 0; r < 5; ++r) kernel<<<132, oi::kThreads>>>(out);
  cudaEventRecord(t1);
  cudaEventSynchronize(t1);
  float ms;
  cudaEventElapsedTime(&ms, t0, t1);
  return ms / 5;
}

}  // namespace

int main() {
  float* out;
  cudaMalloc(&out, 132 * oi::kThreads * sizeof(float));
  // mma.sync a CTA: raw 16 warps x 8 x kIters; engine 16 x 48 x kIters
  const double raw_mma_per_cta = 16.0 * 8 * kIters;
  const double eng_mma_per_cta = 16.0 * 48 * kIters;
  const float raw = time_ms(raw_mma, out);
  const float eng = time_ms(engine_step, out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    std::printf("{\"error\": \"%s\"}\n", cudaGetErrorString(err));
    return 1;
  }
  const double flop = 2.0 * 1024;
  std::printf(
      "{\"raw_ms\": %.6f, \"raw_tflops\": %.3f, \"raw_us_per_product\": %.4f, "
      "\"engine_ms\": %.6f, \"engine_tflops\": %.3f, "
      "\"engine_us_per_product\": %.4f}\n",
      raw, 132 * raw_mma_per_cta * flop / (raw * 1e-3) / 1e12,
      raw * 1e3 / (raw_mma_per_cta / 6144.0), eng,
      132 * eng_mma_per_cta * flop / (eng * 1e-3) / 1e12,
      eng * 1e3 / (eng_mma_per_cta / 6144.0));
  return 0;
}
