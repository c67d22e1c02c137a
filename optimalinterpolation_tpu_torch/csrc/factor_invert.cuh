// Shared device routine of K1 and K2: factor one symmetric 128x128 f32 block
// held in shared memory, fused with W = L^-1.
//
// Replaces the unrolled elimination of
// optimalinterpolation_tpu/ops/pallas_gp.py::_factor_invert_inplace, with the
// same semantics: a right-looking Cholesky whose row operations, applied to I,
// build W = L^-1 in the same pass (E A = L^T  =>  E = L^-1); logdet is
// sum 0.5 * log(pivot) with pivots clamped at 1e-37; ok is "every pivot > 0".
//
// Bound on this card: the 128 pivots are sequential, each followed by a
// barrier, and each step is a rank-1 update of at most 128x128 shared-memory
// words. The design keeps both 64 KB operands in shared memory for the whole
// factorization (no device-memory traffic between steps), updates only the
// lower triangle (the trailing block stays symmetric, so column j stands in
// for row j), and pads rows to LDS = 129 words so that column reads hit 32
// distinct banks. One barrier per pivot: the scaling of step j touches neither
// the trailing block nor row j+1 of W, so it overlaps step j+1.
#pragma once

#include <cuda_runtime.h>

namespace oi {

constexpr int BLK = 128;
constexpr int LDS = BLK + 1;  // padded shared-memory row stride

// d: symmetric block, row stride LDS; only its lower triangle is read.
// w: must hold the identity on entry, row stride LDS.
// On return: the lower triangle of d holds L (the upper triangle is left as
// it was), w holds W = L^-1 (lower triangular, zeros above), and every
// thread of the block holds the same logdet and ok. All threads of the block
// must call it; blockDim.x must be a multiple of 32.
__device__ inline void factor_invert_128(float* d, float* w, float& logdet,
                                         bool& ok) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = nt / 32;
  float ld = 0.f;
  bool good = true;
  for (int j = 0; j < BLK; ++j) {
    const float piv = d[j * LDS + j];
    good = good && (piv > 0.f);
    const float piv_s = piv < 1e-37f ? 1e-37f : piv;  // NaN stays NaN
    ld += 0.5f * logf(piv_s);
    const float inv = 1.f / piv_s;
    // Rows i > j, one warp per row: columns c <= j of W take the
    // elimination, the trailing lower triangle j < c <= i the rank-1
    // downdate; together exactly the columns c <= i.
    for (int i = j + 1 + warp; i < BLK; i += nwarps) {
      const float f = d[i * LDS + j] * inv;
      for (int c = lane; c <= i; c += 32) {
        if (c <= j) {
          w[i * LDS + c] -= f * w[j * LDS + c];
        } else {
          d[i * LDS + c] -= f * d[c * LDS + j];
        }
      }
    }
    __syncthreads();
    // Column j of L and row j of W, scaled by 1/sqrt(pivot).
    const float rs = 1.f / sqrtf(piv_s);
    for (int e = tid; e < BLK; e += nt) {
      if (e >= j) d[e * LDS + j] *= rs;
      if (e <= j) w[j * LDS + e] *= rs;
    }
  }
  __syncthreads();
  logdet = ld;
  ok = good;
}

}  // namespace oi
