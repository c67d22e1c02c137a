// Shared device routines of K2 (fused predict) and K3 (fused NLL + gradient):
// one CTA of kThreads threads works on one cell whose (N, N) matrices live in
// caller-allocated device-memory scratch, 128x128 tiles at a time in shared
// memory.
//
// They replace the first half of both TPU kernel bodies in
// optimalinterpolation_tpu/ops/pallas_gp.py (_nll_kernel and _predict_kernel:
// the covariance build from x and the blocked right-looking Cholesky), which
// the TPU runs on a whole cell held in VMEM. Here only two 128x128 tile
// operands and the scaled coordinates are on chip at a time; every tile
// product is float32 FMA (no tensor cores, no TF32).
#pragma once

#include <cuda_runtime.h>

#include "factor_invert.cuh"

namespace oi {

constexpr int kThreads = 512;  // 32 x 16 threads, a 4x8 output tile each
constexpr float kLog2Pi = 1.8378770664093453f;

// k / sf2 as a function of the scaled squared distance d2
// (pallas_gp.py::_shape_fn). kind: 0 Matern-1/2, 1 Matern-3/2,
// 2 Matern-5/2, 3 squared exponential.
__device__ inline float shape_fn(int kind, float d2) {
  switch (kind) {
    case 0:
      return expf(-sqrtf(d2));
    case 1: {
      const float r = sqrtf(3.f * d2);
      return (1.f + r) * expf(-r);
    }
    case 2: {
      const float r = sqrtf(5.f * d2);
      return (1.f + r + r * r / 3.f) * expf(-r);
    }
    default:
      return expf(-0.5f * d2);
  }
}

__device__ inline void load_block(float* s, const float* g, int r0, int c0,
                                  int n) {
  for (int e = threadIdx.x; e < BLK * BLK; e += blockDim.x) {
    const int r = e / BLK;
    const int c = e % BLK;
    s[r * LDS + c] = g[static_cast<size_t>(r0 + r) * n + c0 + c];
  }
}

// acc += a b^T for two 128x128 shared-memory tiles (row stride LDS). Thread
// (ty, tx) owns rows ty + 32 ii and columns tx + 16 jj: a warp reads two rows
// of a and sixteen of b per step, all on distinct banks.
__device__ inline void tile_abt_acc(const float* a, const float* b,
                                    float acc[4][8]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll 4
  for (int t = 0; t < BLK; ++t) {
    float av[4];
    float bv[8];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) av[ii] = a[(ty + 32 * ii) * LDS + t];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) bv[jj] = b[(tx + 16 * jj) * LDS + t];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
  }
}

__device__ inline void tile_zero(float acc[4][8]) {
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[ii][jj] = 0.f;
}

// acc = a b^T.
__device__ inline void tile_abt(const float* a, const float* b,
                                float acc[4][8]) {
  tile_zero(acc);
  tile_abt_acc(a, b, acc);
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The five hyperparameters of one cell, out of log space.
struct Hypers {
  float inv_ell0, inv_ell1, inv_ell2, sf2, sn2;
};

__device__ inline Hypers load_hypers(const float* lh) {
  Hypers h;
  h.inv_ell0 = expf(-lh[0]);
  h.inv_ell1 = expf(-lh[1]);
  h.inv_ell2 = expf(-lh[2]);
  h.sf2 = expf(lh[3]);
  h.sn2 = expf(lh[4]);
  return h;
}

// q (4 n floats of shared memory) = x / ell_x, y / ell_y, t / ell_t, mask of
// this cell's n points. Ends with a barrier.
__device__ inline void load_scaled_coords(float* q, const float* x,
                                          const float* mask, int cell, int n,
                                          const Hypers& h) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* xi = x + (static_cast<size_t>(cell) * n + i) * 3;
    q[i] = xi[0] * h.inv_ell0;
    q[n + i] = xi[1] * h.inv_ell1;
    q[2 * n + i] = xi[2] * h.inv_ell2;
    q[3 * n + i] = mask[static_cast<size_t>(cell) * n + i];
  }
  __syncthreads();
}

// The lower block triangle of
//   A = K o mm^T + diag((sf2 + sn2 + jitter sf2) m + (1 - m))
// into the cell's (n, n) scratch, from per-dimension differences of the
// scaled coordinates (never a^2 + b^2 - 2ab). Ends with a barrier.
__device__ inline void build_cov_lower(float* A, const float* q, int n,
                                       int kind, const Hypers& h,
                                       float jitter) {
  const int nb = n / BLK;
  const float dval = h.sf2 + h.sn2 + jitter * h.sf2;
  for (int ib = 0; ib < nb; ++ib) {
    for (int jb = 0; jb <= ib; ++jb) {
      for (int e = threadIdx.x; e < BLK * BLK; e += blockDim.x) {
        const int i = ib * BLK + e / BLK;
        const int j = jb * BLK + e % BLK;
        const float mi = q[3 * n + i];
        float v;
        if (i == j) {
          v = dval * mi + (1.f - mi);
        } else {
          const float d0 = q[i] - q[j];
          const float d1 = q[n + i] - q[n + j];
          const float d2 = q[2 * n + i] - q[2 * n + j];
          v = h.sf2 * shape_fn(kind, d0 * d0 + d1 * d1 + d2 * d2) * mi *
              q[3 * n + j];
        }
        A[static_cast<size_t>(i) * n + j] = v;
      }
    }
  }
  __syncthreads();
}

// Right-looking blocked Cholesky A = L L^T of the cell's lower block triangle,
// in place: on return A holds L (diagonal blocks lower-triangular with zeros
// above) and Wg (n, 128) the blocks W_kk = L_kk^-1. The 128x128 diagonal block
// goes through factor_invert_128 in shared memory, the panel L_ik = A_ik
// W_kk^T and the trailing update A_ij -= L_ik L_jk^T as SIMT tiles out of the
// two shared-memory operands sd and sw (BLK x LDS floats each). Every thread
// returns the same logdet = sum log l_jj and ok = every pivot > 0. Ends with
// a barrier.
__device__ inline void blocked_cholesky(float* A, float* Wg, float* sd,
                                        float* sw, int n, float& logdet,
                                        bool& ok) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nb = n / BLK;
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][8];
  logdet = 0.f;
  ok = true;
  for (int kb = 0; kb < nb; ++kb) {
    const int k0 = kb * BLK;
    load_block(sd, A, k0, k0, n);
    __syncthreads();
    float ld;
    bool okk;
    factor_invert_128(sd, sw, ld, okk);
    logdet += ld;
    ok = ok && okk;
    for (int e = tid; e < BLK * BLK; e += nt) {
      const int r = e / BLK;
      const int c = e % BLK;
      A[static_cast<size_t>(k0 + r) * n + k0 + c] =
          (c <= r) ? sd[r * LDS + c] : 0.f;
      Wg[static_cast<size_t>(k0 + r) * BLK + c] = sw[r * LDS + c];
    }
    // panel: L_ik = A_ik W_kk^T
    for (int ib = kb + 1; ib < nb; ++ib) {
      __syncthreads();
      load_block(sd, A, ib * BLK, k0, n);
      __syncthreads();
      tile_abt(sd, sw, acc);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          A[static_cast<size_t>(ib * BLK + ty + 32 * ii) * n + k0 + tx +
            16 * jj] = acc[ii][jj];
    }
    __syncthreads();
    // trailing update of the lower block triangle: A_ij -= L_ik L_jk^T
    for (int ib = kb + 1; ib < nb; ++ib) {
      load_block(sd, A, ib * BLK, k0, n);
      for (int jb = kb + 1; jb <= ib; ++jb) {
        load_block(sw, A, jb * BLK, k0, n);
        __syncthreads();
        tile_abt(sd, sw, acc);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            A[static_cast<size_t>(ib * BLK + ty + 32 * ii) * n + jb * BLK +
              tx + 16 * jj] -= acc[ii][jj];
        __syncthreads();
      }
    }
    __syncthreads();
  }
}

}  // namespace oi
