// K3: fused masked exact-GP negative log marginal likelihood and, in the
// gradient variant, its analytic gradient in the five log-hyperparameters.
//
// Replaces optimalinterpolation_tpu/ops/pallas_gp.py::_gp_nll_call (body
// _nll_kernel; public gp_nll and gp_nll_and_grad). Per cell, in one CTA:
//   1. the lower block triangle of A = K o mm^T + diag((sf2+sn2+jitter*sf2) m
//      + (1 - m)) and its blocked Cholesky A = L L^T (gp_common.cuh);
//   2. z = L^-1 (y m);  nll = |z|^2/2 + sum log l_jj + n_valid/2 log 2 pi;
//   gradient variant only:
//   3. alpha = L^-T z by blocked backward substitution;
//   4. U = L^-T (= T^T for T = L^-1) as an upper block triangle:
//        U_jj = W_j^T,  U_ji = -(sum_{j<=k<i} U_jk L_ik^T) W_i^T  (i > j);
//   5. for every block (i, j), i >= j, of Q = A^-1 - alpha alpha^T
//        = sum_{k>=i} U_ik U_jk^T - alpha_i alpha_j^T
//      the five sums, with the kernel derivatives rebuilt from x:
//        d nll / d log ell_d = 1/2 <Q, sf2 w_kind(r) dq_d^2 o mm^T>
//        d nll / d log sf2   = 1/2 <Q, K o mm^T + jitter sf2 diag(m)>
//        d nll / d log sn2   = 1/2 sn2 sum_i Q_ii m_i
//      off-diagonal blocks counting twice.
// Where a pivot is not positive (NaN hypers included) nll = +inf and the
// gradient is NaN. An all-padding cell (mask 0) has A = I: nll = 0, grad = 0.
// Inputs are f32: log_hypers (B, 5), x (B, N, 3), y (B, N) centered, mask
// (B, N); N a multiple of 128 in [128, 1024]. Outputs nll (B,), grad (B, 5).
//
// Bound on this card: operations. A cell is 4 MB at N = 1024 and the TPU
// kernel keeps A and T (2 x 4 MB) in VMEM, vectorised over a tile of cells; a
// CTA here holds 227 KB. As in K2, a cell is one CTA, and A, U and the W
// blocks live in caller-allocated device-memory scratch ((B, N, N) twice and
// (B, N, 128); the value variant has no U). Every 128x128 tile product (the
// Cholesky's panel and trailing update, step 4's U_jk L_ik^T and S W_i^T,
// step 5's U_ik U_jk^T) runs through gp_common.cuh's tile engine: 3xTF32
// mma.sync on the tensor cores, operands streamed by cp.async in
// double-buffered k-slices. Storing U = L^-T instead of T = L^-1 makes every
// product of steps 4 and 5 an "a b^T" of two row-major tiles. The gradient
// variant does about three times the tile products of the value variant
// (nb = N/128: nb^3/6 each for the Cholesky, U and Q). Step 5 reads the
// accumulators where mma leaves them; the kernel derivatives and the five
// sums stay float32 FMA, reduced in a fixed order (per-thread accumulators,
// warp shuffles, then shared memory in warp order): no atomics, so equal
// inputs give equal bits on every launch, and the value variant runs the
// same Cholesky as the gradient variant, so their values are equal. No batch
// padding: one CTA per row of the batch, so a row's result does not depend
// on which rows share the launch.
#include <cuda_runtime.h>

#include "gp_common.cuh"

namespace {

using oi::BLK;
using oi::kLog2Pi;
using oi::kThreads;
using oi::warp_sum;

constexpr int kGroups = kThreads / BLK;  // column-sweep row groups
constexpr int kWarps = kThreads / 32;

// k / sf2 and w with d k / d log ell_d = sf2 w dq_d^2
// (pallas_gp.py::_shape_fn and ::_dlogell_weight), from one exponential.
__device__ inline void shape_and_weight(int kind, float d2, float& k,
                                        float& w) {
  switch (kind) {
    case 0: {
      const float r = sqrtf(d2);
      const float e = expf(-r);
      k = e;
      w = r > 0.f ? e / r : 0.f;  // d2 = 0 only meets dq = 0
      return;
    }
    case 1: {
      const float r = sqrtf(3.f * d2);
      const float e = expf(-r);
      k = (1.f + r) * e;
      w = 3.f * e;
      return;
    }
    case 2: {
      const float r = sqrtf(5.f * d2);
      const float e = expf(-r);
      k = (1.f + r + r * r / 3.f) * e;
      w = (5.f / 3.f) * e * (1.f + r);
      return;
    }
    default: {
      const float e = expf(-0.5f * d2);
      k = e;
      w = e;
      return;
    }
  }
}

template <bool kGrad>
__global__ void __launch_bounds__(kThreads, 1)
    k3_nll_kernel(const float* __restrict__ log_hypers,
                  const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ mask, float* __restrict__ a_scr,
                  float* __restrict__ u_scr, float* __restrict__ w_scr,
                  float* __restrict__ nll_out, float* __restrict__ grad_out,
                  int n, int kind, float jitter) {
  extern __shared__ __align__(16) float smem[];
  float* R = smem;  // the tile engine's resident tile, then its ring
  float* ring = smem + oi::kTileFloats;
  float* sd = R;                      // block right-hand sides (steps 2-3)
  // 4 n: x/ell_x, y/ell_y, t/ell_t, mask
  float* q = smem + oi::stage_floats(n);
  float* z = q + 4 * n;        // n: y m, then z
  float* al = z + n;           // n: alpha
  float* red = al + n;         // 8 per warp: block reductions

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int cell = blockIdx.x;
  const int nb = n / BLK;
  float* A = a_scr + static_cast<size_t>(cell) * n * n;
  float* Wg = w_scr + static_cast<size_t>(cell) * n * BLK;
  const float nanv = __int_as_float(0x7fc00000);

  // ---- 1. scaled coordinates, lower block triangle of A, Cholesky ---------
  float logdet;
  bool ok;
  {
    const oi::Hypers hyp = oi::load_hypers(log_hypers + cell * 5);
    oi::load_scaled_coords(q, x, mask, cell, n, hyp);
    oi::build_cov_lower(A, q, n, kind, hyp, jitter);
  }
  oi::blocked_cholesky(A, Wg, smem, n, logdet, ok);

  // ---- 2. z = L^-1 (y m) --------------------------------------------------
  for (int i = tid; i < n; i += nt)
    z[i] = y[static_cast<size_t>(cell) * n + i] * q[3 * n + i];
  __syncthreads();
  float* rhs = sd;  // 128: block right-hand side
  for (int ib = 0; ib < nb; ++ib) {
    // rhs_i = ym_i - sum_{t < ib*BLK} L_it z_t, one warp per row
    for (int r = warp; r < BLK; r += kWarps) {
      const int i = ib * BLK + r;
      const float* lrow = A + static_cast<size_t>(i) * n;
      float s = 0.f;
      for (int t = lane; t < ib * BLK; t += 32) s = fmaf(lrow[t], z[t], s);
      s = warp_sum(s);
      if (lane == 0) rhs[r] = z[i] - s;
    }
    __syncthreads();
    // z_ib = W_ib rhs
    for (int r = warp; r < BLK; r += kWarps) {
      const int i = ib * BLK + r;
      const float* wrow = Wg + static_cast<size_t>(i) * BLK;
      float s = 0.f;
      for (int t = lane; t <= r; t += 32) s = fmaf(wrow[t], rhs[t], s);
      s = warp_sum(s);
      if (lane == 0) z[i] = s;
    }
    __syncthreads();
  }

  float s_zz = 0.f, s_m = 0.f;
  for (int i = tid; i < n; i += nt) {
    s_zz = fmaf(z[i], z[i], s_zz);
    s_m += q[3 * n + i];
  }
  s_zz = warp_sum(s_zz);
  s_m = warp_sum(s_m);
  if (lane == 0) {
    red[8 * warp] = s_zz;
    red[8 * warp + 1] = s_m;
  }
  __syncthreads();
  if (tid == 0) {
    float quad = 0.f, n_valid = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      quad += red[8 * k];
      n_valid += red[8 * k + 1];
    }
    const float nll = 0.5f * quad + logdet + 0.5f * n_valid * kLog2Pi;
    nll_out[cell] = ok ? nll : __int_as_float(0x7f800000);
  }
  if (!kGrad) return;

  float* U = u_scr + static_cast<size_t>(cell) * n * n;
  const int col = tid % BLK;  // column sweeps: thread (grp, col)
  const int grp = tid / BLK;
  float* part = sd + BLK;  // kGroups x 128 partial column sums (rhs is sd)

  // ---- 3. alpha = L^-T z, bottom-up ---------------------------------------
  for (int ib = nb - 1; ib >= 0; --ib) {
    const int i0 = ib * BLK;
    // rhs_c = z_c - sum_{r >= (ib+1) BLK} L_rc alpha_r; a warp reads one row
    // of L at 32 neighbouring columns
    float s = 0.f;
    for (int r = (ib + 1) * BLK + grp; r < n; r += kGroups)
      s = fmaf(A[static_cast<size_t>(r) * n + i0 + col], al[r], s);
    part[grp * BLK + col] = s;
    __syncthreads();
    if (tid < BLK) {
      float t = 0.f;
      for (int g = 0; g < kGroups; ++g) t += part[g * BLK + tid];
      rhs[tid] = z[i0 + tid] - t;
    }
    __syncthreads();
    // alpha_c = sum_{r >= c} W_rc rhs_r
    s = 0.f;
    for (int r = grp; r < BLK; r += kGroups)
      if (r >= col)
        s = fmaf(Wg[static_cast<size_t>(i0 + r) * BLK + col], rhs[r], s);
    part[grp * BLK + col] = s;
    __syncthreads();
    if (tid < BLK) {
      float t = 0.f;
      for (int g = 0; g < kGroups; ++g) t += part[g * BLK + tid];
      al[i0 + tid] = t;
    }
    __syncthreads();
  }

  // ---- 4. U = L^-T, one block row at a time -------------------------------
  for (int jb = 0; jb < nb; ++jb) {
    const int j0 = jb * BLK;
    float* urow = U + j0 * n;
    for (int e = tid; e < BLK * BLK; e += nt) {
      const int r = e / BLK;
      const int c = e % BLK;
      urow[r * n + j0 + c] = Wg[(j0 + c) * BLK + r];
    }
    for (int ib = jb + 1; ib < nb; ++ib) {
      const float* arow = A + ib * BLK * n;
      // S = sum_{jb <= kb < ib} U_jk L_ik^T, into R
      oi::tile_stream<false, false, false>(
          ring, R, n, n, 1, [&](int) { return ib - jb; },
          [&](int, int p, const float*& a, const float*& b) {
            a = urow + (jb + p) * BLK;
            b = arow + (jb + p) * BLK;
          },
          [](int, float acc[2][4][4]) { oi::frag_zero(acc); },
          [&](int, float acc[2][4][4]) { oi::frag_store_shared(R, acc); });
      // U_ji = -S W_i^T
      oi::tile_stream<true, false, true>(
          ring, R, 0, BLK, 1, [](int) { return 1; },
          [&](int, int, const float*& a, const float*& b) {
            a = nullptr;
            b = Wg + ib * BLK * BLK;
          },
          [](int, float acc[2][4][4]) { oi::frag_zero(acc); },
          [&](int, float acc[2][4][4]) {
            oi::frag_store(urow + ib * BLK, n, acc);
          });
    }
  }

  // ---- 5. the five sums over the lower block triangle of Q ----------------
  // output o is block (ib, jb), jb <= ib, jb outer: Q_ij + alpha_i alpha_j^T
  // = sum_{kb >= ib} U_ik U_jk^T
  float g0 = 0.f, g1 = 0.f, g2 = 0.f, gs = 0.f, gn = 0.f;
  auto block_of = [nb](int o, int& ib, int& jb) {
    jb = 0;
    while (o >= nb - jb) {
      o -= nb - jb;
      ++jb;
    }
    ib = jb + o;
  };
  oi::tile_stream<false, false, false>(
      ring, R, n, n, nb * (nb + 1) / 2,
      [&](int o) {
        int ib, jb;
        block_of(o, ib, jb);
        return nb - ib;
      },
      [&](int o, int p, const float*& a, const float*& b) {
        int ib, jb;
        block_of(o, ib, jb);
        a = U + ib * BLK * n + (ib + p) * BLK;
        b = U + jb * BLK * n + (ib + p) * BLK;
      },
      [](int, float acc[2][4][4]) { oi::frag_zero(acc); },
      [&](int o, float acc[2][4][4]) {
        int ib, jb;
        block_of(o, ib, jb);
        // read here, not kept live across the products
        int r0, c0;
        oi::frag_origin(r0, c0);
        const oi::Hypers hyp =
            oi::load_hypers(oi::opaque(log_hypers) + cell * 5);
        const float c_jit = jitter * hyp.sf2;
        const float mult = (ib == jb) ? 1.f : 2.f;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gi = ib * BLK + r0 + 16 * mt + 8 * h;
            const float mi = q[3 * n + gi];
            const float ai = al[gi];
#pragma unroll
            for (int ct = 0; ct < 4; ++ct)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int gj = jb * BLK + c0 + 8 * ct + e;
                const float qm = mult * (acc[mt][ct][2 * h + e] - ai * al[gj]) *
                                 (mi * q[3 * n + gj]);
                const float d0 = q[gi] - q[gj];
                const float d1 = q[n + gi] - q[n + gj];
                const float d2 = q[2 * n + gi] - q[2 * n + gj];
                float kv, wv;
                shape_and_weight(kind, d0 * d0 + d1 * d1 + d2 * d2, kv, wv);
                const float qw = qm * (hyp.sf2 * wv);
                g0 = fmaf(qw, d0 * d0, g0);
                g1 = fmaf(qw, d1 * d1, g1);
                g2 = fmaf(qw, d2 * d2, g2);
                gs = fmaf(qm, hyp.sf2 * kv, gs);
                if (gi == gj) {  // only in diagonal blocks, where mult = 1
                  gs = fmaf(c_jit, qm, gs);
                  gn = fmaf(hyp.sn2, qm, gn);
                }
              }
          }
      });
  g0 = warp_sum(g0);
  g1 = warp_sum(g1);
  g2 = warp_sum(g2);
  gs = warp_sum(gs);
  gn = warp_sum(gn);
  if (lane == 0) {
    red[8 * warp + 2] = g0;
    red[8 * warp + 3] = g1;
    red[8 * warp + 4] = g2;
    red[8 * warp + 5] = gs;
    red[8 * warp + 6] = gn;
  }
  __syncthreads();
  if (tid < 5) {
    float t = 0.f;
    for (int k = 0; k < kWarps; ++k) t += red[8 * k + 2 + tid];
    grad_out[cell * 5 + tid] = ok ? 0.5f * t : nanv;
  }
}

}  // namespace

extern "C" int oi_k3_nll(const float* log_hypers, const float* x,
                         const float* y, const float* mask, float* a_scr,
                         float* u_scr, float* w_scr, float* nll, float* grad,
                         int b, int n, int kind, float jitter, int with_grad,
                         int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (n % BLK != 0 || n < BLK || n > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (with_grad && (u_scr == nullptr || grad == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) *
                   (oi::stage_floats(n) + 6 * n + 8 * kWarps);
  auto kernel = with_grad ? k3_nll_kernel<true> : k3_nll_kernel<false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b, kThreads, smem, stream>>>(log_hypers, x, y, mask, a_scr, u_scr,
                                        w_scr, nll, grad, n, kind, jitter);
  return static_cast<int>(cudaGetLastError());
}
