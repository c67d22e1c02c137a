// K2: fused per-cell exact-GP posterior predict at one test point.
//
// Replaces optimalinterpolation_tpu/ops/pallas_gp.py::gp_predict (body
// _predict_kernel). Per cell, in one CTA:
//   1. the lower block triangle of A = K o mm^T + diag((sf2+sn2+jitter*sf2) m
//      + (1 - m)), built from x scaled by 1/ell before differencing;
//   2. a right-looking blocked Cholesky A = L L^T: the 128x128 diagonal block
//      in shared memory through factor_invert.cuh (giving W_kk = L_kk^-1),
//      the panel L_ik = A_ik W_kk^T and the trailing update
//      A_ij -= L_ik L_jk^T in 3xTF32 on the tensor cores;
//   3. one forward sweep for z = L^-1 (y - mean) m and v = L^-1 k*, with k*
//      built from xstar;
//   4. mean = mean + z.v, std = sqrt(max(sf2 - |v|^2, 0)),
//      lZ = -(|z|^2/2 + logdet + n_valid/2 log 2 pi), prior_std = sqrt(sf2),
//      ok; NaN in mean, std and lZ where not ok.
// Inputs are f32: log_hypers (B, 5), x (B, N, 3), y (B, N), xstar (B, 3),
// mask (B, N), mean (B,); N a multiple of 128 in [128, 1024]. Output
// (B, 5) = [mean, std, lZ, prior_std, ok].
//
// Bound on this card: an (N, N) f32 cell is 1 MB at N = 512 and 4 MB at
// N = 1024, far above the 227 KB of shared memory a CTA may hold, so the
// TPU's whole-cell-in-VMEM design does not carry over. A and the W_kk blocks
// live in caller-allocated device-memory scratch ((B, N, N) and (B, N, 128));
// the Cholesky's tile products run through gp_common.cuh's tile engine
// (3xTF32 mma.sync on the tensor cores, operands streamed by cp.async in
// double-buffered k-slices), and each diagonal block adds the latency of
// factor_invert.cuh (32-wide warp panels). One CTA per cell: several CTAs per
// cell (a thread-block cluster), wgmma and TMA are later work.
#include <cuda_runtime.h>

#include "gp_common.cuh"

namespace {

using oi::BLK;
using oi::kLog2Pi;
using oi::kThreads;
using oi::shape_fn;
using oi::warp_sum;

__global__ void __launch_bounds__(kThreads, 1)
    k2_predict_kernel(const float* __restrict__ log_hypers,
                      const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ xstar,
                      const float* __restrict__ mask,
                      const float* __restrict__ mean, float* __restrict__ a_scr,
                      float* __restrict__ w_scr, float* __restrict__ out,
                      int n, int kind, float jitter) {
  extern __shared__ __align__(16) float smem[];
  float* sd = smem;  // the tile engine's stage, then block right-hand sides
  // 4 n: x/ell_x, y/ell_y, t/ell_t, mask
  float* q = smem + oi::stage_floats(n);
  float* zv = q + 4 * n;       // 2 n: right-hand sides, then z and v
  float* red = zv + 2 * n;     // 4 per warp: block reduction

  const int cell = blockIdx.x;
  const int nb = n / BLK;

  // ---- 0.-2. scaled coordinates, lower block triangle of A, Cholesky ------
  float logdet;
  bool ok;
  {
    float* A = a_scr + static_cast<size_t>(cell) * n * n;
    const oi::Hypers hyp = oi::load_hypers(log_hypers + cell * 5);
    oi::load_scaled_coords(q, x, mask, cell, n, hyp);
    oi::build_cov_lower(A, q, n, kind, hyp, jitter);
    oi::blocked_cholesky(A, w_scr + static_cast<size_t>(cell) * n * BLK, smem,
                         n, logdet, ok);
  }
  // pointers and hypers formed again rather than kept live (and spilled)
  // across the Cholesky
  const float* A = oi::opaque(a_scr) + static_cast<size_t>(cell) * n * n;
  const float* Wg = oi::opaque(w_scr) + static_cast<size_t>(cell) * n * BLK;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = nt / 32;
  const oi::Hypers hyp = oi::load_hypers(oi::opaque(log_hypers) + cell * 5);
  const float inv_ell0 = hyp.inv_ell0;
  const float inv_ell1 = hyp.inv_ell1;
  const float inv_ell2 = hyp.inv_ell2;
  const float sf2 = hyp.sf2;
  const float mu = mean[cell];

  // ---- 3. dual forward solve: z = L^-1 ym, v = L^-1 k* --------------------
  const float xs0 = xstar[cell * 3] * inv_ell0;
  const float xs1 = xstar[cell * 3 + 1] * inv_ell1;
  const float xs2 = xstar[cell * 3 + 2] * inv_ell2;
  for (int i = tid; i < n; i += nt) {
    const float mi = q[3 * n + i];
    const float d0 = q[i] - xs0;
    const float d1 = q[n + i] - xs1;
    const float d2 = q[2 * n + i] - xs2;
    zv[i] = (y[static_cast<size_t>(cell) * n + i] - mu) * mi;
    zv[n + i] = sf2 * shape_fn(kind, d0 * d0 + d1 * d1 + d2 * d2) * mi;
  }
  __syncthreads();
  float* rz = sd;        // 128: block right-hand side for z
  float* rv = sd + BLK;  // 128: block right-hand side for v
  for (int ib = 0; ib < nb; ++ib) {
    // rhs_i - sum_{t < ib*BLK} L_it [z, v]_t, one warp per row
    for (int r = warp; r < BLK; r += nwarps) {
      const int i = ib * BLK + r;
      const float* lrow = A + static_cast<size_t>(i) * n;
      float sz = 0.f;
      float sv = 0.f;
      for (int t = lane; t < ib * BLK; t += 32) {
        const float lv = lrow[t];
        sz = fmaf(lv, zv[t], sz);
        sv = fmaf(lv, zv[n + t], sv);
      }
      sz = warp_sum(sz);
      sv = warp_sum(sv);
      if (lane == 0) {
        rz[r] = zv[i] - sz;
        rv[r] = zv[n + i] - sv;
      }
    }
    __syncthreads();
    // [z, v]_ib = W_ib [rz, rv]
    for (int r = warp; r < BLK; r += nwarps) {
      const int i = ib * BLK + r;
      const float* wrow = Wg + static_cast<size_t>(i) * BLK;
      float sz = 0.f;
      float sv = 0.f;
      for (int t = lane; t <= r; t += 32) {
        const float wv = wrow[t];
        sz = fmaf(wv, rz[t], sz);
        sv = fmaf(wv, rv[t], sv);
      }
      sz = warp_sum(sz);
      sv = warp_sum(sv);
      if (lane == 0) {
        zv[i] = sz;
        zv[n + i] = sv;
      }
    }
    __syncthreads();
  }

  // ---- 4. reductions and outputs ------------------------------------------
  float s_zz = 0.f, s_zv = 0.f, s_vv = 0.f, s_m = 0.f;
  for (int i = tid; i < n; i += nt) {
    const float z = zv[i];
    const float v = zv[n + i];
    s_zz = fmaf(z, z, s_zz);
    s_zv = fmaf(z, v, s_zv);
    s_vv = fmaf(v, v, s_vv);
    s_m += q[3 * n + i];
  }
  s_zz = warp_sum(s_zz);
  s_zv = warp_sum(s_zv);
  s_vv = warp_sum(s_vv);
  s_m = warp_sum(s_m);
  if (lane == 0) {
    red[4 * warp] = s_zz;
    red[4 * warp + 1] = s_zv;
    red[4 * warp + 2] = s_vv;
    red[4 * warp + 3] = s_m;
  }
  __syncthreads();
  if (tid == 0) {
    float quad = 0.f, zdotv = 0.f, vv = 0.f, n_valid = 0.f;
    for (int k = 0; k < nwarps; ++k) {
      quad += red[4 * k];
      zdotv += red[4 * k + 1];
      vv += red[4 * k + 2];
      n_valid += red[4 * k + 3];
    }
    const float nanv = __int_as_float(0x7fc00000);
    const float var = fmaxf(sf2 - vv, 0.f);
    const float lz = -(0.5f * quad + logdet + 0.5f * n_valid * kLog2Pi);
    float* o = out + cell * 5;
    o[0] = ok ? mu + zdotv : nanv;
    o[1] = ok ? sqrtf(var) : nanv;
    o[2] = ok ? lz : nanv;
    o[3] = sqrtf(sf2);
    o[4] = ok ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" int oi_k2_predict(const float* log_hypers, const float* x,
                             const float* y, const float* xstar,
                             const float* mask, const float* mean,
                             float* a_scr, float* w_scr, float* out, int b,
                             int n, int kind, float jitter, int device,
                             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b <= 0) return 0;
  if (n % BLK != 0 || n < BLK || n > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(sizeof(float)) *
                   (oi::stage_floats(n) + 6 * n + 4 * (kThreads / 32));
  err = cudaFuncSetAttribute(k2_predict_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k2_predict_kernel<<<b, kThreads, smem, stream>>>(
      log_hypers, x, y, xstar, mask, mean, a_scr, w_scr, out, n, kind, jitter);
  return static_cast<int>(cudaGetLastError());
}
