// Shared device routine of K1, K2 and K3: factor one symmetric 128x128 f32
// block held in shared memory, fused with W = L^-1.
//
// Replaces the unrolled elimination of
// optimalinterpolation_tpu/ops/pallas_gp.py::_factor_invert_inplace, with the
// same semantics: a right-looking Cholesky whose row operations, applied to I,
// build W = L^-1 (E A = L^T  =>  E = L^-1); logdet is sum 0.5 * log(pivot)
// with pivots clamped at 1e-37 and NaN kept NaN; ok is "every pivot > 0".
//
// Bound on this card: latency, not arithmetic (~128^3 / 3 FMAs for each of
// L and W). The 128 pivots are sequential; with one CTA barrier and one
// shared-memory pass per pivot (the TPU's order carried over) a block took
// ~0.19 ms on the H100, paid serially by every diagonal step of K2 and K3.
// Design: the block is cut into 4 x 4 blocks of 32 and taken one 32-wide
// panel p at a time (tests/test_torch_factor_panels.py transcribes it):
//   1. one warp factors the diagonal 32x32 block: lane k holds row k of A_pp
//      and of W_pp in registers, 32 pivot steps broadcast with __shfl_sync
//      and no CTA barrier, the row operations applied to I in the same steps
//      (W_pp = L_pp^-1), pivots clamped as above;
//   2. all warps: the panel L_ip = A_ip W_pp^T (i > p) in place, and the
//      finished off-diagonal blocks of W in block row p, W_pj = W_pp R_pj
//      (j < p);
//   3. all warps: the trailing update A_ij -= L_ip L_jp^T on the lower
//      triangle, and R_ij -= L_ip W_pj (i > p, j <= p; R_ip = -L_ip W_pp).
// R_ij = -sum_{j <= k < i} L_ik W_kj is the right-looking form of the block
// recurrence W_ij = -W_ii sum_{k=j}^{i-1} L_ik W_kj; it is kept, transposed,
// in the strictly upper 32-blocks of d, which no caller reads. Steps 2 and 3
// are warp tiles of 16 rows x 32 columns, a 4x4 register tile a lane, over
// 32-deep sums in a fixed order (no atomics: equal inputs give equal bits);
// with LDS = 129 the lanes of each operand load hit distinct banks. CTA
// barriers: 3 for each of panels 0-2, 2 for panel 3: 11 in all, against 128
// before. Arithmetic stays float32 FMA (no tensor cores, no TF32).
#pragma once

#include <cuda_runtime.h>

namespace oi {

constexpr int BLK = 128;
constexpr int LDS = BLK + 1;  // padded shared-memory row stride
constexpr int PW = 32;        // panel width: the lanes of one warp
constexpr int NP = BLK / PW;  // panels
constexpr int kTileRows = 16;  // rows of one warp tile in steps 2 and 3
constexpr int kTilesPerBlock = PW / kTileRows;
constexpr unsigned kFullMask = 0xffffffffu;

// One warp, a 16x32 tile: acc[i][jj] = sum_{t < 32} a[row LDS + t]
// b[t BT + col BC] for row = 4 (lane / 8) + i and col = lane % 8 + 8 jj, t in
// order. Each step reads 4 values of a (8 lanes share each) and 4 of b for
// 16 FMAs a lane; with LDS = 129 the lanes of one load hit distinct banks.
template <int BT, int BC>
__device__ inline void warp_tile(const float* a, const float* b, int lane,
                                 float acc[4][4]) {
  const float* ar = a + 4 * (lane / 8) * LDS;
  const float* bc = b + (lane % 8) * BC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
#pragma unroll 4
  for (int t = 0; t < PW; ++t) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ar[i * LDS + t];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) bv[jj] = bc[t * BT + 8 * jj * BC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
  }
}

// Step 1, one warp: the 32x32 diagonal block at (p0, p0) of d (lower
// triangle) -> L_pp into that lower triangle and W_pp (zeros above) into w;
// adds this block's 32 terms 0.5 log(pivot) to ld in pivot order and its
// pivot test to good, the same on every lane. Registers: at step j a lane
// holds entries j.. of its row of A and entries ..j of its row of W (33 live
// values, not 64): entry j of A is stored as L once step j scales it, and
// entry j of W enters as the identity's at step j. Row j of W is used
// unscaled by the rows below it and never again, so lane j keeps its pivot
// and scales its row once at the end; the log and the test run there too.
// Per step, the chain is a shuffle, the IEEE square root and reciprocal,
// and three multiply-adds. Their slow paths are branches that cut the 32
// unrolled steps into short blocks. With rsqrtf the steps are one
// straight-line block that ptxas interleaves until all four kernels spill
// (40-120 bytes each); with a log and a flag left in every step, K3's
// gradient variant spilled 14 bytes.
__device__ inline void factor_diag_32(float* d, float* w, int p0, int lane,
                                      float& ld, bool& good) {
  float c[PW];  // row `lane` of A_pp, columns <= lane (the rest unused)
  float v[PW];  // row `lane` of W_pp, unscaled
  float my_piv = 0.f;  // pivot `lane`, clamped at 1e-37 (NaN stays NaN)
  bool my_good = true;
  float* drow = d + (p0 + lane) * LDS + p0;
#pragma unroll
  for (int k = 0; k < PW; ++k) c[k] = k <= lane ? drow[k] : 0.f;
#pragma unroll
  for (int j = 0; j < PW; ++j) {
    v[j] = lane == j ? 1.f : 0.f;
    const float piv = __shfl_sync(kFullMask, c[j], j);
    const float piv_s = piv < 1e-37f ? 1e-37f : piv;
    const float rs = 1.f / sqrtf(piv_s);
    const float l = c[j] * rs;  // L_ij for lanes i >= j
    const float f = lane > j ? l * rs : 0.f;
    // trailing rows: A_ik -= f A_kj (A_kj = row k's column j, on lane k)
#pragma unroll
    for (int k = j + 1; k < PW; ++k)
      c[k] = fmaf(-f, __shfl_sync(kFullMask, c[j], k), c[k]);
    // the same row operation on W: row i -= f row j
#pragma unroll
    for (int k = 0; k <= j; ++k)
      v[k] = fmaf(-f, __shfl_sync(kFullMask, v[k], j), v[k]);
    if (lane >= j) drow[j] = l;
    if (lane == j) {
      my_piv = piv_s;
      my_good = piv > 0.f;
    }
  }
  const float my_rs = 1.f / sqrtf(my_piv);
  float* wrow = w + (p0 + lane) * LDS + p0;
#pragma unroll
  for (int k = 0; k < PW; ++k) wrow[k] = k <= lane ? v[k] * my_rs : 0.f;
  const float my_log = 0.5f * logf(my_piv);
#pragma unroll
  for (int j = 0; j < PW; ++j) ld += __shfl_sync(kFullMask, my_log, j);
  good = good && __all_sync(kFullMask, my_good);
}

// d: symmetric block, row stride LDS; only its lower triangle is read, and
// its strictly upper part is scratch (clobbered).
// w: any contents on entry, row stride LDS.
// On return: the lower triangle of d holds L, w holds W = L^-1 (lower
// triangular, zeros above), and every thread of the block holds the same
// logdet and ok. All threads of the block must call it; blockDim.x must be a
// multiple of 32 and at least 64.
__device__ inline void factor_invert_128(float* d, float* w, float& logdet,
                                         bool& ok) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int nwarps = nt / 32;
  const int lr = 4 * (lane / 8);  // this lane's rows and columns of a tile:
  const int lc = lane % 8;        // lr + i and lc + 8 jj (warp_tile)
  float ld = 0.f;  // warp 0's running sums
  bool good = true;
  float acc[4][4];
  for (int p = 0; p < NP; ++p) {
    const int p0 = p * PW;
    // ---- 1. diagonal block: warp 0; the others zero W's upper blocks ----
    if (warp == 0) {
      factor_diag_32(d, w, p0, lane, ld, good);
      if (p == NP - 1 && lane == 0) {
        d[1] = ld;  // above the diagonal of block (0, 0): free scratch
        d[2] = good ? 1.f : 0.f;
      }
    } else if (p == 0) {
      for (int e = tid - 32; e < BLK * BLK; e += nt - 32) {
        const int r = e / BLK;
        const int c = e % BLK;
        if (c / PW > r / PW) w[r * LDS + c] = 0.f;
      }
    }
    __syncthreads();
    // ---- 2. panel L_ip = A_ip W_pp^T (i > p); W_pj = W_pp R_pj (j < p) --
    const int n_panel = (NP - 1 - p) * kTilesPerBlock;
    const int n_w = p * kTilesPerBlock;
    for (int task = warp; task < n_panel + n_w; task += nwarps) {
      if (task < n_panel) {
        float* a = d + (p0 + PW + task * kTileRows) * LDS + p0;
        warp_tile<1, LDS>(a, w + p0 * LDS + p0, lane, acc);
        __syncwarp();  // the warp's rows are read before they are written
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            a[(lr + i) * LDS + lc + 8 * jj] = acc[i][jj];
      } else {
        const int t = task - n_panel;
        const int j0 = (t / kTilesPerBlock) * PW;
        const int r0 = p0 + (t % kTilesPerBlock) * kTileRows;
        // R_pj[u][c] sits at d[(j0 + c) LDS + p0 + u]
        warp_tile<1, LDS>(w + r0 * LDS + p0, d + j0 * LDS + p0, lane, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            w[(r0 + lr + i) * LDS + j0 + lc + 8 * jj] = acc[i][jj];
      }
    }
    __syncthreads();
    if (p == NP - 1) break;
    // ---- 3. A_ij -= L_ip L_jp^T (p < j <= i); R_ij -= L_ip W_pj (j <= p) --
    const int m = NP - 1 - p;
    const int n_trail = m * (m + 1) / 2 * kTilesPerBlock;
    const int n_r = m * (p + 1) * kTilesPerBlock;
    for (int task = warp; task < n_trail + n_r; task += nwarps) {
      const int rt = (task % kTilesPerBlock) * kTileRows;
      if (task < n_trail) {
        int blk = task / kTilesPerBlock;  // -> (bi, bj), p < bj <= bi
        int bi = p + 1;
        while (blk > bi - p - 1) {
          blk -= bi - p;
          ++bi;
        }
        const int bj = p + 1 + blk;
        const int r0 = bi * PW + rt;
        warp_tile<1, LDS>(d + r0 * LDS + p0, d + bj * PW * LDS + p0, lane, acc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (bi != bj || lc + 8 * jj <= rt + lr + i)  // lower triangle
              d[(r0 + lr + i) * LDS + bj * PW + lc + 8 * jj] -= acc[i][jj];
      } else {
        const int k = task / kTilesPerBlock - n_trail / kTilesPerBlock;
        const int i0 = (p + 1 + k / (p + 1)) * PW;
        const int j = k % (p + 1);
        const int r0 = i0 + rt;
        warp_tile<LDS, 1>(d + r0 * LDS + p0, w + p0 * LDS + j * PW, lane, acc);
        // R_ij[r][c] sits at d[(j PW + c) LDS + i0 + r]
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            float* dst = d + (j * PW + lc + 8 * jj) * LDS + r0 + lr + i;
            *dst = j == p ? -acc[i][jj] : *dst - acc[i][jj];
          }
      }
    }
    __syncthreads();
  }
  logdet = d[1];
  ok = d[2] != 0.f;
}

}  // namespace oi
