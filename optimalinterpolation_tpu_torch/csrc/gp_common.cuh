// Shared device routines of K2 (fused predict) and K3 (fused NLL + gradient):
// one CTA of kThreads threads works on one cell whose (N, N) matrices live in
// caller-allocated device-memory scratch, 128x128 tiles at a time in shared
// memory.
//
// They replace the first half of both TPU kernel bodies in
// optimalinterpolation_tpu/ops/pallas_gp.py (_nll_kernel and _predict_kernel:
// the covariance build from x and the blocked right-looking Cholesky), which
// the TPU runs on a whole cell held in VMEM. Here only the operands of one
// tile product and the scaled coordinates are on chip at a time.
//
// The tile engine (tile_stream) runs every 128x128x128 product a b^T of K2
// and K3 on the tensor cores, in 3xTF32: mma.sync m16n8k8 with each operand
// split into hi = tf32(x) and lo = tf32(x - hi), and a_lo b_hi + a_hi b_lo,
// then + a_hi b_hi (lo lo dropped), summed on the tensor cores over 16
// columns at a time and added to float32 accumulators with round-to-nearest.
// That keeps close to float32 accuracy (each operand carried to ~2^-22) at
// three tensor-core products, where one TF32 product (~1e-3 relative) would
// break the Cholesky chain. 16 warps, a 32x32 warp tile each (2 x 4 m16n8
// tiles, 32 accumulators a lane). Operands reach shared memory through cp.async
// 16-byte copies in 128 x KS k-slices, two stages: slice s + 1 is in flight
// while slice s is multiplied, across product and output boundaries, with
// one CTA barrier a slice. A lane reads its fragments as float4s (columns
// 4t..4t+3 of rows g, g + 8 for lane (g, t)): the two k8 steps of a 16-wide
// chunk take columns (4t, 4t+1) and (4t+2, 4t+3) as their k = t and t + 4,
// the same assignment for a and b, so the sum covers every column; an XOR
// swizzle of the 16-byte chunks of odd rows (swz) puts the 8 lanes of each
// float4 phase on distinct banks without padding.
#pragma once

#include <cuda_runtime.h>

#include "factor_invert.cuh"

namespace oi {

constexpr int kThreads = 512;  // 16 warps: a 32x32 warp tile of every product
constexpr float kLog2Pi = 1.8378770664093453f;

// Shared-memory layout of the tile engine, in floats: the resident tile R
// (BLK x BLK in a region of BLK x LDS), the ring of k-slices (the a slices
// of stages 0 and 1, then their b slices, BLK x KS each), then
// blocked_cholesky's running logdet and pivot test (4 floats). The diagonal
// step reuses R's region for factor_invert_128's d (BLK x LDS) and the
// ring's start for its w. At n = BLK no product streams a b slice (the
// Cholesky is one diagonal block, and step 5's one product has a == b), so
// the ring is only w's size there: the shared memory, and with it the L1
// carve-out, stays what the diagonal step alone needs.
constexpr int KS = 64;  // k-slice width
constexpr int kSliceFloats = BLK * KS;
constexpr int kTileFloats = BLK * LDS;
static_assert(BLK * LDS <= 4 * kSliceFloats && 2 * kSliceFloats <= BLK * LDS,
              "w must fit in the ring, and the a slices in w's size");

// The engine's floats for a cell of n points; the kernel's own arrays follow.
__host__ __device__ constexpr int stage_floats(int n) {
  return kTileFloats + (n == BLK ? BLK * LDS : 4 * kSliceFloats) + 4;
}

// Rows of R and of a slice are unpadded (BLK and KS floats); the 16-byte
// chunks of odd rows are XOR-swizzled by 4 (float column c of row r sits at
// c ^ swz(r)), so that the 8 lanes of a float4 fragment load (rows g, g + 1,
// chunks t = 0..3) hit the 32 banks once each.
__device__ inline int swz(int r) { return (r & 1) << 4; }

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

// p, opaque to the compiler: what is loaded or formed from it is not merged
// with, or hoisted above, earlier code, so a value needed after a long phase
// (the Cholesky, a panel of products) is formed again there instead of being
// kept live, and spilled, across it.
template <class T>
__device__ inline T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
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

// ---- the tile engine -------------------------------------------------------

// threadIdx.x, read where it is used: the engine's per-thread offsets are
// recomputed (a few integer operations) instead of being hoisted and kept
// live across the whole kernel, which would spill beside the 32
// accumulators and the diagonal factor's registers.
__device__ inline int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ inline void cp_async16(float* s, const float* g) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(g));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copies of 128 rows of W floats (columns of g, row stride ld) into s (row
// stride W, swizzled): a k-slice (W = KS) or a resident tile (W = BLK). The
// caller commits them.
template <int W>
__device__ inline void load_rows_async(float* s, const float* g, int ld) {
#pragma unroll
  for (int i = 0; i < BLK * W / 4 / kThreads; ++i) {
    const int c = thread_index() + i * kThreads;
    const int r = c / (W / 4);
    const int q = 4 * (c % (W / 4));
    cp_async16(s + r * W + (q ^ swz(r)), g + r * ld + q);
  }
}

// tf32 rounding of a finite x as cvt.rna.tf32.f32 does it (to nearest, ties
// away from zero: add half a unit of the 10-bit mantissa to the magnitude,
// then truncate), in two integer operations; with the conversion instruction
// the tile products took ~8% longer on the H100. An infinite x stays
// infinite. A NaN with a payload in the top 13 bits could round into the
// sign; NaN hypers make every entry of A NaN, the first pivot included, and
// the cell returns (+inf, NaN) whatever its products give.
__device__ inline unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both TF32 (round to nearest, ties away).
__device__ inline void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ inline void mma_tf32(float c[4], const unsigned a[4],
                                const unsigned b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp, one 16-wide chunk: acc += a b^T (a negated if kNegA) for the
// warp's 32x32 tile. a points at the warp's first a row (row stride AS), b
// at its first b row (stride BS), both swizzled (swz) with even first rows;
// c is the chunk's first column. The a fragments of both k8 steps are split
// first; then one b row tile at a time. Each 16-column sum goes through the
// tensor cores from zero (6 mma.sync) and is added to acc by an FADD: the
// tensor cores' float32 accumulation truncates, and folded into acc over a
// whole product chain it cost an ill-conditioned cell (sn2 at the jitter)
// 6x the float32 twin's value error (tools/time_fused_kernels.py).
template <bool kNegA, int AS, int BS>
__device__ inline void warp_mma_k16(const float* a, const float* b, int c,
                                    float acc[2][4][4]) {
  const int lane = thread_index() % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int col = (c ^ swz(g)) + 4 * t;  // rows g + 8 i share g's parity
  // ah/al[s][mt]: step s's fragment (row, k) a0 (g, t), a1 (g+8, t),
  // a2 (g, t+4), a3 (g+8, t+4) of rows 16 mt..
  unsigned ah[2][2][4], al[2][2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float4 r0 =
        *reinterpret_cast<const float4*>(a + (16 * mt + g) * AS + col);
    const float4 r8 =
        *reinterpret_cast<const float4*>(a + (16 * mt + 8 + g) * AS + col);
    const float x[2][4] = {{r0.x, r8.x, r0.y, r8.y}, {r0.z, r8.z, r0.w, r8.w}};
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(kNegA ? -x[s][e] : x[s][e], ah[s][mt][e], al[s][mt][e]);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float4 bv =
        *reinterpret_cast<const float4*>(b + (8 * nt + g) * BS + col);
    const float y[2][2] = {{bv.x, bv.y}, {bv.z, bv.w}};
    unsigned bh[2][2], bl[2][2];  // step s: b0 (k = t), b1 (k = t + 4)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      split_tf32(y[s][0], bh[s][0], bl[s][0]);
      split_tf32(y[s][1], bh[s][1], bl[s][1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      // the chunk's 16-column sum on the tensor cores, from zero; then
      // added to acc in float32 with round-to-nearest
      float part[4] = {};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        mma_tf32(part, al[s][mt], bh[s]);
        mma_tf32(part, ah[s][mt], bl[s]);
        mma_tf32(part, ah[s][mt], bh[s]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
    }
  }
}

// The output position of this lane's accumulators: acc[mt][nt][2 h + e] is
// element (r0 + 16 mt + 8 h, c0 + 8 nt + e) of the 128x128 output tile.
__device__ inline void frag_origin(int& r0, int& c0) {
  const int tid = thread_index();
  const int warp = tid / 32;
  const int lane = tid % 32;
  r0 = 32 * (warp / 4) + lane / 4;
  c0 = 32 * (warp % 4) + 2 * (lane % 4);
}

__device__ inline void frag_zero(float acc[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// acc = the tile at g (row stride ld).
__device__ inline void frag_load(const float* g, int ld, float acc[2][4][4]) {
  int r0, c0;
  frag_origin(r0, c0);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            g + (r0 + 16 * mt + 8 * h) * ld + c0 + 8 * nt);
        acc[mt][nt][2 * h] = v.x;
        acc[mt][nt][2 * h + 1] = v.y;
      }
}

// The tile at g (row stride ld) = acc.
__device__ inline void frag_store(float* g, int ld, const float acc[2][4][4]) {
  int r0, c0;
  frag_origin(r0, c0);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(g + (r0 + 16 * mt + 8 * h) * ld + c0 +
                                   8 * nt) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
}

// The swizzled shared-memory tile t (row stride BLK) = acc.
__device__ inline void frag_store_shared(float* t, const float acc[2][4][4]) {
  int r0, c0;
  frag_origin(r0, c0);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * mt + 8 * h;
        *reinterpret_cast<float2*>(t + r * BLK + ((c0 + 8 * nt) ^ swz(r))) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
}

// Every thread asks L2 for one 128-byte line of the 128x128 tile at g.
__device__ inline void prefetch_tile_l2(const float* g, int ld) {
  const int tid = thread_index();
  const float* p = g + (tid / 4) * ld + 32 * (tid % 4);
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// n_out output tiles, one after another: output o is init(o, acc) plus the
// sum over p < pairs(o) of a_p b_p^T (a_p negated if kNegA), handed to
// epi(o, acc). tiles(o, p, a, b) gives the global origins of the streamed
// operands (row strides lda, ldb); with kResA (kResB) the a (b) operand of
// every product is instead the resident tile res (BLK x BLK, swizzled),
// whose load_rows_async<BLK> copies the caller has committed. A streamed
// pair with a == b is staged once. The k-slices of all products stream
// through the ring in one sequence, the next slice in flight while one is
// multiplied.
// Call with all threads; starts and ends with a barrier.
template <bool kResA, bool kResB, bool kNegA, class Pairs, class Tiles,
          class Init, class Epi>
__device__ inline void tile_stream(float* ring, const float* res, int lda,
                                   int ldb, int n_out, Pairs pairs,
                                   Tiles tiles, Init init, Epi epi) {
  constexpr int kSlices = BLK / KS;
  constexpr int AS = kResA ? BLK : KS;
  constexpr int BS = kResB ? BLK : KS;
  // stage st: its a slice at ring + st S, its b slice at ring + (2 + st) S
  auto fetch = [&](int o, int p, int k, int st) {
    const float* ga;
    const float* gb;
    tiles(o, p, ga, gb);
    float* buf = ring + st * kSliceFloats;
    if (!kResA) load_rows_async<KS>(buf, ga + k * KS, lda);
    if (!kResB && (kResA || gb != ga))
      load_rows_async<KS>(buf + 2 * kSliceFloats, gb + k * KS, ldb);
    cp_async_commit();
  };
  __syncthreads();  // the ring (and res) are free
  fetch(0, 0, 0, 0);
  int st = 0;  // the stage slice (o, p, k) is in
  float acc[2][4][4];
  for (int o = 0; o < n_out; ++o) {
    init(o, acc);
    const int np = pairs(o);
    for (int p = 0; p < np; ++p) {
      const float* ga;
      const float* gb;
      tiles(o, p, ga, gb);
      const bool same = !kResA && !kResB && ga == gb;
      for (int k = 0; k < kSlices; ++k) {
        cp_async_wait_all();
        // slice (o, p, k) is visible, and every warp is done with the stage
        // the next fetch overwrites
        __syncthreads();
        if (k + 1 < kSlices)
          fetch(o, p, k + 1, st ^ 1);
        else if (p + 1 < np)
          fetch(o, p + 1, 0, st ^ 1);
        else if (o + 1 < n_out)
          fetch(o + 1, 0, 0, st ^ 1);
        const int warp = thread_index() / 32;
        const float* buf = ring + st * kSliceFloats;
        // the warp's first rows; a resident tile at the slice's columns
        // (a multiple of KS, which the swizzle leaves alone)
        const float* sa = kResA ? res + 32 * (warp / 4) * BLK + k * KS
                                : buf + 32 * (warp / 4) * KS;
        const float* sb = kResB ? res + 32 * (warp % 4) * BLK + k * KS
                                : buf + (same ? 0 : 2 * kSliceFloats) +
                                      32 * (warp % 4) * KS;
#pragma unroll 1  // unrolled, the chunks' loads spill
        for (int c = 0; c < KS; c += 16)
          warp_mma_k16<kNegA, AS, BS>(sa, sb, c, acc);
        st ^= 1;
      }
    }
    epi(o, acc);
  }
  __syncthreads();
}

// The lower triangle of a 128x128 tile at g (row stride ld) into d (stride
// LDS), for factor_invert_128; plain loads, the diagonal step's only
// synchronous copy.
__device__ inline void load_diag_block(float* d, const float* g, int ld) {
  for (int e = thread_index(); e < BLK * BLK; e += kThreads) {
    const int r = e / BLK;
    const int c = e % BLK;
    if (c <= r) d[r * LDS + c] = g[r * ld + c];
  }
}

// Right-looking blocked Cholesky A = L L^T of the cell's lower block triangle,
// in place: on return A holds L (diagonal blocks lower-triangular with zeros
// above) and Wg (n, 128) the blocks W_kk = L_kk^-1. smem is the engine's
// stage_floats(n). The 128x128 diagonal block goes through factor_invert_128
// (d in R, w in the ring, stride LDS); then W_kk, copied into R, is the
// resident b operand of the panel L_ik = A_ik W_kk^T, and L_ik the resident,
// negated a operand of trailing row i, A_ij += (-L_ik) L_jk^T with A_ij
// loaded into the accumulators and stored once. Every thread returns the
// same logdet = sum log l_jj and ok = every pivot > 0. Ends with a barrier.
__device__ inline void blocked_cholesky(float* A, float* Wg, float* smem,
                                        int n, float& logdet, bool& ok) {
  const int nb = n / BLK;
  float* R = smem;
  float* ring = smem + kTileFloats;
  float* sd = R;
  float* sw = ring;
  // the running logdet and pivot test, kept by thread 0 in shared memory:
  // two registers fewer across the tile products
  float* sums = smem + stage_floats(n) - 4;
  if (thread_index() == 0) {
    sums[0] = 0.f;
    sums[1] = 1.f;
  }
  for (int kb = 0; kb < nb; ++kb) {
    const int k0 = kb * BLK;
    float* Akk = A + k0 * n + k0;
    load_diag_block(sd, Akk, n);
    __syncthreads();
    float ld;
    bool okk;
    factor_invert_128(sd, sw, ld, okk);
    if (thread_index() == 0) {
      sums[0] += ld;
      if (!okk) sums[1] = 0.f;
    }
    for (int e = thread_index(); e < BLK * BLK; e += kThreads) {
      const int r = e / BLK;
      const int c = e % BLK;
      Akk[r * n + c] = (c <= r) ? sd[r * LDS + c] : 0.f;
      Wg[(k0 + r) * BLK + c] = sw[r * LDS + c];
    }
    if (kb == nb - 1) break;
    __syncthreads();  // d (and its logdet slots) read by every thread
    for (int e = thread_index(); e < BLK * BLK; e += kThreads) {
      const int r = e / BLK;
      R[r * BLK + ((e % BLK) ^ swz(r))] = sw[r * LDS + e % BLK];
    }
    // panel: L_ik = A_ik W_kk^T for ib > kb, in place
    float* col = A + k0;  // column block kb
    tile_stream<false, true, false>(
        ring, R, n, 0, nb - 1 - kb, [](int) { return 1; },
        [&](int o, int, const float*& a, const float*& b) {
          a = col + (k0 + BLK * (o + 1)) * n;
          b = nullptr;
        },
        [](int, float acc[2][4][4]) { frag_zero(acc); },
        [&](int o, float acc[2][4][4]) {
          frag_store(col + (k0 + BLK * (o + 1)) * n, n, acc);
        });
    // trailing row ib: A_ij -= L_ik L_jk^T for kb < jb <= ib
    for (int ib = kb + 1; ib < nb; ++ib) {
      float* arow = opaque(A) + ib * BLK * n;  // formed here, not hoisted
      load_rows_async<BLK>(R, arow + k0, n);
      cp_async_commit();
      tile_stream<true, false, true>(
          ring, R, 0, n, ib - kb, [](int) { return 1; },
          [&](int o, int, const float*& a, const float*& b) {
            a = nullptr;
            b = col + BLK * (kb + 1 + o) * n;
          },
          [&](int o, float acc[2][4][4]) {
            if (o + 1 < ib - kb) prefetch_tile_l2(arow + BLK * (kb + 2 + o), n);
            frag_load(arow + BLK * (kb + 1 + o), n, acc);
          },
          [&](int o, float acc[2][4][4]) {
            frag_store(arow + BLK * (kb + 1 + o), n, acc);
          });
    }
  }
  __syncthreads();
  logdet = sums[0];
  ok = sums[1] != 0.f;
}

}  // namespace oi
