// Per-draw small dense linear algebra in shared memory for kernels that
// give a draw a few warps of its own (settle.cu, cycle_reduction.cu,
// dare.cu): products on the FP64 tensor cores (tile_mm), the Lyapunov
// doubling built on them (tile_lyap_doubling), matrix-vector products
// (tile_mv) and a Gauss-Jordan elimination that one warp runs alone
// (warp_gj_solve_regs, warp_gj_solve_shared).
//
// Counterparts of the shared Pallas helpers in
// geconpy_tpu/ops/pallas_cycle_reduction.py: _mm (:52), _mmT (:73) and
// _gj_solve (:90).  The TPU kernels keep the batch in the 128 vector lanes;
// here a few warps own one draw and its matrices live in shared memory.
//
// Reductions (max |.|, min |pivot|, the pivot search) run in a fixed order
// inside one warp with no atomics, so results are deterministic.  NaN
// propagates through every min/max, as jnp.minimum/jnp.max do, so a
// non-finite draw poisons only its own outputs and flags.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gcp {

constexpr double kLog2Pi = 1.8378770664093453;

template <typename S>
__device__ __forceinline__ S nan_min(S a, S b) {
  return (isnan(a) || isnan(b)) ? (a + b) : (a < b ? a : b);
}

template <typename S>
__device__ __forceinline__ S nan_max(S a, S b) {
  return (isnan(a) || isnan(b)) ? (a + b) : (a > b ? a : b);
}

// Does (v, i) win over (best, bi) as the pivot?  Larger |entry| wins; a
// tie goes to the lower row, as jnp.argmax takes the FIRST maximum; NaN
// counts as the largest value (jnp.argmax and torch.argmax agree).
template <typename S>
__device__ __forceinline__ bool pivot_wins(S v, int i, S best, int bi) {
  const bool vn = isnan(v), bn = isnan(best);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > best || (v == best && i < bi);
}

// Per-lane value to the warp's max (NaN-propagating), stored by lane 0.
__device__ __forceinline__ void warp_max_to(double v, double* slot, int lane) {
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) *slot = v;
}

// ---------------------------------------------------------------------------
// The warp-level helpers.
//
// Such a kernel spends its time dispatching instructions, not waiting for
// memory: a warp that owns one 16 x 16 tile of a 26 x 26 product has 16 mma
// to do, and every clamp, mask and index around them costs as much as an
// mma.  Hence the "tile layout" of a matrix for these helpers: row-major in
// shared memory with ceil16(rows) stored rows and a leading dimension
// tile_ld(cols) >= ceil8(cols), every stored entry outside the logical rows
// x cols being ZERO.  A helper then reads and writes whole tiles with no
// bounds test: pad rows and columns of a product come out as sums of
// zeros, and the inner dimension runs over whole 8-wide steps.  tile_ld is
// 4 mod 8: the 8 rows x 4 columns of doubles that a warp loads as one mma
// operand then fall into 32 different banks.  Vectors are zero-padded to
// ceil8 of their length.  (A draw that already holds an infinity or a NaN
// may get NaN in its pads, 0 x inf; its logical entries in the same rows
// and columns are then not finite either.  No buffer holds two draws.)
// ---------------------------------------------------------------------------

__host__ __device__ inline int ceil8(int v) { return (v + 7) & ~7; }
__host__ __device__ inline int ceil16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline int ceil32(int v) { return (v + 31) & ~31; }

// leading dimension of the tile layout: the smallest value >= ceil8(cols)
// that is 4 mod 8
__host__ __device__ inline int tile_ld(int cols) { return ceil8(cols) + 4; }

// Which warp of its draw a thread is in, of how many, and its lane.
struct WarpCtx {
  int warp;
  int n_warps;
  int lane;
};

// D(16 x 8) += A(16 x 4) B(4 x 8) in float64 on the tensor cores.  Lane l
// holds a0 = A[l / 4][l % 4], a1 = A[8 + l / 4][l % 4], b = B[l % 4][l / 4]
// and the accumulators d[0..1] = D[l / 4][2 (l % 4) + {0, 1}], d[2..3] the
// same columns of row 8 + l / 4.  (The H100 starts this shape as often as
// m8n8k4, which therefore reaches only half of the card's float64
// tensor-core rate: 33.6 against 67.3 TFLOP/s measured.)
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4], double a0,
                                            double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// One product for tile_mm: value(i, j) = sign * (A op(B) [+ A2 B2'])(i, j)
// [+ (i == j)] [+ E(i, j)] [+ G(i, j)] for an (r x m) result.  A (r x c), B
// (c x m, or m x c when transB), A2 (r x c2), B2 (m x c2; c2 = 0: none), E
// and C are in shared memory in the tile layout; G (tile_mm's argument) is
// a plain row-major matrix in device memory.  The value goes to C (unless
// null) and, rounded to the I/O type, to the plain row-major O in device
// memory (tile_mm's argument, unless null).
struct TileProduct {
  const double* A; int lda;
  const double* B; int ldb; bool transB;
  int r, c, m;
  const double* A2; int lda2;
  const double* B2; int ldb2; int c2;
  double sign; bool eye;
  const double* E; int lde;
  double* C; int ldc;
};

// The product `p` by the warps of one draw.  A work item is 16 rows x 16
// columns of the result (x 8 where the result has no more columns): per
// 8-wide step of the inner dimension a warp loads four A and four B operands
// for four mma (2,048 multiply-adds) on two sets of accumulators, so its
// chain of dependent mma is half the inner dimension.  With kTall a work item
// is 32 rows x 16 columns and a warp loads six operands for four mma per
// 4-wide step: the matrices then need ceil32(rows) stored rows.  Only an
// epilogue that reads or writes device memory, or adds the identity, tests
// bounds.  The caller synchronises the draw's warps before (operands
// written) and after (result read); E and C may be the same buffer.
template <typename S, bool kTall = false>
__device__ __forceinline__ void tile_mm(const TileProduct& p, const S* G,
                                        int ldg, S* O, int ldo, WarpCtx w) {
  constexpr int kRowShift = kTall ? 5 : 4;   // 32 or 16 rows an item
  const int g = w.lane >> 2, t = w.lane & 3;
  const int col_tiles = (p.m + 7) >> 3;
  const int chunks = (col_tiles + 1) >> 1;
  const int items = ((p.r + (1 << kRowShift) - 1) >> kRowShift) * chunks;
  // B(l, j) = B[j * sj + l * sl]
  const int sj = p.transB ? p.ldb : 1, sl = p.transB ? 1 : p.ldb;
  for (int item = w.warp; item < items; item += w.n_warps) {
    const int ic = item / chunks;
    const int i0 = ic << kRowShift, j0 = (item - ic * chunks) << 4;
    // the item's right-hand 8 columns exist?  If not, that half repeats the
    // left-hand one and is not stored
    const bool second = (j0 >> 3) + 1 < col_tiles;
    const int jr = second ? j0 + 8 : j0;
    // [set of the inner dimension, or with kTall the item's upper or lower
    // 16 rows][left or right 8 columns][fragment]
    double acc[2][2][4] = {};
    auto accumulate = [&](const double* a0, int lda, const double* b0,
                          const double* b1, int step, int c) {
      const double* a1 = a0 + 8 * lda;
      if constexpr (kTall) {
        // 16 more rows share each B operand: 6 loads a 4 mma, not 8
        const double* a2 = a0 + 16 * lda;
        const double* a3 = a0 + 24 * lda;
#pragma unroll 1
        for (int l = 0; l < c; l += 4) {
          const double x0 = a0[l], x1 = a1[l], x2 = a2[l], x3 = a3[l];
          const double y0 = b0[l * step], y1 = b1[l * step];
          dmma_16x8x4(acc[0][0], x0, x1, y0);
          dmma_16x8x4(acc[0][1], x0, x1, y1);
          dmma_16x8x4(acc[1][0], x2, x3, y0);
          dmma_16x8x4(acc[1][1], x2, x3, y1);
        }
      } else {
        // not unrolled: two steps at once cost registers (spills at 128 a
        // thread) and time (3.95 against 3.74 ms for the settle kernel)
#pragma unroll 1
        for (int l = 0; l < c; l += 8) {
          const double x0 = a0[l], x1 = a1[l], x2 = a0[l + 4],
                       x3 = a1[l + 4];
          const double y0 = b0[l * step], y1 = b1[l * step];
          const double y2 = b0[(l + 4) * step], y3 = b1[(l + 4) * step];
          dmma_16x8x4(acc[0][0], x0, x1, y0);
          dmma_16x8x4(acc[0][1], x0, x1, y1);
          dmma_16x8x4(acc[1][0], x2, x3, y2);
          dmma_16x8x4(acc[1][1], x2, x3, y3);
        }
      }
    };
    accumulate(p.A + (i0 + g) * p.lda + t, p.lda,
               p.B + (j0 + g) * sj + t * sl, p.B + (jr + g) * sj + t * sl, sl,
               p.c);
    if (p.c2 > 0)
      accumulate(p.A2 + (i0 + g) * p.lda2 + t, p.lda2,
                 p.B2 + (j0 + g) * p.ldb2 + t, p.B2 + (jr + g) * p.ldb2 + t, 1,
                 p.c2);
    const bool bounded = G != nullptr || O != nullptr || p.eye;
#pragma unroll
    for (int rt = 0; rt < (kTall ? 2 : 1); ++rt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 16 * rt + 8 * h + g;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q == 1 && !second) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 8 * q + 2 * t + e;
            const int f = 2 * h + e;
            double val = p.sign * (kTall ? acc[rt][q][f]
                                         : acc[0][q][f] + acc[1][q][f]);
            if (p.E) val += p.E[i * p.lde + j];
            if (bounded) {
              if (i < p.r && j < p.m) {
                if (p.eye && i == j) val += 1.0;
                if (G) val += double(G[i * ldg + j]);
                if (O) O[i * ldo + j] = S(val);
              } else {
                val = 0.0;
              }
            }
            if (p.C) p.C[i * p.ldc + j] = val;
          }
        }
      }
    }
  }
}

// A plain product for tile_mm: C (tile layout, ldc) = A op(B), an (r x m)
// result over c terms, with no second term, sign +1, no identity and no
// epilogue matrix.
__device__ __forceinline__ TileProduct tile_product(const double* A, int lda,
                                                    const double* B, int ldb,
                                                    bool transB, int r, int c,
                                                    int m, double* C,
                                                    int ldc) {
  return TileProduct{A, lda, B, ldb, transB, r, c, m, nullptr, 0, nullptr,
                     0, 0, 1.0, false, nullptr, 0, C, ldc};
}

// `iters` Lyapunov doublings P += (A P) A'; A = A A (n x n, tile layout,
// leading dimension ld) by the warps of one draw, from A = A0, which is not
// written.  The doubling matrix alternates between the buffers X and Y (A0
// may be one of them).  With a fifth buffer W, A P goes to W and A A to the
// next of X and Y in one phase, and P += (A P) A' follows in a second: two
// draw barriers a doubling.  Without one (W null), A P goes to the next
// buffer, and A A overwrites it in a third phase.  With kTall the products
// run on 32-row items (tile_mm); the buffers then hold ceil32(n) rows.
// sync() is the draw's barrier; the caller synchronises before the call (P
// and A0 written), the helper after its last phase.
template <bool kTall = false, typename Sync>
__device__ __forceinline__ void tile_lyap_doubling(const double* A0,
                                                   double* P, double* X,
                                                   double* Y, double* W,
                                                   int n, int ld, int iters,
                                                   WarpCtx w, Sync sync) {
  const double* A = A0;
  for (int it = 0; it < iters; ++it) {
    double* next = A == X ? Y : X;
    double* ap = W ? W : next;
    tile_mm<double, kTall>(tile_product(A, ld, P, ld, false, n, n, n, ap, ld),
                           nullptr, 0, nullptr, 0, w);
    if (W)
      tile_mm<double, kTall>(
          tile_product(A, ld, A, ld, false, n, n, n, next, ld), nullptr, 0,
          nullptr, 0, w);
    sync();
    TileProduct acc = tile_product(ap, ld, A, ld, true, n, n, n, P, ld);
    acc.E = P;
    acc.lde = ld;
    tile_mm<double, kTall>(acc, nullptr, 0, nullptr, 0, w);
    sync();
    if (!W) {
      tile_mm<double, kTall>(
          tile_product(A, ld, A, ld, false, n, n, n, next, ld), nullptr, 0,
          nullptr, 0, w);
      sync();
    }
    A = next;
  }
}

// One warp: the dot products of the 8 rows i0..i0+7 of A (tile layout) with
// x (c entries, zero-padded to ceil8), plus those of A2 with x2 when c2 > 0;
// every lane l gets the sum of row i0 + l / 4.
__device__ __forceinline__ double warp_row_dot(const double* A, int lda,
                                               const double* x, int c,
                                               const double* A2, int lda2,
                                               const double* x2, int c2,
                                               int i0, int lane) {
  const int t = lane & 3;
  const int row = i0 + (lane >> 2);
  double s0 = 0.0, s1 = 0.0;
  const double* a = A + row * lda + t;
  x += t;
#pragma unroll 4
  for (int l = 0; l < c; l += 8) {
    s0 += a[l] * x[l];
    s1 += a[l + 4] * x[l + 4];
  }
  if (c2 > 0) {
    const double* a2 = A2 + row * lda2 + t;
    x2 += t;
#pragma unroll 2
    for (int l = 0; l < c2; l += 8) {
      s0 += a2[l] * x2[l];
      s1 += a2[l + 4] * x2[l + 4];
    }
  }
  double s = s0 + s1;
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// out = A(r x c) x [+ A2(r x c2) x2] by the warps of one draw, 8 rows to a
// work item; a warp takes its items four at a time, all their sums before
// any store, so that their loads overlap.  emit(i, sum) is called by every
// lane (four lanes share a row and hold the same sum) for every row
// i < ceil8(r); the sum of a pad row is zero.
template <typename Emit>
__device__ __forceinline__ void tile_mv(const double* A, int lda,
                                        const double* x, int r, int c,
                                        const double* A2, int lda2,
                                        const double* x2, int c2, WarpCtx w,
                                        Emit emit) {
  const int stride = w.n_warps << 3;
  for (int base = w.warp << 3; base < r; base += 4 * stride) {
    double s[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      s[q] = base + q * stride < r
                 ? warp_row_dot(A, lda, x, c, A2, lda2, x2, c2,
                                base + q * stride, w.lane)
                 : 0.0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (base + q * stride < r)
        emit(base + q * stride + (w.lane >> 2), s[q]);
  }
}

// Sum of one value per lane over the warp; every lane gets it.
__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the 8 row groups of a warp (lanes l with equal l % 4 hold the
// same value, as after warp_row_dot); every lane gets it.
__device__ __forceinline__ double warp_sum_rows(double v) {
  for (int off = 16; off > 2; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Partially pivoted Gauss-Jordan by ONE warp, on _gj_solve's schedule: at
// step k the pivot is the first maximal |aug[i, k]| over rows i >= k; rows k
// and p swap (identical writes when p == k); the pivot row is divided by the
// pivot and eliminated from every other row over all w columns.  On aug =
// [A | RHS] (n x w, leading dimension w, NOT the tile layout), with the
// pivot rule of pivot_wins; min|pivot| and log|det A|
// accumulated into the caller's registers (every lane holds the same
// values).  `col` (n) and `row` (w) are shared-memory scratch.  The caller
// runs __syncwarp() after writing aug; on return aug is visible to the warp.
static __device__ __noinline__ void warp_gj_solve_shared(
    double* aug, int n, int w, double* col, double* row, int lane,
    double& minpiv, double& logdet) {
  for (int k = 0; k < n; ++k) {
    double best = -1.0;
    int bi = 0x7fffffff;
    for (int i = k + lane; i < n; i += 32) {
      const double v = fabs(aug[i * w + k]);
      if (pivot_wins(v, i, best, bi)) { best = v; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (pivot_wins(ov, oi, best, bi)) { best = ov; bi = oi; }
    }
    const int p = bi;
    const double pv = aug[p * w + k];
    minpiv = nan_min(minpiv, fabs(pv));
    logdet += log(fabs(pv));
    // column k after the swap with the pivot row's entry zeroed, and the
    // normalised pivot row, both from aug as it is before this step
    for (int i = lane; i < n; i += 32)
      col[i] = (i == k) ? 0.0 : aug[(i == p ? k : i) * w + k];
    for (int j = lane; j < w; j += 32) row[j] = aug[p * w + j] / pv;
    __syncwarp();
    for (int j = lane; j < w; j += 32) aug[p * w + j] = aug[k * w + j];
    __syncwarp();
    for (int e = lane; e < n * w; e += 32) {
      const int i = e / w;
      const int j = e - i * w;
      aug[e] = (i == k) ? row[j] : aug[e] - col[i] * row[j];
    }
    __syncwarp();
  }
}

constexpr long long kInfBits = 0x7ff0000000000000LL;

// The same elimination for n <= 8 and w <= 32 with aug in the warp's
// registers: lane j holds column j, a[i] its entry of row i (zero for
// i >= n).  The pivot search runs in the lane that owns column k; one
// shuffle tells the warp the pivot row, n more hand every lane the entries
// of column k; the logarithms of the n pivots are taken by n lanes at once
// and summed at the end.
__device__ __forceinline__ void warp_gj_solve_regs(double (&a)[8], int n,
                                                   int lane, double& minpiv,
                                                   double& logdet) {
  double my_pivot = 1.0;   // lane k keeps the pivot of step k
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= n) break;
    // first maximal |a[i]| over rows i >= k, NaN largest: the bit patterns
    // of non-negative doubles order like their values, with every NaN
    // above infinity
    long long best = -1;
    int bi = k;
#pragma unroll
    for (int i = k; i < 8; ++i) {
      const long long bits = __double_as_longlong(fabs(a[i]));
      const long long key = bits > kInfBits ? kInfBits + 1 : bits;
      if (i < n && key > best) { best = key; bi = i; }
    }
    const int p = __shfl_sync(0xffffffffu, bi, k);
    // rows k and p swap
    const double ak = a[k];
    double ap = ak;
#pragma unroll
    for (int i = k + 1; i < 8; ++i) {
      const bool hit = i == p;
      ap = hit ? a[i] : ap;
      a[i] = hit ? ak : a[i];
    }
    a[k] = ap;
    const double pv = __shfl_sync(0xffffffffu, ap, k);
    minpiv = nan_min(minpiv, fabs(pv));
    if (lane == k) my_pivot = pv;
    const double rk = ap / pv;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i == k) continue;
      const double ci = __shfl_sync(0xffffffffu, a[i], k);
      a[i] = a[i] - ci * rk;
    }
    a[k] = rk;
  }
  logdet += warp_sum(lane < n ? log(fabs(my_pivot)) : 0.0);
}

// One warp: F^{-1} and, with kWithV, F^{-1} v for the k x k matrix F, by the
// Gauss-Jordan elimination of [F | v | I] (or [F | I]; v is then not read).
// F is
// in shared memory in the tile layout (leading dimension ldf) and F^{-1}
// replaces it there (logical entries only: the pads stay zero).  Returns
// v' F^{-1} v (0 without kWithV), the same value in every lane; min|pivot| and
// log|det F| are added into the caller's registers.  Small systems are
// eliminated in registers; larger ones in `aug` (k x (2k + 1)) with the
// scratch `col` (k) and `row` (2k + 1) in shared memory.
template <bool kWithV>
__device__ __forceinline__ double warp_solve_innovation(
    double* F, int ldf, const double* v, int k, double* aug, double* col,
    double* row, int lane, double& minpiv, double& logdet) {
  constexpr int nv = kWithV ? 1 : 0;   // columns of v
  const int w = 2 * k + nv;
  double q = 0.0;
  if (k <= 8) {
    // lane j: column j of F for j < k, then v, then the identity.  (One
    // unconditional assignment per entry: conditional ones over the
    // unrolled i make the compiler index a local-memory array by lane.)
    double a[8];
    const int fcol = lane < k ? lane : 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const double fv = F[i * ldf + fcol];
      const double vv = nv ? v[i] : 0.0;
      const double id = lane - k - nv == i ? 1.0 : 0.0;
      a[i] = i < k ? (lane < k ? fv : (lane < k + nv ? vv : id)) : 0.0;
    }
    __syncwarp();   // F is read; F^{-1} may replace it
    warp_gj_solve_regs(a, k, lane, minpiv, logdet);
    const int j = lane - k - nv;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < k && j >= 0 && j < k) F[i * ldf + j] = a[i];
      if (nv && i < k) q += v[i] * a[i];   // F^{-1} v is lane k's column
    }
    if (nv) q = __shfl_sync(0xffffffffu, q, k);
  } else {
    for (int e = lane; e < k * w; e += 32) {
      const int i = e / w, j = e - i * w;
      aug[e] = j < k ? F[i * ldf + j]
                     : (j < k + nv ? v[i] : (j - k - nv == i ? 1.0 : 0.0));
    }
    __syncwarp();
    warp_gj_solve_shared(aug, k, w, col, row, lane, minpiv, logdet);
    for (int e = lane; e < k * k; e += 32) {
      const int i = e / k, j = e - i * k;
      F[i * ldf + j] = aug[i * w + k + nv + j];
    }
    if (nv) {
      for (int i = lane; i < k; i += 32) q += v[i] * aug[i * w + k];
      q = warp_sum(q);
    }
  }
  __syncwarp();
  return q;
}

}  // namespace gcp
