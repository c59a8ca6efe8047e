// Per-draw small dense linear algebra in shared memory, for one thread block.
//
// Counterparts of the shared Pallas helpers in
// geconpy_tpu/ops/pallas_cycle_reduction.py: _mm (:52), _mmT (:73) and
// _gj_solve (:90).  The TPU kernels keep the batch in the 128 vector lanes;
// here one thread block owns one draw, its matrices live in shared memory
// (row-major, explicit leading dimension), and the block's threads stride
// over the entries.  Every helper is called by all threads of the block;
// the caller synchronises before (inputs written) and after (outputs read).
//
// Reductions (max |.|, min |pivot|, the pivot search) run in a fixed order
// inside one block with no atomics, so results are deterministic.  NaN
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

// out(i, j) for an (r x m) product A(r x c) B(c x m) with the sum taken
// over l = 0..c-1 in order; B is read transposed (B is m x c) when transB.
// f(i, j, sum) consumes each entry; it may write only memory that no
// thread reads during this call.
template <typename S, typename F>
__device__ __forceinline__ void for_each_mm(const S* A, int lda, const S* B,
                                            int ldb, bool transB, int r,
                                            int c, int m, F f) {
  for (int e = threadIdx.x; e < r * m; e += blockDim.x) {
    const int i = e / m;
    const int j = e - i * m;
    const S* a = A + i * lda;
    S acc = S(0);
    if (transB) {
      const S* b = B + j * ldb;
      for (int l = 0; l < c; ++l) acc += a[l] * b[l];
    } else {
      const S* b = B + j;
      for (int l = 0; l < c; ++l) acc += a[l] * b[l * ldb];
    }
    f(i, j, acc);
  }
}

// Block-wide max of per-thread values, NaN-propagating.  `red` holds at
// least blockDim.x / 32 entries.  Every thread gets the result.
template <typename S>
__device__ S block_max(S v, S* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  S out = red[0];
  const int n_warps = (blockDim.x + 31) >> 5;
  for (int w = 1; w < n_warps; ++w) out = nan_max(out, red[w]);
  __syncthreads();
  return out;
}

// Scratch for gj_solve, in shared memory.
template <typename S>
struct GJScratch {
  S* col;     // n: column k after the swap, pivot row zeroed
  S* row;     // w: pivot row divided by the pivot
  S* pivot;   // 1
  int* prow;  // 1
};

// Does (v, i) win over (best, bi) as the pivot?  Larger |entry| wins; a
// tie goes to the lower row, as jnp.argmax takes the FIRST maximum; NaN
// counts as the largest value (jnp.argmax and torch.argmax agree).
template <typename S>
__device__ __forceinline__ bool pivot_wins(S v, int i, S best, int bi) {
  const bool vn = isnan(v), bn = isnan(best);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > best || (v == best && i < bi);
}

// Partially pivoted Gauss-Jordan on aug = [A | RHS] (n x w, leading
// dimension w): on return aug[:, n:] = A^{-1} RHS.  The same schedule as
// _gj_solve: at step k the pivot is the first maximal |aug[i, k]| over
// rows i >= k; rows k and p swap (identical writes when p == k); the
// pivot row is divided by the pivot and eliminated from every other row
// over all w columns.  min|pivot| and sum log|pivot| = log|det A| are
// accumulated into *minpiv and *logdet by thread 0 (caller initialises).
template <typename S>
__device__ void gj_solve(S* aug, int n, int w, GJScratch<S> s, S* minpiv,
                         S* logdet) {
  const int tid = threadIdx.x;
  for (int k = 0; k < n; ++k) {
    if (tid < 32) {
      S best = S(-1);
      int bi = 0x7fffffff;
      for (int i = k + tid; i < n; i += 32) {
        const S v = fabs(aug[i * w + k]);
        if (pivot_wins(v, i, best, bi)) { best = v; bi = i; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const S ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (pivot_wins(ov, oi, best, bi)) { best = ov; bi = oi; }
      }
      if (tid == 0) {
        const S pv = aug[bi * w + k];
        *s.prow = bi;
        *s.pivot = pv;
        *minpiv = nan_min(*minpiv, S(fabs(pv)));
        *logdet += S(log(fabs(pv)));
      }
    }
    __syncthreads();
    const int p = *s.prow;
    const S pv = *s.pivot;
    // column k after the swap (row p picks up the old aug[k, k]), with the
    // pivot row's entry zeroed; row p is not read here except through k
    for (int i = tid; i < n; i += blockDim.x)
      s.col[i] = (i == k) ? S(0) : aug[(i == p ? k : i) * w + k];
    // swap rows k and p; keep the normalised pivot row aside
    for (int j = tid; j < w; j += blockDim.x) {
      const S rp = aug[p * w + j];
      const S rk = aug[k * w + j];
      s.row[j] = rp / pv;
      aug[p * w + j] = rk;
    }
    __syncthreads();
    for (int e = tid; e < n * w; e += blockDim.x) {
      const int i = e / w;
      const int j = e - i * w;
      aug[e] = (i == k) ? s.row[j] : aug[e] - s.col[i] * s.row[j];
    }
    __syncthreads();
  }
}

}  // namespace gcp
