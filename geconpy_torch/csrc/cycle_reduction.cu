// Batched cycle reduction: four warps per draw, several draws per block, the
// products on the FP64 tensor cores.
//
// One kernel body for two TPU kernels of geconpy_tpu/ops/
// pallas_cycle_reduction.py, switched at compile time by kSelect:
//   kSelect = true  replaces _cr_sel_kernel (:176, reached through
//                   pallas_cycle_reduction_policy; the forward sweep, K1);
//   kSelect = false replaces _cr_kernel (:145, reached through
//                   pallas_cycle_reduction; the value+grad path, K4).
// For each draw: n_iter cycle-reduction doublings, each a partially
// pivoted Gauss-Jordan solve of A1 against [A0 | A2] and four n x n
// products; the solvent T = -Ahat^{-1} A0; flags [min |pivot|,
// max|A0_final| + max|A2_final|].  With kSelect also the selection
// R = -(B + C T)^{-1} D and a third flag max|A + B T + C T^2|.
//
// Precision: the kernel reads and writes the caller's dtype but runs the
// recursion in float64.  With float32 arithmetic the SW-2007 sweep's
// likelihood moved by up to 1.2e-3 relative to the float64 path over a
// 4096-draw batch (4.7e-4 with this kernel in float64; H100 run).
//
// What bounds it on the H100.  On paper the operations: n_iter (4 n^3
// product + 3 n^3 elimination) multiply-adds per draw, ~1.8 MFMA at n = 26
// with 14 doublings, on 3 n^2 + n m inputs.  In fact the chain: a doubling
// is 26 dependent pivot steps and two rounds of products, and a draw's warps
// walk that chain alone.  An earlier design (one block of 256 threads per
// draw, one output entry per thread with two shared loads per multiply-add,
// three block barriers per pivot with seven warps waiting on the one that
// searched) took 8.58 ms for 4096 draws with float32 I/O and 1.07 ms for 512
// with float64 I/O, NVIDIA H100 80GB HBM3 at 700.00 W.  What this design
// does (its times are in PERF.md; chip_smoke.py and tools/cr_variants.py
// measure them):
//
//  * a draw is four warps under a named barrier of their own.  A block holds
//    GCP_CR_DRAWS draws that never wait for each other (a batch that does
//    not fill the last block is guarded); one draw a block, three blocks an
//    SM, measured faster than three draws a block: separate blocks drift
//    apart in phase, so one draw's products overlap another's pivots;
//  * the four products of a doubling are tile_mm (small_linalg.cuh):
//    mma.sync m16n8k4 in float64 on matrices kept zero-padded to whole tiles,
//    so that no load, mma or store tests a bound.  A2 Q0 is formed once and
//    feeds both A1's and Ahat's update; A1 updates in place;
//  * for n <= 32 the solves run in registers, a lane per row
//    (cr_solve_regs): the pivots depend on the left-hand matrix alone, so one
//    warp (cr_record) runs all of them ahead, publishing each step's pivot
//    and column through shared memory and a step counter, while the other
//    three replay each step on their right-hand columns as soon as it is
//    published: no barrier per pivot, and only the pivot warp's chain is on
//    the critical path.  Eight n x n matrices a draw, 74,400 B at n = 26:
//    three draws per SM, by shared memory and registers alike;
//  * above n = 32 (to 48, where a draw's shared memory runs out) the solves
//    run in shared memory (cr_eliminate: one thread per column, one draw
//    barrier per pivot, the pivot search overlapped with the update), on an
//    augmented system of three zero-padded blocks [A1 | A0 | A2] whose spent
//    left block receives A2 Q0.
//
// The large-state kernel.  From n = 49 (ceil16(n) = 64 rows: 242,336 B a draw
// at n = 52, m = 14) one draw no longer fits the 232,448 B a block may
// have, and the reference's kernels, which size their VMEM block by the
// batch tile, take any n.  cr_large_kernel runs the recursion of the n > 32
// instance (cr_draw: the same doublings, cr_eliminate's pivots and tile_mm's
// products, on the same layout) with each draw's buffers in a float64
// workspace in device memory instead, read through L1 and L2.  The grid is
// persistent (as many blocks as are resident, each draw slot striding over
// the batch), so the workspace is the card's resident draws times one
// layout, not the batch's.
//
// Four tiers, chosen by size alone (ops/batched_cycle_reduction.py::
// cr_tier): the small-state kernel wherever its plan fits one draw a block
// (gcp_cr_fits, n <= 48); the on-chip kernel (cr_onchip_kernel, one draw a
// CTA, n = 49..56); the cluster kernel (cr_cluster_kernel, a draw a
// thread-block cluster, n = 57..128); the device-memory cr_large_kernel
// beyond.  The two middle tiers are in cycle_reduction_tiers.cu (built
// apart, so that nvcc compiles them beside this file).
#include "small_linalg.cuh"

#ifndef GCP_CR_DRAWS
#define GCP_CR_DRAWS 1   // draws per block (fewer if shared memory is short)
#endif
#ifndef GCP_CR_MIN_BLOCKS
#define GCP_CR_MIN_BLOCKS 3   // resident blocks per SM the registers allow
#endif
#ifndef GCP_CR_PROBE
#define GCP_CR_PROBE 0   // 1: clocks per phase of block 0's first draw
#endif

namespace gcp {

#if GCP_CR_PROBE
// clocks of block 0's first draw, summed by phase: eliminations of the
// doublings, the first and second round of products, the update of A1 and
// Ahat, the solve for T (with the tail flag), the inputs, the rest; and of
// all solves, the time of cr_record
__device__ unsigned long long cr_probe[8];
#define CR_MARK(slot)                                              \
  do {                                                             \
    if (probe) {                                                   \
      const unsigned long long now = clock64();                    \
      cr_probe[slot] += now - probe_t;                             \
      probe_t = now;                                               \
    }                                                              \
  } while (0)
#else
#define CR_MARK(slot) do {} while (0)
#endif

constexpr int kCrWarps = 4;   // warps per draw
constexpr int kCrThreads = 32 * kCrWarps;
constexpr int kCrBand = 22;   // right-hand columns of a warp (cr_solve_regs)
constexpr int kCrScal = 84;   // scalars a draw (see the kernel)

// Offsets (in doubles) of one draw's shared memory.  Matrices are in the
// tile layout (ceil16(n) rows, leading dimension tile_ld(n)).  For n <= 32
// (cr_solve_regs, the system in registers): eight such matrices, of which Q0
// and Q2 receive A1^{-1} [A0 | A2] and H first the pivot history of a solve,
// then A2 Q0.  Above (cr_eliminate): five matrices and the augmented system
// aug (ceil16(n) rows; column blocks of width ceil8(n) at 0, ceil8(n) and
// 2 ceil8(n), or the m columns of D from ceil8(n)), its spent left block
// receiving A2 Q0.  Then kCrScal scalars.  Mirrored for the tier choice by
// ops/batched_cycle_reduction.py::cr_layout_bytes (_CR_SCAL).
struct CrLayout {
  bool regs;
  int nr, n8, ld, lda;
  int A0, A1, A2, Ahat, X, Q0, Q2, H, aug, scal;
  int total;
  __host__ __device__ CrLayout(int n, int m) {
    regs = n <= 32;
    nr = ceil16(n);
    n8 = ceil8(n);
    ld = tile_ld(n);
    const int w = 3 * n8 > n8 + ceil8(m) ? 3 * n8 : n8 + ceil8(m);
    lda = w + 4;   // 4 mod 8, as tile_ld
    const int tile = nr * ld;
    int o = 0;
    A0 = o; o += tile;
    A1 = o; o += tile;
    A2 = o; o += tile;
    Ahat = o; o += tile;
    X = o; o += tile;
    if (regs) {
      Q0 = o; o += tile;
      Q2 = o; o += tile;
      H = o; o += tile;
      aug = -1;
    } else {
      aug = o; o += nr * lda;
      Q0 = Q2 = H = -1;
    }
    scal = o; o += kCrScal;
    total = o;
  }
};

// Draws per block and the dynamic shared memory of a block for a launch at
// (n, m) on the current device.
struct CrPlan {
  int draws;
  size_t bytes;
};

inline CrPlan cr_plan(int n, int m) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t per_draw = (size_t)CrLayout(n, m).total * sizeof(double);
  CrPlan p;
  p.draws = GCP_CR_DRAWS;
  while (p.draws > 1 && p.draws * per_draw > (size_t)limit) --p.draws;
  p.bytes = p.draws * per_draw;
  return p;
}

// Barrier over the kCrThreads threads of one draw (ids 1..draws).
__device__ __forceinline__ void cr_barrier(int draw) {
  asm volatile("bar.sync %0, %1;" ::"r"(draw + 1), "r"(kCrThreads) : "memory");
}

__device__ __forceinline__ double max4(const double* r) {
  return nan_max(nan_max(r[0], r[1]), nan_max(r[2], r[3]));
}

// |v| as a key that orders like the value (the bits of a non-negative
// double do), every NaN just above infinity: the pivot rule of pivot_wins
__device__ __forceinline__ unsigned long long pivot_key(double v) {
  const long long bits = __double_as_longlong(fabs(v));
  return bits > kInfBits ? kInfBits + 1 : bits;
}

// The largest key of the warp (compared on its high half, then on its low
// half): does this lane hold it?
__device__ __forceinline__ bool holds_max(unsigned long long key) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned hmax = __reduce_max_sync(0xffffffffu, hi);
  const unsigned lmax = __reduce_max_sync(0xffffffffu, hi == hmax ? lo : 0u);
  return hi == hmax && lo == lmax;
}

// By one warp: the pivot of step k of cr_eliminate, the first maximal
// |aug[i, k]| over rows i >= k (pivot_wins), into slot k & 1 of prow, pval
// and pinv (1 / pivot); min|pivot| into *minpiv.
__device__ __forceinline__ void cr_pivot(const double* aug, int lda, int n,
                                         int k, int lane, int* prow,
                                         double* pval, double* pinv,
                                         double* minpiv) {
  int bi;
  if (n - k <= 32) {
    // one row a lane, in row order
    const int i = k + lane;
    const bool top = holds_max(i < n ? pivot_key(aug[i * lda + k]) : 0);
    bi = k + __ffs(__ballot_sync(0xffffffffu, top)) - 1;
  } else {
    double best = -1.0;
    bi = 0x7fffffff;
    for (int i = k + lane; i < n; i += 32) {
      const double v = fabs(aug[i * lda + k]);
      if (pivot_wins(v, i, best, bi)) { best = v; bi = i; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const double ov = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (pivot_wins(ov, oi, best, bi)) { best = ov; bi = oi; }
    }
  }
  if (lane == 0) {
    const double pv = aug[bi * lda + k];
    prow[k & 1] = bi;
    pval[k & 1] = pv;
    pinv[k & 1] = 1.0 / pv;
    *minpiv = nan_min(*minpiv, fabs(pv));
  }
}

// Gauss-Jordan on one draw's augmented system by its kCrThreads threads,
// on _gj_solve's schedule (warp_gj_solve_shared, small_linalg.cuh): at
// step k rows k and p swap, the pivot row is scaled by 1 / pivot and
// eliminated from every other row.  The left block is n x n at column 0;
// the n_right right-hand columns come in blocks of bw, block q at column
// n8 (1 + q).  On return
// the right-hand columns hold the solution; the left block's columns are
// left as they were at the step that pivoted on them.  Thread c of the draw
// owns logical column c (c < n: left block), updates it alone and so reads
// row k and row p of it before writing either; column k, which every thread
// reads at step k, is not written in that step.  The warp that owns column
// k + 1 searches its pivot right after its own update of step k and
// publishes it in the other of two slots, so a step costs one draw barrier.
// The caller's barrier precedes (system written); on return the system is
// visible to the draw.
static __device__ __noinline__ void cr_eliminate(
    double* aug, int lda, int n, int n8, int n_right, int bw, int dt,
    int warp, int lane, int draw, int* prow, double* pval, double* pinv,
    double* minpiv) {
  if (warp == 0) cr_pivot(aug, lda, n, 0, lane, prow, pval, pinv, minpiv);
  cr_barrier(draw);
  const int cols = n + n_right;
  for (int k = 0; k < n; ++k) {
    const int p = prow[k & 1];
    const double pi = pinv[k & 1];
    const double ckk = aug[k * lda + k];
    for (int c = dt; c < cols; c += kCrThreads) {
      int j = c;
      if (c < n) {
        if (c <= k) continue;
      } else {
        const int r = c - n, q = r / bw;
        j = n8 * (1 + q) + (r - q * bw);
      }
      const double rj = aug[p * lda + j] * pi;
      const double pj = aug[k * lda + j] - ckk * rj;   // row p after the swap
      for (int i0 = 0; i0 < n; i0 += 8) {
        // rows i0..i0+7: all loads, then all stores
        double a[8], ck[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const bool in = i0 + q < n;   // the same in every lane
          a[q] = in ? aug[(i0 + q) * lda + j] : 0.0;
          ck[q] = in ? aug[(i0 + q) * lda + k] : 0.0;
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i = i0 + q;
          const double v = i == k ? rj : (i == p ? pj : a[q] - ck[q] * rj);
          if (i < n) aug[i * lda + j] = v;
        }
      }
    }
    const int next = k + 1;
    if (next < n && warp == (next % kCrThreads) >> 5) {
      __syncwarp();   // column k + 1 is the warp's own: its update is done
      cr_pivot(aug, lda, n, next, lane, prow, pval, pinv, minpiv);
    }
    cr_barrier(draw);
  }
}

// One warp of a draw: the pivots of cr_solve_regs.  Lane q holds row q of the
// n x n matrix Lm (tile layout, leading dimension ldl); rows are not moved:
// linv, the logical row that lane q stands for, follows the swaps of
// _gj_solve's schedule, which gives that schedule's arithmetic.  Step k: the
// first maximal |column k| over logical rows >= k (pivot_wins, in logical
// order), the pivot row scaled by 1 / pivot (its entries reach the other
// lanes by shuffles), the rank-1 update of the columns > k, and a record of
// the step in hist (column k, n8 entries a step), Ps (the pivot's row) and
// pinvs (1 / pivot), after which *progress = base + k + 1 says so (for the
// last step: once linvs holds the final linv).  The columns k.. are kept at
// a[0..], so that the loop over k is not unrolled (its body runs n times
// from the instruction cache).  Column k + 1 is updated first and the
// search of the next pivot overlaps the update of the first eight columns
// after it; the others follow in groups of eight, each fenced by
// __syncwarp() so that few shuffles are in flight (registers), and a group
// wholly past column n is skipped.  min|pivot| is folded into *minpiv.
__device__ __forceinline__ void cr_record(const double* Lm, int ldl,
                                              int n, int lane, double* hist,
                                              int* Ps, double* pinvs,
                                              int* linvs, double* minpiv,
                                              int* progress, int base) {
  const int q = lane;
  const int n8 = ceil8(n);
  // steps 0..steps-1 are recorded
  auto publish = [&](int steps) {
    __syncwarp();
    if (q == 0) {
      __threadfence_block();
      *reinterpret_cast<volatile int*>(progress) = base + steps;
    }
  };
  double a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j)
    a[j] = (q < n && j < n) ? Lm[q * ldl + j] : 0.0;
  int linv = q;
  double minp = INFINITY;
  // the pivot of column k (lane q holds its entry col): its logical row p,
  // its lane P and its value pv
  int p, P;
  double pv;
  auto pivot = [&](double col, int k) {
    const bool live = q < n && linv >= k;
    const bool top = holds_max(live ? pivot_key(col) : 0) && live;
    p = __reduce_min_sync(0xffffffffu, top ? linv : 0x7fffffff);
    P = __ffs(__ballot_sync(0xffffffffu, linv == p)) - 1;
    pv = __shfl_sync(0xffffffffu, col, P);
  };
  double col = a[0];
  pivot(col, 0);
  for (int k = 0; k < n; ++k) {
    const int Pk = P;
    const double pinv = 1.0 / pv;
    minp = nan_min(minp, fabs(pv));
    if (q < n) hist[k * n8 + q] = col;
    if (q == 0) {
      Ps[k] = Pk;
      pinvs[k] = pinv;
    }
    if (k + 1 < n) publish(k + 1);
    linv = linv == k ? p : (linv == p ? k : linv);
    const int left = n - k;   // columns k..n-1 at a[0..left-1]
    // a[j - 1] <- column k + j after step k
    auto update = [&](int j) {
      const double r = __shfl_sync(0xffffffffu, a[j], Pk) * pinv;
      a[j - 1] = q == Pk ? r : a[j] - col * r;
    };
    update(1);
    const double next = a[0];   // column k + 1
    pivot(next, k + 1);         // after the last step: not used
#pragma unroll
    for (int j = 2; j < 9; ++j) update(j);
#pragma unroll
    for (int g = 9; g < 32; g += 8) {
      if (g < left) {
        __syncwarp();
#pragma unroll
        for (int j = g; j < g + 8 && j < 32; ++j) update(j);
      }
    }
    a[31] = 0.0;
    col = next;
  }
  linvs[q] = linv;
  if (q == 0) *minpiv = nan_min(*minpiv, minp);
  publish(n);
}

// The solve of cr_eliminate for n <= 32 with the system in registers, a
// lane per row: X = Lm^{-1} R for the n x n matrix Lm (tile layout, leading
// dimension ldl) and n_right right-hand columns, column c of R at row q
// being load(q, c); store(i, c, x) receives the solution.  The warp
// `producer` runs all n steps on Lm alone (the pivots depend on nothing
// else: cr_record), and the other three warps replay each recorded step on
// kCrBand right-hand columns each as soon as its record is published, with
// no barrier between steps.  `recorded` counts the steps of all solves so
// far (see cr_record's progress).  The caller's barrier precedes (Lm and R
// written); on return the solution is stored and visible to the draw.
template <typename Load, typename Store>
__device__ __forceinline__ void cr_solve_regs(
    const double* Lm, int ldl, int n, int n_right, int warp, int producer,
    int lane, int draw, double* hist, int* Ps, double* pinvs, int* linvs,
    double* minpiv, int* progress, int& recorded, Load load, Store store) {
  const int base = recorded;
  const int q = lane;
  const int n8 = ceil8(n);
#if GCP_CR_PROBE
  const unsigned long long t_start = clock64();
#endif
  if (warp == producer) {
    cr_record(Lm, ldl, n, lane, hist, Ps, pinvs, linvs, minpiv, progress,
              base);
#if GCP_CR_PROBE
    if (q == 0 && blockIdx.x == 0 && draw == 0)
      cr_probe[7] += clock64() - t_start;
#endif
  }
  // the other three warps replay each step as soon as it is recorded
  const int ci = (warp - producer + kCrWarps - 1) % kCrWarps;
  for (int c0 = ci * kCrBand; ci < kCrWarps - 1 && c0 < n_right;
       c0 += (kCrWarps - 1) * kCrBand) {
    double x[kCrBand];   // row q of right-hand columns c0..c0+kCrBand-1
#pragma unroll
    for (int j = 0; j < kCrBand; ++j)
      x[j] = (q < n && c0 + j < n_right) ? load(q, c0 + j) : 0.0;
    int avail = 0;   // steps known to be recorded
    for (int k = 0; k < n; ++k) {
      if (k >= avail) {
        int v;
        while ((v = *reinterpret_cast<volatile int*>(progress) - base) <= k)
          __nanosleep(64);
        __threadfence_block();
        avail = __reduce_min_sync(0xffffffffu, v);
      }
      const int P = Ps[k];
      const double pinv = pinvs[k];
      const double ck = q < n ? hist[k * n8 + q] : 0.0;
      // in two halves, fenced so that few shuffles are in flight
#pragma unroll
      for (int j = 0; j < kCrBand; ++j) {
        if (j == kCrBand / 2) __syncwarp();
        const double r = __shfl_sync(0xffffffffu, x[j], P) * pinv;
        x[j] = q == P ? r : x[j] - ck * r;
      }
    }
    const int i = linvs[q];
#pragma unroll
    for (int j = 0; j < kCrBand; ++j)
      if (q < n && c0 + j < n_right) store(i, c0 + j, x[j]);
  }
  recorded += n;
  cr_barrier(draw);
}

// kRegs: the instance for n <= 32 (cr_solve_regs; CrLayout's regs), compiled
// apart so that neither carries the other's registers
// The recursion of draw b by the draw's kCrThreads threads (warp w.warp of
// draw `draw` of its block) on the draw's buffers at sm (CrLayout L): shared
// memory in cr_kernel, a slot of the workspace in device memory in
// cr_large_kernel.  Returns once b's outputs are written; the caller
// synchronises the draw before it reuses the buffers.
template <typename S, bool kSelect, bool kRegs>
__device__ __forceinline__ void cr_draw(
    const S* __restrict__ gA, const S* __restrict__ gB,
    const S* __restrict__ gC, const S* __restrict__ gD, S* __restrict__ gT,
    S* __restrict__ gR, S* __restrict__ gflags, double* sm,
    const CrLayout& L, size_t b, int n, int m, int n_iter, WarpCtx w,
    int draw) {
  const int dt = w.warp * 32 + w.lane;   // thread of the draw
#if GCP_CR_PROBE
  const bool probe = b == 0 && dt == 0;
  unsigned long long probe_t = clock64();
#endif

  double* A0 = sm + L.A0;
  double* A1 = sm + L.A1;
  double* A2 = sm + L.A2;
  double* Ahat = sm + L.Ahat;
  double* X = sm + L.X;
  double* aug = sm + L.aug;
  // scalars: [0, 1] pivot, [2] min|pivot|, [3] pivot row (2 ints), [4..15]
  // per-warp maxima, [16, 17] 1 / pivot (cr_eliminate's two slots); [18..81]
  // cr_solve_regs's record: pivot rows, 1 / pivot, logical rows (32 each);
  // [82] the warp that runs cr_record
  double* sc = sm + L.scal;
  double* pval = sc;
  double* minpiv = sc + 2;
  int* prow = reinterpret_cast<int*>(sc + 3);
  double* red_a0 = sc + 4;
  double* red_a2 = sc + 8;
  double* red_res = sc + 12;
  double* pinv = sc + 16;
  int* Ps = reinterpret_cast<int*>(sc + 18);
  double* pinvs = sc + 34;
  int* linvs = reinterpret_cast<int*>(sc + 66);
  int* role = reinterpret_cast<int*>(sc + 82);
  int* progress = role + 1;   // steps cr_record has recorded, all solves
  int recorded = 0;
  const int nn = n * n, ld = L.ld, lda = L.lda, n8 = L.n8;
  constexpr bool regs = kRegs;
  // where the elimination leaves Q0 and Q2, and where A2 Q0 goes
  double* Q0 = regs ? sm + L.Q0 : aug + n8;
  double* Q2 = regs ? sm + L.Q2 : aug + 2 * n8;
  double* S20 = regs ? sm + L.H : aug;
  const int ldq = regs ? ld : lda;
  double* hist = sm + L.H;
  const S* A = gA + b * nn;
  const S* B = gB + b * nn;
  const S* C = gC + b * nn;
  const S* no_g = nullptr;
  S* no_o = nullptr;
  // C (tile layout, ldc) = sign A B for an n x n x n product
  auto product = [n](const double* Am, int ldam, const double* Bm, int ldbm,
                     double sign, double* Cm, int ldcm) {
    return TileProduct{Am, ldam, Bm, ldbm, false, n, n, n, nullptr, 0,
                       nullptr, 0, 0, sign, false, nullptr, 0, Cm, ldcm};
  };

  // ---- inputs, zero-padded: A0 = A, A1 = Ahat = B, A2 = C; Q0 and Q2
  // zero (their pads stay so), or the system [A1 | A0 | A2] (or [Ahat | -A]
  // without doublings) with zero pads
  for (int e = dt; e < L.nr * ld; e += kCrThreads) {
    const int i = e / ld, j = e - i * ld;
    const bool in = i < n && j < n;
    const double bv = in ? double(B[i * n + j]) : 0.0;
    A0[e] = in ? double(A[i * n + j]) : 0.0;
    A1[e] = bv;
    Ahat[e] = bv;
    A2[e] = in ? double(C[i * n + j]) : 0.0;
    if (regs) {
      Q0[e] = 0.0;
      Q2[e] = 0.0;
    }
  }
  if (!regs) {
    for (int e = dt; e < L.nr * lda; e += kCrThreads) {
      const int i = e / lda, j = e - i * lda;
      const int q = j / n8, jj = j - q * n8;
      double v = 0.0;
      if (i < n && jj < n && q < 3) {
        const int s = i * n + jj;
        if (q == 0) v = double(B[s]);
        else if (q == 1) v = n_iter > 0 ? double(A[s]) : -double(A[s]);
        else if (n_iter > 0) v = double(C[s]);
      }
      aug[e] = v;
    }
  }
  if (dt == 0) {
    *minpiv = INFINITY;
    // cr_record's warp: the draws resident on an SM run it on different
    // sub-partitions.  Hardware warp slots (%warpid) go to the four
    // sub-partitions in turn and a draw's warps take four slots in a row,
    // so the slot group picks the warp.  (Only the speed depends on it.)
    unsigned slot;
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(slot));
    *role = (int)((slot >> 2) & (kCrWarps - 1));
    *progress = 0;
  }
  cr_barrier(draw);
  const int producer = __shfl_sync(0xffffffffu, *role, 0);
  CR_MARK(5);
  // cr_eliminate on aug: n_right columns in blocks of bw
  auto eliminate = [&](int n_right, int bw) {
    cr_eliminate(aug, lda, n, n8, n_right, bw, dt, w.warp, w.lane, draw, prow,
                 pval, pinv, minpiv);
  };

  for (int it = 0; it < n_iter; ++it) {
    // Q0 = A1^{-1} A0, Q2 = A1^{-1} A2
    if (regs)
      cr_solve_regs(
          A1, ld, n, 2 * n, w.warp, producer, w.lane, draw, hist, Ps, pinvs,
          linvs, minpiv, progress, recorded,
          [&](int q, int c) {
            return c < n ? A0[q * ld + c] : A2[q * ld + c - n];
          },
          [&](int i, int c, double v) {
            if (c < n) Q0[i * ld + c] = v;
            else Q2[i * ld + c - n] = v;
          });
    else
      eliminate(2 * n, n);
    CR_MARK(0);
    // A2 Q0;  A1 <- A1 - A0 Q2;  X <- -A2 Q2
    tile_mm(product(A2, ld, Q0, ldq, 1.0, S20, ldq), no_g, 0, no_o, 0, w);
    TileProduct a1 = product(A0, ld, Q2, ldq, -1.0, A1, ld);
    a1.E = A1;
    a1.lde = ld;
    tile_mm(a1, no_g, 0, no_o, 0, w);
    tile_mm(product(A2, ld, Q2, ldq, -1.0, X, ld), no_g, 0, no_o, 0, w);
    cr_barrier(draw);
    CR_MARK(1);
    // A2 is read: its buffer takes -A0 Q0
    tile_mm(product(A0, ld, Q0, ldq, -1.0, A2, ld), no_g, 0, no_o, 0, w);
    cr_barrier(draw);
    CR_MARK(2);
    double* spent = A0;
    A0 = A2;      // -A0 Q0
    A2 = X;       // -A2 Q2
    X = spent;
    // A1 <- A1 - A2 Q0;  Ahat <- Ahat - A2 Q0;  (aug) the next system
    const bool last = it + 1 == n_iter;
    for (int e = dt; e < nn; e += kCrThreads) {
      const int i = e / n, j = e - i * n;
      const int o = i * ld + j, oa = i * ldq + j;
      const double s = S20[oa];
      const double a1v = A1[o] - s;
      const double ah = Ahat[o] - s;
      A1[o] = a1v;
      Ahat[o] = ah;
      if (regs) continue;
      if (!last) {
        aug[oa] = a1v;
        aug[oa + n8] = A0[o];
        aug[oa + 2 * n8] = A2[o];
      } else {
        aug[oa] = ah;
        aug[oa + n8] = -double(A[e]);
      }
    }
    cr_barrier(draw);
    CR_MARK(3);
  }

  // tail = max|A0_final| + max|A2_final|: per-warp maxima, read after the
  // next barrier
  {
    double m0 = 0.0, m2 = 0.0;
    for (int e = dt; e < nn; e += kCrThreads) {
      const int o = (e / n) * ld + e % n;
      m0 = nan_max(m0, fabs(A0[o]));
      m2 = nan_max(m2, fabs(A2[o]));
    }
    warp_max_to(m0, red_a0 + w.warp, w.lane);
    warp_max_to(m2, red_a2 + w.warp, w.lane);
  }

  // ---- T = Ahat^{-1} (-A), to device memory and (regs, kSelect) to Q0
  S* T_out = gT + b * nn;
  if (regs)
    cr_solve_regs(
        Ahat, ld, n, n, w.warp, producer, w.lane, draw, hist, Ps, pinvs,
        linvs, minpiv, progress, recorded,
        [&](int q, int c) { return -double(A[q * n + c]); },
        [&](int i, int c, double v) {
          if (kSelect) Q0[i * ld + c] = v;
          T_out[i * n + c] = S(v);
        });
  else
    eliminate(n, n);
  CR_MARK(4);
  const double tail = max4(red_a0) + max4(red_a2);
  // T in the tile layout (regs: Q0; else A1's buffer) and C (A0's buffer)
  // for the selection
  double* Tm = regs ? Q0 : A1;
  if (!regs || kSelect) {
    for (int e = dt; e < L.nr * ld; e += kCrThreads) {
      const int i = e / ld, j = e - i * ld;
      const bool in = i < n && j < n;
      if (!regs) {
        const double t = in ? aug[i * lda + n8 + j] : 0.0;
        if (in) T_out[i * n + j] = S(t);
        A1[e] = t;
      }
      if (kSelect) A0[e] = in ? double(C[i * n + j]) : 0.0;
    }
  }
  if constexpr (!kSelect) {
    if (dt == 0) {
      gflags[b * 2 + 0] = S(*minpiv);
      gflags[b * 2 + 1] = S(tail);
    }
    CR_MARK(6);
    return;
  }
  const S* D = gD + b * (size_t)n * m;
  S* R_out = gR + b * (size_t)n * m;
  cr_barrier(draw);
  // M = C T + B  (into A2's buffer)
  tile_mm(product(A0, ld, Tm, ld, 1.0, A2, ld), B, n, no_o, 0, w);
  cr_barrier(draw);
  // X = A + M T for the residual;  (aug) the system [M | -D]
  tile_mm(product(A2, ld, Tm, ld, 1.0, X, ld), A, n, no_o, 0, w);
  if (!regs) {
    for (int e = dt; e < nn; e += kCrThreads) {
      const int i = e / n, j = e - i * n;
      aug[i * lda + j] = A2[i * ld + j];
    }
    for (int e = dt; e < n * m; e += kCrThreads) {
      const int i = e / m, j = e - i * m;
      aug[i * lda + n8 + j] = -double(D[e]);
    }
  }
  cr_barrier(draw);
  {
    double rmax = 0.0;
    for (int e = dt; e < nn; e += kCrThreads)
      rmax = nan_max(rmax, fabs(X[(e / n) * ld + e % n]));
    warp_max_to(rmax, red_res + w.warp, w.lane);
  }
  // R = M^{-1} (-D)
  if (regs) {
    cr_solve_regs(
        A2, ld, n, m, w.warp, producer, w.lane, draw, hist, Ps, pinvs,
        linvs, minpiv, progress, recorded,
        [&](int q, int c) { return -double(D[q * m + c]); },
        [&](int i, int c, double v) { R_out[i * m + c] = S(v); });
  } else {
    eliminate(m, m);
    for (int e = dt; e < n * m; e += kCrThreads) {
      const int i = e / m, j = e - i * m;
      R_out[e] = S(aug[i * lda + n8 + j]);
    }
  }
  if (dt == 0) {
    gflags[b * 3 + 0] = S(*minpiv);
    gflags[b * 3 + 1] = S(tail);
    gflags[b * 3 + 2] = S(max4(red_res));
  }
  CR_MARK(6);
}

template <typename S, bool kSelect, bool kRegs>
__global__ void __launch_bounds__(kCrThreads* GCP_CR_DRAWS, GCP_CR_MIN_BLOCKS)
    cr_kernel(const S* __restrict__ gA, const S* __restrict__ gB,
              const S* __restrict__ gC, const S* __restrict__ gD,
              S* __restrict__ gT, S* __restrict__ gR, S* __restrict__ gflags,
              int batch, int n, int m, int n_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CrLayout L(n, m);
  const int draws = blockDim.x / kCrThreads;
  // the warp's number through a shuffle, so that the compiler knows it (and
  // the draw and every branch on them) to be uniform: the mma then need no
  // reconvergence code around them
  const int block_warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int draw = block_warp / kCrWarps;
  const WarpCtx w{block_warp - draw * kCrWarps, kCrWarps,
                  (int)(threadIdx.x & 31)};
  const size_t b = (size_t)blockIdx.x * draws + draw;
  if (b >= (size_t)batch) return;   // no barrier spans two draws
  double* sm = reinterpret_cast<double*>(smem_raw) + (size_t)draw * L.total;
  cr_draw<S, kSelect, kRegs>(gA, gB, gC, gD, gT, gR, gflags, sm, L, b, n, m,
                             n_iter, w, draw);
}

// The large-state kernel: cr_draw's recursion above n = 32 (cr_eliminate)
// with each draw's buffers in a float64 workspace in device memory (gwork,
// L.total doubles per draw slot) instead of shared memory.  The grid is
// persistent: it holds as many blocks as are resident at once, and each
// draw slot strides over the batch, so the workspace scales with the card,
// not with the batch.
template <typename S, bool kSelect>
__global__ void __launch_bounds__(kCrThreads* GCP_CR_DRAWS, GCP_CR_MIN_BLOCKS)
    cr_large_kernel(const S* __restrict__ gA, const S* __restrict__ gB,
                    const S* __restrict__ gC, const S* __restrict__ gD,
                    S* __restrict__ gT, S* __restrict__ gR,
                    S* __restrict__ gflags, double* gwork, int batch, int n,
                    int m, int n_iter) {
  const CrLayout L(n, m);
  const int draws = blockDim.x / kCrThreads;
  const int block_warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int draw = block_warp / kCrWarps;
  const WarpCtx w{block_warp - draw * kCrWarps, kCrWarps,
                  (int)(threadIdx.x & 31)};
  const size_t slot = (size_t)blockIdx.x * draws + draw;
  double* sm = gwork + slot * L.total;
  // a draw slot past the batch leaves at once: no barrier spans two draws
  for (size_t b = slot; b < (size_t)batch;
       b += (size_t)gridDim.x * draws) {
    cr_draw<S, kSelect, false>(gA, gB, gC, gD, gT, gR, gflags, sm, L, b, n,
                               m, n_iter, w, draw);
    cr_barrier(draw);   // every warp is done with the slot's buffers
  }
}

template <typename S, bool kSelect, bool kRegs>
int launch_cr_as(const void* A, const void* B, const void* C, const void* D,
                 void* T, void* R, void* flags, int batch, int n, int m,
                 int n_iter, const CrPlan& plan, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cr_kernel<S, kSelect, kRegs>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + plan.draws - 1) / plan.draws;
  cr_kernel<S, kSelect, kRegs>
      <<<blocks, kCrThreads * plan.draws, plan.bytes, stream>>>(
          static_cast<const S*>(A), static_cast<const S*>(B),
          static_cast<const S*>(C), static_cast<const S*>(D),
          static_cast<S*>(T), static_cast<S*>(R), static_cast<S*>(flags),
          batch, n, m, n_iter);
  return (int)cudaGetLastError();
}

template <typename S, bool kSelect>
int launch_cr(const void* A, const void* B, const void* C, const void* D,
              void* T, void* R, void* flags, int batch, int n, int m,
              int n_iter, cudaStream_t stream) {
  const CrPlan plan = cr_plan(n, m);
  if (CrLayout(n, m).regs)
    return launch_cr_as<S, kSelect, true>(A, B, C, D, T, R, flags, batch, n,
                                          m, n_iter, plan, stream);
  return launch_cr_as<S, kSelect, false>(A, B, C, D, T, R, flags, batch, n,
                                         m, n_iter, plan, stream);
}

// The large-state launch: GCP_CR_DRAWS draws a block, no shared memory, and
// as many blocks as the card holds at once (at most one per GCP_CR_DRAWS
// draws of the batch).
struct CrLargePlan {
  int draws, blocks;
  size_t work_bytes;
};

template <typename S, bool kSelect>
CrLargePlan cr_large_plan(int n, int m, int batch) {
  CrLargePlan p;
  p.draws = GCP_CR_DRAWS;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cr_large_kernel<S, kSelect>, kCrThreads * p.draws, 0);
  const int need = (batch + p.draws - 1) / p.draws;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  p.blocks = need < resident ? need : resident;
  p.work_bytes = (size_t)p.blocks * p.draws * CrLayout(n, m).total *
                 sizeof(double);
  return p;
}

template <typename S, bool kSelect>
int launch_cr_large(const void* A, const void* B, const void* C,
                    const void* D, void* T, void* R, void* flags, void* work,
                    size_t work_bytes, int batch, int n, int m, int n_iter,
                    cudaStream_t stream) {
  // the layout of cr_eliminate's instance; n <= 32 always fits shared memory
  if (CrLayout(n, m).regs) return (int)cudaErrorInvalidValue;
  const CrLargePlan plan = cr_large_plan<S, kSelect>(n, m, batch);
  if (plan.blocks < 1) return 0;
  if (work == nullptr || work_bytes < plan.work_bytes)
    return (int)cudaErrorInvalidValue;
  cr_large_kernel<S, kSelect><<<plan.blocks, kCrThreads * plan.draws, 0,
                                stream>>>(
      static_cast<const S*>(A), static_cast<const S*>(B),
      static_cast<const S*>(C), static_cast<const S*>(D), static_cast<S*>(T),
      static_cast<S*>(R), static_cast<S*>(flags), static_cast<double*>(work),
      batch, n, m, n_iter);
  return (int)cudaGetLastError();
}

}  // namespace gcp

extern "C" {

// dtype: 0 = float32, 1 = float64.  Returns the cudaError_t of the launch.
int gcp_cr_policy(int dtype, const void* A, const void* B, const void* C,
                  const void* D, void* T, void* R, void* flags, int batch,
                  int n, int m, int n_iter, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_cr<float, true>(A, B, C, D, T, R, flags, batch, n, m,
                                       n_iter, s);
  return gcp::launch_cr<double, true>(A, B, C, D, T, R, flags, batch, n, m,
                                      n_iter, s);
}

// K4: T and flags [min|pivot|, tail] only (no D, no R).
int gcp_cr(int dtype, const void* A, const void* B, const void* C, void* T,
           void* flags, int batch, int n, int n_iter, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_cr<float, false>(A, B, C, nullptr, T, nullptr, flags,
                                        batch, n, 0, n_iter, s);
  return gcp::launch_cr<double, false>(A, B, C, nullptr, T, nullptr, flags,
                                       batch, n, 0, n_iter, s);
}

// Dynamic shared memory per block of the launch that gcp_cr_policy (m
// columns of D) or gcp_cr makes on the current device; the recursion is
// float64 for either I/O type.
size_t gcp_cr_policy_smem_bytes(int n, int m) {
  return gcp::cr_plan(n, m).bytes;
}

size_t gcp_cr_smem_bytes(int n) { return gcp::cr_plan(n, 0).bytes; }

// Draws per block of that launch (kCrThreads threads each); m = 0 for gcp_cr.
int gcp_cr_draws_per_block(int n, int m) { return gcp::cr_plan(n, m).draws; }

// Whether the small-state plan at (n, m) (m = 0: gcp_cr) fits one draw a
// block in the device's shared memory (then gcp_cr_policy / gcp_cr run;
// else the large entry points).
int gcp_cr_fits(int n, int m) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return gcp::cr_plan(n, m).bytes <= (size_t)limit;
}

// The large-state entry points: the arguments of gcp_cr_policy and gcp_cr,
// plus a float64 workspace of work_bytes >= gcp_cr_large_work_bytes(...) in
// device memory (cudaErrorInvalidValue, without a launch, if it is smaller
// or if n <= 32).
int gcp_cr_policy_large(int dtype, const void* A, const void* B,
                        const void* C, const void* D, void* T, void* R,
                        void* flags, void* work, size_t work_bytes, int batch,
                        int n, int m, int n_iter, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_cr_large<float, true>(A, B, C, D, T, R, flags, work,
                                             work_bytes, batch, n, m, n_iter,
                                             s);
  return gcp::launch_cr_large<double, true>(A, B, C, D, T, R, flags, work,
                                            work_bytes, batch, n, m, n_iter, s);
}

int gcp_cr_large(int dtype, const void* A, const void* B, const void* C,
                 void* T, void* flags, void* work, size_t work_bytes,
                 int batch, int n, int n_iter, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_cr_large<float, false>(A, B, C, nullptr, T, nullptr,
                                              flags, work, work_bytes, batch,
                                              n, 0, n_iter, s);
  return gcp::launch_cr_large<double, false>(A, B, C, nullptr, T, nullptr,
                                             flags, work, work_bytes, batch, n,
                                             0, n_iter, s);
}

// The workspace the large-state launch needs for this batch: one draw slot
// of the float64 layout per resident draw (select: the K1 launch, with m
// columns of D; else K4, m = 0).
size_t gcp_cr_large_work_bytes(int dtype, int select, int n, int m,
                               int batch) {
  if (select)
    return dtype == 0 ? gcp::cr_large_plan<float, true>(n, m, batch).work_bytes
                      : gcp::cr_large_plan<double, true>(n, m, batch)
                            .work_bytes;
  return dtype == 0 ? gcp::cr_large_plan<float, false>(n, 0, batch).work_bytes
                    : gcp::cr_large_plan<double, false>(n, 0, batch).work_bytes;
}

#if GCP_CR_PROBE
// The probe's clocks (8 sums, see cr_probe): set to 0, and read back.
int gcp_cr_probe_reset() {
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(gcp::cr_probe, zero, sizeof(zero));
}

int gcp_cr_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, gcp::cr_probe, 8 * sizeof(*out));
}
#endif

}  // extern "C"
