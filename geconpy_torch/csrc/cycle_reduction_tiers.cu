// K1 and K4 (cycle_reduction.cu) in the two tiers between the small-state
// kernel and the device-memory one: the on-chip tier (one draw a CTA, its
// buffers in the CTA's shared memory) and the cluster tier (a draw a
// thread-block cluster).  The same TPU kernels as cycle_reduction.cu
// replaces: _cr_sel_kernel (geconpy_tpu/ops/pallas_cycle_reduction.py:176,
// K1, with kSelect) and _cr_kernel (:145, K4).  The wrappers pick a tier by
// size alone (ops/batched_cycle_reduction.py::cr_tier).  A source of its
// own so that nvcc builds it beside cycle_reduction.cu.
#include "cluster_linalg.cuh"

#ifndef GCP_CR_PROBE
#define GCP_CR_PROBE 0   // 1: clocks per phase of draw 0
#endif

namespace gcp {

#if GCP_CR_PROBE
// clocks of draw 0 (thread 0; in the cluster tier CTA 0's), summed by
// phase as cycle_reduction.cu's cr_probe: eliminations of the doublings,
// the first and second round of products, the updates, the solve for T,
// the inputs, the rest; and slot 7, the on-chip pivot warp's publish and
// search, or the cluster tier's waits at cluster barriers
__device__ unsigned long long cr_tier_probe[8];
#define CR_MARK(slot)                                              \
  do {                                                             \
    if (probe) {                                                   \
      const unsigned long long now = clock64();                    \
      cr_tier_probe[slot] += now - probe_t;                        \
      probe_t = now;                                               \
    }                                                              \
  } while (0)
#else
#define CR_MARK(slot) do {} while (0)
#endif

// ---------------------------------------------------------------------------
// The on-chip tier: one draw a CTA, its buffers in the CTA's shared memory.
//
// cr_draw's layout above n = 32 is five tiles and the augmented system, 8
// n x n blocks (242,336 B at n = 52, m = 14), over the 232,448 B a block
// may have.  Its fifth tile, X, only takes -A2 Q2 while A2 and A0 are both
// still read.  Here the spent left block of the system takes the products
// in turn instead: A2 Q0, subtracted from A1 and Ahat, then -A2 Q2, then
// -A0 Q0 into A2's tile once A2 is read; the pass that writes the next
// system moves -A2 Q2 into A0's spent tile.  Seven blocks (212,544 B with the
// scalars at n = 52, m = 14), so one draw fits a CTA for n = 49..56 (64
// stored rows, ceil8(n) = 56 columns a block).  Every product is cr_draw's
// on the same operands (tile_mm); only the order in which they run differs,
// and two more CTA barriers a doubling.
//
// The eliminations.  cr_eliminate in shared memory, one thread a column and
// eight warps a draw, took 4.2M of a draw's 5.1M clocks at n = 52 (~5,800
// a pivot step against ~1,300 for its shared-memory traffic: each thread's
// chain of loads and stores down its column, with one draw an SM to hide
// it), and K1 at 4096 draws 82.0 ms against the device-memory tier's 84.0
// (tools/cr_variants.py PROBE=1, NVIDIA H100 80GB HBM3, 700.00 W).  Here
// (cr_eliminate_cols) a thread holds its column in registers for the whole
// solve, and rows do not move: a pivot step reads the pivot column (n
// broadcast loads, which its owner published), and a thread fetches its
// entry of the pivot row from its registers by the pivot's group of eight
// rows (a uniform branch) and a select.  _gj_solve's row swaps become a
// permutation between physical rows and logical positions, which the pivot
// search (first maximum in logical order, NaN largest) and the write-back
// read; each entry gets the same operations as under cr_eliminate, so the
// pivots and sums are the device-memory tier's to the bit.  A draw has
// kCrOnWarps warps: the elimination gives a thread a column (3n of them in
// a doubling's solve), the products a 16 x 16 tile each.  The grid is
// persistent, one CTA an SM, each striding over the batch.  The next
// draw's inputs are not staged ahead: the CTA's shared memory has no room
// for them beside the tail's buffers, and an L2 bulk prefetch of them
// during the tail moved K1 at 4096 draws and K4 at 128 by under 1.2%, K4
// the wrong way (tools/cr_variants.py, NVIDIA H100 80GB HBM3, 700.00 W).
constexpr int kCrOnWarps = 8;   // warps a draw (one draw a CTA)
constexpr int kCrOnThreads = 32 * kCrOnWarps;
constexpr int kCrOnRows = 56;   // rows a thread holds: the tier's largest n
// scalars (see cr_onchip_draw): 8, the per-warp maxima, two pivot columns,
// and the row permutation (2 kCrOnRows ints)
constexpr int kCrOnScal = 8 + 3 * kCrOnWarps + 3 * kCrOnRows;

// Offsets (in doubles) of the on-chip tier's draw: four tiles (tile layout,
// ceil16(n) rows, leading dimension tile_ld(n)), the augmented system (as
// CrLayout's), then kCrOnScal scalars.  Mirrored for the tier choice by
// ops/batched_cycle_reduction.py::cr_layout_bytes and its _CR_ON_*
// constants: a change here is a change there.
struct CrOnchipLayout {
  int nr, n8, ld, lda;
  int tile[4], aug, scal, total;
  __host__ __device__ CrOnchipLayout(int n, int m) {
    nr = ceil16(n);
    n8 = ceil8(n);
    ld = tile_ld(n);
    const int w = 3 * n8 > n8 + ceil8(m) ? 3 * n8 : n8 + ceil8(m);
    lda = w + 4;   // 4 mod 8, as tile_ld
    int o = 0;
    for (int t = 0; t < 4; ++t, o += nr * ld) tile[t] = o;
    aug = o; o += nr * lda;
    scal = o; o += kCrOnScal;
    total = o;
  }
};

// By one warp: the pivot of step k over the column cv (entry i at cv[i *
// stride], rows i < n never moved): the first maximal |entry| over the rows
// whose logical position lpos[i] is >= k, in logical order, NaN largest
// (pivot_wins).  Lane 0 records its physical row in *prow, 1 / pivot in
// *pinv, folds |pivot| into *minpiv and swaps the logical positions of the
// pivot's row and position k's row (plog: the physical row at each
// position).
__device__ __forceinline__ void cr_pivot_record(const double* cv, int stride,
                                                int n, int k, int lane,
                                                int* prow, double* pinv,
                                                double* minpiv, int* lpos,
                                                int* plog) {
  double best = -1.0, pv = 0.0;
  int bl = 0x7fffffff, P = 0;   // the winner's logical position and row
  for (int i = lane; i < n; i += 32) {
    const int li = lpos[i];
    const double s = cv[i * stride], v = fabs(s);
    if (li >= k && pivot_wins(v, li, best, bl)) {
      best = v; bl = li; pv = s; P = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int ol = __shfl_xor_sync(0xffffffffu, bl, off);
    const double os = __shfl_xor_sync(0xffffffffu, pv, off);
    const int oP = __shfl_xor_sync(0xffffffffu, P, off);
    if (pivot_wins(ov, ol, best, bl)) { best = ov; bl = ol; pv = os; P = oP; }
  }
  if (lane == 0) {
    const int Rk = plog[k];
    *prow = P;
    *pinv = 1.0 / pv;
    *minpiv = nan_min(*minpiv, fabs(pv));
    plog[k] = P;
    plog[bl] = Rk;
    lpos[P] = k;
    lpos[Rk] = bl;
  }
}

// Gauss-Jordan on the on-chip draw's augmented system (cr_eliminate's
// arguments and schedule) by its kCrOnThreads threads, n <= kCrOnRows, n +
// n_right <= kCrOnThreads.  Thread c holds logical column c in x (rows
// 0..n-1; the rows are never moved).  Step k: the pivot row P (physical)
// and 1 / pivot in slot k & 1 of prow and pinv, the pivot column in col[k &
// 1]; each column j > k of the left block and every right-hand column gets
// r = x[P] / pivot at row P and x[i] - col[i] r elsewhere.  The thread of
// column k + 1 then publishes it in the other slot, and its warp searches
// the next pivot: the first maximal |entry| over the rows whose logical
// position (lpos) is >= k + 1, in logical order, NaN largest; lane 0 swaps
// the pivot's logical position with position k + 1's row (plog: the
// physical row at each position).  On return the right-hand columns hold
// the solution in logical row order in aug (the left block is not written
// back) and the system is visible to the CTA.  The caller's barrier
// precedes (system written).
static __device__ __noinline__ void cr_eliminate_cols(
    double* aug, int lda, int n, int n8, int n_right, int bw, int dt,
    int warp, int lane, int* prow, double* pinv, double* minpiv, double* col,
    int* lpos, int* plog, bool probe) {
  constexpr int R = kCrOnRows;
  const int cols = n + n_right;
  const bool mine = dt < cols;
  int j = dt;   // the thread's column of aug
  if (dt >= n) {
    const int r = dt - n, q = r / bw;
    j = n8 * (1 + q) + (r - q * bw);
  }
  double x[R];
#pragma unroll
  for (int i = 0; i < R; ++i)
    x[i] = (mine && i < n) ? aug[i * lda + j] : 0.0;
  auto search = [&](int k) {
    cr_pivot_record(col + (k & 1) * R, 1, n, k, lane, prow + (k & 1),
                    pinv + (k & 1), minpiv, lpos, plog);
  };
  for (int i = dt; i < R; i += kCrOnThreads) {
    lpos[i] = i;
    plog[i] = i;
  }
  if (dt == 0) {
#pragma unroll
    for (int i = 0; i < R; ++i) col[i] = x[i];
  }
  __syncthreads();
  if (warp == 0) search(0);
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    // the pivot row, uniform to the compiler (a lane's broadcast): the
    // branches on its group of eight rows are uniform
    const int P = __shfl_sync(0xffffffffu, prow[k & 1], 0);
    const int Pg = P >> 3, Pq = P & 7;
    if (mine && (dt >= n || dt > k)) {
      const double pi = pinv[k & 1];
      const double* cv = col + (k & 1) * R;
      // x[P], from the pivot's group of eight rows
      double xp = 0.0;
#pragma unroll
      for (int g = 0; g < R / 8; ++g)
        if (g == Pg) {
#pragma unroll
          for (int q = 0; q < 8; ++q) xp = q == Pq ? x[8 * g + q] : xp;
        }
      const double r = xp * pi;
#pragma unroll
      for (int i = 0; i < R; i += 2) {
        const double2 c = *reinterpret_cast<const double2*>(cv + i);
        x[i] = x[i] - c.x * r;
        x[i + 1] = x[i + 1] - c.y * r;
      }
#pragma unroll
      for (int g = 0; g < R / 8; ++g)
        if (g == Pg) {
#pragma unroll
          for (int q = 0; q < 8; ++q) x[8 * g + q] = q == Pq ? r : x[8 * g + q];
        }
    }
    const int next = k + 1;
    if (next < n && warp == next >> 5) {
#if GCP_CR_PROBE
      const unsigned long long t0 = clock64();
#endif
      if (dt == next) {
        double* cv = col + (next & 1) * R;
#pragma unroll
        for (int i = 0; i < R; ++i) cv[i] = x[i];
      }
      __syncwarp();
      search(next);
#if GCP_CR_PROBE
      if (probe && lane == 0) cr_tier_probe[7] += clock64() - t0;
#endif
    }
    __syncthreads();
  }
  if (mine && dt >= n) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i < n) aug[lpos[i] * lda + j] = x[i];
  }
  __syncthreads();
}

// The recursion of draw b by its CTA (cr_draw's above n = 32, in the order
// of the layout note).  Returns once b's outputs are written; the caller
// synchronises the CTA before it reuses the buffers.
template <typename S, bool kSelect>
__device__ __forceinline__ void cr_onchip_draw(
    const S* __restrict__ gA, const S* __restrict__ gB,
    const S* __restrict__ gC, const S* __restrict__ gD, S* __restrict__ gT,
    S* __restrict__ gR, S* __restrict__ gflags, double* sm,
    const CrOnchipLayout& L, size_t b, int n, int m, int n_iter, WarpCtx w) {
  constexpr int kT = kCrOnThreads;
  const int dt = w.warp * 32 + w.lane;
#if GCP_CR_PROBE
  const bool probe = b == 0 && dt == 0;
  unsigned long long probe_t = clock64();
#endif
  auto sync = [] { __syncthreads(); };
  double* A0 = sm + L.tile[0];
  double* A1 = sm + L.tile[1];
  double* A2 = sm + L.tile[2];
  double* Ahat = sm + L.tile[3];
  double* aug = sm + L.aug;
  // scalars: [2] min|pivot|, [3] pivot row (2 ints), [4, 5] 1 / pivot
  // (the elimination's two slots), [8..] per-warp maxima, then the two
  // pivot columns and the row permutation of cr_eliminate_cols
  double* sc = sm + L.scal;
  double* minpiv = sc + 2;
  int* prow = reinterpret_cast<int*>(sc + 3);
  double* pinv = sc + 4;
  double* red_a0 = sc + 8;
  double* red_a2 = red_a0 + kCrOnWarps;
  double* red_res = red_a2 + kCrOnWarps;
  double* col = red_res + kCrOnWarps;
  int* lpos = reinterpret_cast<int*>(col + 2 * kCrOnRows);
  int* plog = lpos + kCrOnRows;
  const int nn = n * n, ld = L.ld, lda = L.lda, n8 = L.n8;
  double* left = aug;   // the system's spent left block
  double* Q0 = aug + n8;
  double* Q2 = aug + 2 * n8;
  const S* A = gA + b * nn;
  const S* B = gB + b * nn;
  const S* C = gC + b * nn;
  const S* no_g = nullptr;
  S* no_o = nullptr;
  auto product = [n](const double* Am, int ldam, const double* Bm, int ldbm,
                     double sign, double* Cm, int ldcm) {
    return TileProduct{Am, ldam, Bm, ldbm, false, n, n, n, nullptr, 0,
                       nullptr, 0, 0, sign, false, nullptr, 0, Cm, ldcm};
  };
  auto eliminate = [&](int n_right, int bw) {
    cr_eliminate_cols(aug, lda, n, n8, n_right, bw, dt, w.warp, w.lane, prow,
                      pinv, minpiv, col, lpos, plog, b == 0);
  };

  // ---- inputs, zero-padded: A0 = A, A1 = Ahat = B, A2 = C; the system
  // [A1 | A0 | A2] (or [Ahat | -A] without doublings)
  for (int e = dt; e < L.nr * ld; e += kT) {
    const int i = e / ld, j = e - i * ld;
    const bool in = i < n && j < n;
    const double bv = in ? double(B[i * n + j]) : 0.0;
    A0[e] = in ? double(A[i * n + j]) : 0.0;
    A1[e] = bv;
    Ahat[e] = bv;
    A2[e] = in ? double(C[i * n + j]) : 0.0;
  }
  for (int e = dt; e < L.nr * lda; e += kT) {
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
  if (dt == 0) *minpiv = INFINITY;
  sync();
  CR_MARK(5);

  for (int it = 0; it < n_iter; ++it) {
    // [spent | Q0 | Q2]: Q0 = A1^{-1} A0, Q2 = A1^{-1} A2
    eliminate(2 * n, n);
    CR_MARK(0);
    // left = A2 Q0;  A1 <- A1 - A0 Q2
    tile_mm(product(A2, ld, Q0, lda, 1.0, left, lda), no_g, 0, no_o, 0, w);
    TileProduct a1 = product(A0, ld, Q2, lda, -1.0, A1, ld);
    a1.E = A1;
    a1.lde = ld;
    tile_mm(a1, no_g, 0, no_o, 0, w);
    sync();
    CR_MARK(1);
    // A1 <- A1 - A2 Q0;  Ahat <- Ahat - A2 Q0
    for (int e = dt; e < nn; e += kT) {
      const int i = e / n, j = e - i * n;
      const int o = i * ld + j;
      const double s = left[i * lda + j];
      A1[o] = A1[o] - s;
      Ahat[o] = Ahat[o] - s;
    }
    sync();
    CR_MARK(3);
    // left = -A2 Q2; then, A2 read, its tile takes -A0 Q0
    tile_mm(product(A2, ld, Q2, lda, -1.0, left, lda), no_g, 0, no_o, 0, w);
    sync();
    tile_mm(product(A0, ld, Q0, lda, -1.0, A2, ld), no_g, 0, no_o, 0, w);
    sync();
    CR_MARK(2);
    double* spent = A0;
    A0 = A2;      // -A0 Q0
    A2 = spent;   // takes -A2 Q2 from the left block
    // A2 <- left;  (aug) the next system
    const bool last = it + 1 == n_iter;
    for (int e = dt; e < nn; e += kT) {
      const int i = e / n, j = e - i * n;
      const int o = i * ld + j, oa = i * lda + j;
      const double a2v = left[oa];
      A2[o] = a2v;
      if (!last) {
        aug[oa] = A1[o];
        aug[oa + n8] = A0[o];
        aug[oa + 2 * n8] = a2v;
      } else {
        aug[oa] = Ahat[o];
        aug[oa + n8] = -double(A[e]);
      }
    }
    sync();
    CR_MARK(3);
  }

  // tail = max|A0_final| + max|A2_final|: per-warp maxima, read after the
  // elimination's barriers
  {
    double m0 = 0.0, m2 = 0.0;
    for (int e = dt; e < nn; e += kT) {
      const int o = (e / n) * ld + e % n;
      m0 = nan_max(m0, fabs(A0[o]));
      m2 = nan_max(m2, fabs(A2[o]));
    }
    warp_max_to(m0, red_a0 + w.warp, w.lane);
    warp_max_to(m2, red_a2 + w.warp, w.lane);
  }
  auto warps_max = [](const double* r) {
    double v = r[0];
#pragma unroll
    for (int q = 1; q < kCrOnWarps; ++q) v = nan_max(v, r[q]);
    return v;
  };

  // ---- T = Ahat^{-1} (-A), to device memory and, for the selection, to
  // A1's tile
  S* T_out = gT + b * nn;
  eliminate(n, n);
  CR_MARK(4);
  const double tail = warps_max(red_a0) + warps_max(red_a2);
  for (int e = dt; e < L.nr * ld; e += kT) {
    const int i = e / ld, j = e - i * ld;
    const bool in = i < n && j < n;
    const double t = in ? aug[i * lda + n8 + j] : 0.0;
    if (in) T_out[i * n + j] = S(t);
    if (kSelect) {
      A1[e] = t;
      A0[e] = in ? double(C[i * n + j]) : 0.0;
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
  sync();
  // M = C T + B  (into A2's tile)
  tile_mm(product(A0, ld, A1, ld, 1.0, A2, ld), B, n, no_o, 0, w);
  sync();
  // Ahat = A + M T for the residual;  (aug) the system [M | -D]
  tile_mm(product(A2, ld, A1, ld, 1.0, Ahat, ld), A, n, no_o, 0, w);
  for (int e = dt; e < nn; e += kT) {
    const int i = e / n, j = e - i * n;
    aug[i * lda + j] = A2[i * ld + j];
  }
  for (int e = dt; e < n * m; e += kT) {
    const int i = e / m, j = e - i * m;
    aug[i * lda + n8 + j] = -double(D[e]);
  }
  sync();
  {
    double rmax = 0.0;
    for (int e = dt; e < nn; e += kT)
      rmax = nan_max(rmax, fabs(Ahat[(e / n) * ld + e % n]));
    warp_max_to(rmax, red_res + w.warp, w.lane);
  }
  // R = M^{-1} (-D)
  eliminate(m, m);
  for (int e = dt; e < n * m; e += kT) {
    const int i = e / m, j = e - i * m;
    R_out[e] = S(aug[i * lda + n8 + j]);
  }
  if (dt == 0) {
    gflags[b * 3 + 0] = S(*minpiv);
    gflags[b * 3 + 1] = S(tail);
    gflags[b * 3 + 2] = S(warps_max(red_res));
  }
  CR_MARK(6);
}

// The on-chip tier's kernel: one draw a CTA of kCrOnThreads threads, the
// grid persistent (as many CTAs as are resident, each striding over the
// batch).
template <typename S, bool kSelect>
__global__ void __launch_bounds__(kCrOnThreads, 1)
    cr_onchip_kernel(const S* __restrict__ gA, const S* __restrict__ gB,
                     const S* __restrict__ gC, const S* __restrict__ gD,
                     S* __restrict__ gT, S* __restrict__ gR,
                     S* __restrict__ gflags, int batch, int n, int m,
                     int n_iter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CrOnchipLayout L(n, m);
  // the warp's number through a shuffle (uniform to the compiler: see
  // cr_kernel)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const WarpCtx w{warp, kCrOnWarps, (int)(threadIdx.x & 31)};
  double* sm = reinterpret_cast<double*>(smem_raw);
  for (size_t b = blockIdx.x; b < (size_t)batch; b += gridDim.x) {
    cr_onchip_draw<S, kSelect>(gA, gB, gC, gD, gT, gR, gflags, sm, L, b, n,
                               m, n_iter, w);
    __syncthreads();   // the CTA is done with the buffers
  }
}

inline size_t cr_onchip_bytes(int n, int m) {
  return (size_t)CrOnchipLayout(n, m).total * sizeof(double);
}

// The CTAs of the on-chip kernel at (n, m) the device holds at once (its
// shared memory set); negative: the cudaError_t, where the layout does not
// fit (cudaErrorInvalidValue) or the device refuses it.
template <typename S, bool kSelect>
int cr_onchip_resident(int n, int m) {
  int dev = 0, limit = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t bytes = cr_onchip_bytes(n, m);
  // a thread a column of the widest system (3 ceil8(n), or n + m)
  const int widest = n + (2 * n > m ? 2 * n : m);
  if (n < 1 || n > kCrOnRows || widest > kCrOnThreads ||
      bytes > (size_t)limit)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cr_onchip_kernel<S, kSelect>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cr_onchip_kernel<S, kSelect>, kCrOnThreads, bytes);
  if (err != cudaSuccess) return -(int)err;
  return (per_sm > 0 ? per_sm : 1) * sms;
}

// The on-chip launch: one draw a CTA, as many CTAs as are resident (at most
// one a draw); cudaErrorInvalidValue, without a launch, where the layout
// does not fit the device's shared memory.
template <typename S, bool kSelect>
int launch_cr_onchip(const void* A, const void* B, const void* C,
                     const void* D, void* T, void* R, void* flags, int batch,
                     int n, int m, int n_iter, cudaStream_t stream) {
  const int resident = cr_onchip_resident<S, kSelect>(n, m);
  if (resident < 0) return -resident;
  const size_t bytes = cr_onchip_bytes(n, m);
  const int blocks = batch < resident ? batch : resident;
  if (blocks < 1) return 0;
  cr_onchip_kernel<S, kSelect><<<blocks, kCrOnThreads, bytes, stream>>>(
      static_cast<const S*>(A), static_cast<const S*>(B),
      static_cast<const S*>(C), static_cast<const S*>(D), static_cast<S*>(T),
      static_cast<S*>(R), static_cast<S*>(flags), batch, n, m, n_iter);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The cluster tier: one draw a thread-block cluster of up to 8 CTAs, each
// holding a row panel (`rows` rows, a multiple of 16: CTA r the rows r rows
// ..) of the four tiles and of the augmented system in its shared memory,
// as the on-chip tier's layout holds them whole; from n = 57 (where that
// layout outgrows a CTA) to n = 128 (8 CTAs of 16 rows) on an H100.
//
// The products are cluster_mm's (cluster_linalg.cuh): a CTA's rows of the
// result from its rows of A and the whole of B, whose rows it reads where
// they lie, through distributed shared memory.
//
// The eliminations (cr_cluster_eliminate) go in panels of kCrPanel pivots,
// ops/linalg.py::gj_eliminate_panels's schedule, so that the cluster meets
// at a barrier twice a panel, not once or twice a pivot (a cluster barrier
// costs ~4k clocks on an H100, settle.cuh's note).  Rows never move, as in
// the on-chip tier: logical positions follow the swaps.  A panel: every CTA
// gathers the panel's columns of all rows and factors them on its own (the
// same arithmetic in every CTA, so the same pivots), gathers the panel's
// pivot rows of the whole system and turns them into r_t in order; once
// every CTA has read what it needs of its peers, each updates its own rows
// as x - C r (one tensor-core product of depth kCrPanel over the system's
// columns) and its pivot rows by their own sums.  The solution stays in
// physical row order; a product that takes it as B (A Q0, A Q2, C T, M T)
// takes A's columns in the same order instead (permuted in place, a
// CTA's own rows), which reorders only that product's sums.
//
// Flags: every CTA computes the same pivots, so the same min |pivot|; the
// maxima (tail, residual) go from each CTA to slots in CTA 0, which writes
// the flags.  The grid is persistent: as many clusters as are resident,
// each striding over the batch.
constexpr int kCrPanel = 8;   // pivots a panel of the cluster tier
static_assert(kCrPanel % 8 == 0, "a panel is whole 8-wide steps of tile_mm");
constexpr int kCrPanelLd = kCrPanel + 4;   // 4 mod 8, as tile_ld
constexpr int kCrClWarps = 8;
constexpr int kCrClThreads = 32 * kCrClWarps;
// scalars: [0] min|pivot|, 1 / pivot (kCrPanel), r of the step's pivot row
// (kCrPanel), prow (kCrPanel ints), per-warp maxima (3 kCrClWarps), each
// CTA's maxima in CTA 0 (3 kClusterMaxCtas)
constexpr int kCrClScal = 1 + 2 * kCrPanel + (kCrPanel / 2 + 1) +
                          3 * kCrClWarps + 3 * kClusterMaxCtas;

// Offsets (in doubles) of one CTA's share of a cluster draw with `rows`
// rows a CTA: four tiles of `rows` rows (tile layout), the system's rows
// (CrLayout's widths), the gathered panel (every row of the draw, rounded
// up to whole panels of rows, kCrPanelLd a row), the panel's pivot rows of
// the system, the row permutation (2 x ceil16(n) ints), the scalars.
// Mirrored, with cr_cluster_plan below, by
// ops/batched_cycle_reduction.py::cr_cluster_plan and its _CR_CL_*
// constants and CR_PANEL: a change here is a change there.
struct CrClusterLayout {
  int nr, n8, ld, lda, prows;
  int tile[4], aug, pn, pr, perm, scal, total;
  __host__ __device__ CrClusterLayout(int n, int m, int rows) {
    nr = ceil16(n);
    n8 = ceil8(n);
    ld = tile_ld(n);
    const int w = 3 * n8 > n8 + ceil8(m) ? 3 * n8 : n8 + ceil8(m);
    lda = w + 4;
    prows = (nr + rows - 1) / rows * rows;
    int o = 0;
    for (int t = 0; t < 4; ++t, o += rows * ld) tile[t] = o;
    aug = o; o += rows * lda;
    pn = o; o += prows * kCrPanelLd;
    pr = o; o += kCrPanel * lda;
    perm = o; o += nr;   // 2 nr ints
    scal = o; o += kCrClScal;
    total = o;
  }
};

// How a cluster launch is cut: CTAs a cluster and rows a CTA (the fewest
// CTAs whose share fits a block's shared memory), and the bytes of a CTA's
// share; ctas 0 where none up to kClusterMaxCtas fits, or where n > 128
// (cr_permute_columns holds 4 columns a lane).
struct CrClusterPlan {
  int ctas, rows;
  size_t bytes;
};

inline CrClusterPlan cr_cluster_plan(int n, int m) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int tiles = ceil16(n) / 16;
  CrClusterPlan p{0, 0, 0};
  if (n < 1 || n > 128) return p;
  for (int c = 2; c <= kClusterMaxCtas; ++c) {
    const int per = (tiles + c - 1) / c;
    const size_t bytes =
        (size_t)CrClusterLayout(n, m, 16 * per).total * sizeof(double);
    if (bytes > (size_t)limit) continue;
    p.ctas = (tiles + per - 1) / per;
    p.rows = 16 * per;
    p.bytes = bytes;
    return p;
  }
  return p;
}

// Column j of this CTA's rows of A (tile layout, leading dimension ld) <-
// column lpos[j], j < n: the columns in the order of a solution's physical
// rows.  One warp a row; the caller synchronises the CTA after.
__device__ __forceinline__ void cr_permute_columns(double* A, int ld,
                                                   int rows, int n,
                                                   const int* lpos,
                                                   WarpCtx w) {
  for (int il = w.warp; il < rows; il += w.n_warps) {
    double v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = w.lane + 32 * q;
      v[q] = j < n ? A[il * ld + lpos[j]] : 0.0;
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = w.lane + 32 * q;
      if (j < n) A[il * ld + j] = v[q];
    }
  }
}

// Gauss-Jordan on a cluster draw's augmented system (this CTA's rows of
// it in aug: the n x n left block, then every stored column to lda - 4 as
// right-hand side; those past the solve's own are never read), in panels
// of kCrPanel pivots
// (gj_eliminate_panels's schedule; see the tier's note).  On return every
// CTA's rows hold their solution rows (physical row i: logical row
// lpos[i]), lpos and plog are the same in every CTA, and the cluster has
// met (the rows are visible to every peer).  The caller's barriers precede
// (system written, CTA-wide).
static __device__ __noinline__ void cr_cluster_eliminate(
    double* aug, int lda, int n, const ClusterPart& cp,
    double* pn, double* pr, int* lpos, int* plog, int* prow, double* pinv,
    double* rrow, double* minpiv, WarpCtx w, bool probe) {
  const int dt = w.warp * 32 + w.lane;
  const int rows = cp.rows, row0 = cp.row0;
#if GCP_CR_PROBE
  // slot 7: the clocks thread 0 of the probed draw waits at the cluster's
  // barriers
  auto meet = [&](auto barrier) {
    const unsigned long long t0 = clock64();
    barrier();
    if (probe) cr_tier_probe[7] += clock64() - t0;
  };
#else
  (void)probe;
  auto meet = [](auto barrier) { barrier(); };
#endif
  const int W = lda - 4;   // stored columns of the system
  const int nr = ceil16(n);
  for (int i = dt; i < nr; i += kCrClThreads) {
    lpos[i] = i;
    plog[i] = i;
  }
  const int prows = (nr + rows - 1) / rows * rows;
  for (int k0 = 0; k0 < n; k0 += kCrPanel) {
    const int bb = n - k0 < kCrPanel ? n - k0 : kCrPanel;
    meet(cluster_sync);   // every CTA's rows are current
    // the panel: its bb columns of every row (zero beyond)
    for (int e = dt; e < prows * kCrPanel; e += kCrClThreads) {
      const int i = e / kCrPanel, j = e - i * kCrPanel;
      double v = 0.0;
      if (i < n && j < bb)
        v = peer(aug, i / rows)[(i % rows) * lda + k0 + j];
      pn[i * kCrPanelLd + j] = v;
    }
    __syncthreads();
    // its pivots, step by step, on the panel alone
    for (int j = 0; j < bb; ++j) {
      if (w.warp == 0) {
        if (j > 0) {   // the last step's pivot row, scaled
          const int Pp = prow[j - 1];
          for (int jj = j + w.lane; jj < bb; jj += 32)
            pn[Pp * kCrPanelLd + jj] = rrow[jj];
        }
        __syncwarp();
        cr_pivot_record(pn + j, kCrPanelLd, n, k0 + j, w.lane, prow + j,
                        pinv + j, minpiv, lpos, plog);
      }
      __syncthreads();
      const int P = prow[j];
      const double pi = pinv[j];
      const int wide = bb - 1 - j;   // the panel's columns after j
      for (int e = dt; e < n * wide; e += kCrClThreads) {
        const int i = e / wide, jj = j + 1 + (e - i * wide);
        const double r = pn[P * kCrPanelLd + jj] * pi;
        if (i == P)
          rrow[jj] = r;
        else
          pn[i * kCrPanelLd + jj] = pn[i * kCrPanelLd + jj] -
                                    pn[i * kCrPanelLd + j] * r;
      }
      __syncthreads();
    }
    // the pivot rows of the system
    for (int e = dt; e < kCrPanel * W; e += kCrClThreads) {
      const int t = e / W, c = e - t * W;
      double v = 0.0;
      if (t < bb) {
        const int P = prow[t];
        v = peer(aug, P / rows)[(P % rows) * lda + c];
      }
      pr[t * lda + c] = v;
    }
    __syncthreads();
    cluster_arrive();   // this CTA has read what it needs of its peers
    // r_t = (x_P_t - c_0[P_t] r_0 - ... - c_{t-1}[P_t] r_{t-1}) / pivot_t
    for (int c = dt; c < W; c += kCrClThreads) {
      for (int t = 0; t < bb; ++t) {
        const double* cP = pn + prow[t] * kCrPanelLd;
        double v = pr[t * lda + c];
        for (int s = 0; s < t; ++s) v = v - cP[s] * pr[s * lda + c];
        pr[t * lda + c] = v * pinv[t];
      }
    }
    __syncthreads();
    meet(cluster_wait);   // no peer reads this CTA's rows any more
    // every row of this CTA: x - C r; then its pivot rows
    TileProduct upd = tile_product(pn + row0 * kCrPanelLd, kCrPanelLd, pr,
                                   lda, false, rows, kCrPanel, W, aug, lda);
    upd.sign = -1.0;
    upd.E = aug;
    upd.lde = lda;
    tile_mm(upd, (const double*)nullptr, 0, (double*)nullptr, 0, w);
    __syncthreads();
    for (int e = dt; e < bb * W; e += kCrClThreads) {
      const int t = e / W, c = e - t * W;
      const int P = prow[t];
      if (P < row0 || P >= row0 + rows) continue;
      const double* cP = pn + P * kCrPanelLd;
      double v = pr[t * lda + c];
      for (int s = t + 1; s < bb; ++s) v = v - cP[s] * pr[s * lda + c];
      aug[(P - row0) * lda + c] = v;
    }
    __syncthreads();
  }
  meet(cluster_sync);   // the solution's rows are final in every CTA
}

// The recursion of draw b by its cluster (the on-chip tier's order, on the
// CTAs' row panels; see the tier's note).  Returns once b's outputs are
// written; the caller meets the cluster before it reuses the buffers.
template <typename S, bool kSelect>
__device__ __forceinline__ void cr_cluster_draw(
    const S* __restrict__ gA, const S* __restrict__ gB,
    const S* __restrict__ gC, const S* __restrict__ gD, S* __restrict__ gT,
    S* __restrict__ gR, S* __restrict__ gflags, double* sm,
    const CrClusterLayout& L, const ClusterPart& cp, size_t b, int n, int m,
    int n_iter, WarpCtx w) {
  constexpr int kT = kCrClThreads;
  const int dt = w.warp * 32 + w.lane;
  const int rows = cp.rows, row0 = cp.row0, rloc = cp.rloc;
#if GCP_CR_PROBE
  const bool probe = b == 0 && dt == 0 && cp.rank == 0;
  unsigned long long probe_t = clock64();
#else
  const bool probe = false;
#endif
  double* A0 = sm + L.tile[0];
  double* A1 = sm + L.tile[1];
  double* A2 = sm + L.tile[2];
  double* Ahat = sm + L.tile[3];
  double* aug = sm + L.aug;
  double* pn = sm + L.pn;
  double* pr = sm + L.pr;
  int* lpos = reinterpret_cast<int*>(sm + L.perm);
  int* plog = lpos + L.nr;
  double* sc = sm + L.scal;
  double* minpiv = sc;
  double* pinv = sc + 1;
  double* rrow = pinv + kCrPanel;
  int* prow = reinterpret_cast<int*>(rrow + kCrPanel);
  double* red = reinterpret_cast<double*>(prow) + kCrPanel / 2 + 1;
  double* slots = red + 3 * kCrClWarps;   // [what][CTA], in CTA 0
  const int nn = n * n, ld = L.ld, lda = L.lda, n8 = L.n8;
  double* left = aug;
  double* Q0 = aug + n8;
  double* Q2 = aug + 2 * n8;
  const S* A = gA + b * nn;
  const S* B = gB + b * nn;
  const S* C = gC + b * nn;
  const S* no_g = nullptr;
  S* no_o = nullptr;
  // this CTA's rows of sign A B for n x n x n, B spread over the cluster
  auto product = [&](const double* Am, const double* Bm, int ldbm,
                     double sign, double* Cm, int ldcm) {
    PanelProduct p = panel_product(cp, Am, ld, Bm, ldbm, false, true, n, n,
                                   n, Cm, ldcm);
    p.sign = sign;
    return p;
  };
  auto eliminate = [&] {
    cr_cluster_eliminate(aug, lda, n, cp, pn, pr, lpos, plog, prow, pinv,
                         rrow, minpiv, w, probe);
  };
  // this CTA's maximum of `v` (per-warp maxima in red[q]) into slot q of
  // CTA 0, read there after the next cluster barrier
  auto cluster_max = [&](double v, int q) {
    warp_max_to(v, red + q * kCrClWarps + w.warp, w.lane);
    __syncthreads();
    if (dt == 0) {
      double x = red[q * kCrClWarps];
      for (int i = 1; i < kCrClWarps; ++i)
        x = nan_max(x, red[q * kCrClWarps + i]);
      peer(slots, 0)[q * kClusterMaxCtas + cp.rank] = x;
    }
  };
  auto slots_max = [&](int q) {
    double x = slots[q * kClusterMaxCtas];
    for (int i = 1; i < cp.ctas; ++i)
      x = nan_max(x, slots[q * kClusterMaxCtas + i]);
    return x;
  };

  // ---- inputs, this CTA's rows, zero-padded: A0 = A, A1 = Ahat = B,
  // A2 = C; the system [A1 | A0 | A2] (or [Ahat | -A] without doublings)
  for (int e = dt; e < rows * ld; e += kT) {
    const int il = e / ld, j = e - il * ld, i = row0 + il;
    const bool in = i < n && j < n;
    const double bv = in ? double(B[i * n + j]) : 0.0;
    A0[e] = in ? double(A[i * n + j]) : 0.0;
    A1[e] = bv;
    Ahat[e] = bv;
    A2[e] = in ? double(C[i * n + j]) : 0.0;
  }
  for (int e = dt; e < rows * lda; e += kT) {
    const int il = e / lda, j = e - il * lda, i = row0 + il;
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
  if (dt == 0) *minpiv = INFINITY;
  __syncthreads();
  CR_MARK(5);

  for (int it = 0; it < n_iter; ++it) {
    eliminate();   // Q0, Q2 in physical row order
    CR_MARK(0);
    // A0 and A2 take their columns in that order for the products
    cr_permute_columns(A0, ld, rows, n, lpos, w);
    cr_permute_columns(A2, ld, rows, n, lpos, w);
    __syncthreads();
    CR_MARK(3);
    // left = A2 Q0;  A1 <- A1 - A0 Q2
    cluster_mm<S, 1>(product(A2, Q0, lda, 1.0, left, lda), rows, no_g,
                          0, no_o, 0, w);
    PanelProduct a1 = product(A0, Q2, lda, -1.0, A1, ld);
    a1.E = A1;
    a1.lde = ld;
    cluster_mm<S, 1>(a1, rows, no_g, 0, no_o, 0, w);
    __syncthreads();
    CR_MARK(1);
    // A1 <- A1 - A2 Q0;  Ahat <- Ahat - A2 Q0
    for (int e = dt; e < rloc * n; e += kT) {
      const int il = e / n, j = e - il * n;
      const int o = il * ld + j;
      const double s = left[il * lda + j];
      A1[o] = A1[o] - s;
      Ahat[o] = Ahat[o] - s;
    }
    __syncthreads();
    CR_MARK(3);
    // left = -A2 Q2; then, A2 read, its tile takes -A0 Q0
    cluster_mm<S, 1>(product(A2, Q2, lda, -1.0, left, lda), rows, no_g,
                          0, no_o, 0, w);
    __syncthreads();
    cluster_mm<S, 1>(product(A0, Q0, lda, -1.0, A2, ld), rows, no_g, 0,
                          no_o, 0, w);
    cluster_sync();   // no CTA reads a peer's Q0 or Q2 any more
    CR_MARK(2);
    double* spent = A0;
    A0 = A2;      // -A0 Q0
    A2 = spent;   // takes -A2 Q2 from the left block
    const bool last = it + 1 == n_iter;
    for (int e = dt; e < rloc * n; e += kT) {
      const int il = e / n, j = e - il * n;
      const int o = il * ld + j, oa = il * lda + j;
      const double a2v = left[oa];
      A2[o] = a2v;
      if (!last) {
        aug[oa] = A1[o];
        aug[oa + n8] = A0[o];
        aug[oa + 2 * n8] = a2v;
      } else {
        aug[oa] = Ahat[o];
        aug[oa + n8] = -double(A[(row0 + il) * n + j]);
      }
    }
    __syncthreads();
    CR_MARK(3);
  }

  // tail = max|A0_final| + max|A2_final| over the cluster
  {
    double m0 = 0.0, m2 = 0.0;
    for (int e = dt; e < rloc * n; e += kT) {
      const int o = (e / n) * ld + e % n;
      m0 = nan_max(m0, fabs(A0[o]));
      m2 = nan_max(m2, fabs(A2[o]));
    }
    cluster_max(m0, 0);
    cluster_max(m2, 1);
  }
  // ---- T = Ahat^{-1} (-A): this CTA's physical rows, to their logical
  // rows of T in device memory
  eliminate();
  CR_MARK(4);
  S* T_out = gT + b * nn;
  for (int e = dt; e < rloc * n; e += kT) {
    const int il = e / n, j = e - il * n;
    T_out[lpos[row0 + il] * n + j] = S(aug[il * lda + n8 + j]);
  }
  if constexpr (!kSelect) {
    if (cp.rank == 0 && dt == 0) {
      gflags[b * 2 + 0] = S(*minpiv);
      gflags[b * 2 + 1] = S(slots_max(0) + slots_max(1));
    }
    CR_MARK(6);
    return;
  }
  const double tail = slots_max(0) + slots_max(1);
  const S* D = gD + b * (size_t)n * m;
  S* R_out = gR + b * (size_t)n * m;
  // C with its columns in T's physical row order (A0's tile)
  for (int e = dt; e < rows * ld; e += kT) {
    const int il = e / ld, j = e - il * ld, i = row0 + il;
    A0[e] = i < n && j < n ? double(C[i * n + lpos[j]]) : 0.0;
  }
  __syncthreads();
  // M = C T + B  (A2's tile)
  cluster_mm<S, 1>(product(A0, Q0, lda, 1.0, A2, ld), rows, B, n, no_o, 0,
                   w);
  __syncthreads();
  // the system's left block <- M; A1 <- M, its columns permuted
  for (int e = dt; e < rows * ld; e += kT) {
    const int il = e / ld, j = e - il * ld;
    A1[e] = A2[e];
    if (j < n8) left[il * lda + j] = A2[e];
  }
  __syncthreads();
  cr_permute_columns(A1, ld, rows, n, lpos, w);
  __syncthreads();
  // Ahat = A + M T for the residual
  cluster_mm<S, 1>(product(A1, Q0, lda, 1.0, Ahat, ld), rows, A, n, no_o, 0,
                   w);
  {
    double rmax = 0.0;
    __syncthreads();
    for (int e = dt; e < rloc * n; e += kT)
      rmax = nan_max(rmax, fabs(Ahat[(e / n) * ld + e % n]));
    cluster_max(rmax, 2);
  }
  cluster_sync();   // no CTA reads a peer's T any more
  // the system [M | -D]
  const int wd = lda - 4 - n8;   // the right-hand block's stored columns
  for (int e = dt; e < rows * wd; e += kT) {
    const int il = e / wd, j = e - il * wd, i = row0 + il;
    aug[il * lda + n8 + j] = i < n && j < m ? -double(D[i * m + j]) : 0.0;
  }
  __syncthreads();
  eliminate();
  for (int e = dt; e < rloc * m; e += kT) {
    const int il = e / m, j = e - il * m;
    R_out[lpos[row0 + il] * m + j] = S(aug[il * lda + n8 + j]);
  }
  if (cp.rank == 0 && dt == 0) {
    gflags[b * 3 + 0] = S(*minpiv);
    gflags[b * 3 + 1] = S(tail);
    gflags[b * 3 + 2] = S(slots_max(2));
  }
  CR_MARK(6);
}

// The cluster tier's kernel: `ctas` CTAs a draw, `rows` rows a CTA; the
// grid persistent (as many clusters as are resident, each striding over the
// batch).
template <typename S, bool kSelect>
__global__ void __launch_bounds__(kCrClThreads, 1)
    cr_cluster_kernel(const S* __restrict__ gA, const S* __restrict__ gB,
                      const S* __restrict__ gC, const S* __restrict__ gD,
                      S* __restrict__ gT, S* __restrict__ gR,
                      S* __restrict__ gflags, int batch, int n, int m,
                      int n_iter, int ctas, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CrClusterLayout L(n, m, rows);
  const int rank = (int)cluster_ctarank();
  const int row0 = rank * rows;
  const int nr = ceil16(n);
  const ClusterPart cp{rank, ctas, rows, row0,
                       nr - row0 < rows ? (nr - row0 > 0 ? nr - row0 : 0)
                                        : rows,
                       n - row0 < rows ? (n - row0 > 0 ? n - row0 : 0)
                                       : rows};
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const WarpCtx w{warp, kCrClWarps, (int)(threadIdx.x & 31)};
  double* sm = reinterpret_cast<double*>(smem_raw);
  const size_t clusters = gridDim.x / ctas;
  for (size_t b = blockIdx.x / ctas; b < (size_t)batch; b += clusters) {
    cr_cluster_draw<S, kSelect>(gA, gB, gC, gD, gT, gR, gflags, sm, L, cp,
                                b, n, m, n_iter, w);
    cluster_sync();   // no peer reads this draw's buffers any more
  }
}

// The launch configuration of a plan (cluster dimension in attr), and the
// clusters of it the device holds at once (0 if it holds none; the CUDA
// error of the query, negated, if the query fails).
template <typename S, bool kSelect>
int cr_cluster_config(const CrClusterPlan& plan, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      cr_cluster_kernel<S, kSelect>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.bytes);
  if (err != cudaSuccess) return -(int)err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(plan.ctas, 1, 1);
  cfg.blockDim = dim3(kCrClThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.bytes;
  cfg.stream = stream;
  attr = cudaLaunchAttribute{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = plan.ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)cr_cluster_kernel<S, kSelect>, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters;
}

// The cluster launch; cudaErrorInvalidValue, without a launch, where no
// plan fits (cr_cluster_plan), cudaErrorLaunchOutOfResources where the
// device holds no cluster of it.
template <typename S, bool kSelect>
int launch_cr_cluster(const void* A, const void* B, const void* C,
                      const void* D, void* T, void* R, void* flags, int batch,
                      int n, int m, int n_iter, cudaStream_t stream) {
  const CrClusterPlan plan = cr_cluster_plan(n, m);
  if (plan.ctas == 0) return (int)cudaErrorInvalidValue;
  if (batch < 1) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = cr_cluster_config<S, kSelect>(plan, cfg, attr, stream);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return (int)cudaErrorLaunchOutOfResources;
  if (batch < clusters) clusters = batch;
  cfg.gridDim = dim3(clusters * plan.ctas, 1, 1);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cr_cluster_kernel<S, kSelect>, static_cast<const S*>(A),
      static_cast<const S*>(B), static_cast<const S*>(C),
      static_cast<const S*>(D), static_cast<S*>(T), static_cast<S*>(R),
      static_cast<S*>(flags), batch, n, m, n_iter, plan.ctas, plan.rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace gcp

extern "C" {

// The on-chip entry points: the arguments of gcp_cr_policy and gcp_cr; one
// draw a CTA in shared memory (cudaErrorInvalidValue, without a launch,
// where gcp_cr_onchip_smem_bytes exceeds the device's opt-in shared memory
// per block).
int gcp_cr_policy_onchip(int dtype, const void* A, const void* B,
                         const void* C, const void* D, void* T, void* R,
                         void* flags, int batch, int n, int m, int n_iter,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_cr_onchip<float, true>(A, B, C, D, T, R, flags, batch,
                                              n, m, n_iter, s);
  return gcp::launch_cr_onchip<double, true>(A, B, C, D, T, R, flags, batch,
                                             n, m, n_iter, s);
}

int gcp_cr_onchip(int dtype, const void* A, const void* B, const void* C,
                  void* T, void* flags, int batch, int n, int n_iter,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_cr_onchip<float, false>(A, B, C, nullptr, T, nullptr,
                                               flags, batch, n, 0, n_iter, s);
  return gcp::launch_cr_onchip<double, false>(A, B, C, nullptr, T, nullptr,
                                              flags, batch, n, 0, n_iter, s);
}

// Shared memory of an on-chip CTA at (n, m) (m = 0: gcp_cr_onchip), and the
// device's opt-in shared memory per block, which the wrappers' tier choice
// compares it with.
size_t gcp_cr_onchip_smem_bytes(int n, int m) {
  return gcp::cr_onchip_bytes(n, m);
}

int gcp_cr_onchip_block_threads() { return gcp::kCrOnThreads; }

// The on-chip CTAs resident at once for a launch of gcp_cr_policy_onchip
// (select 1, m columns of D) or gcp_cr_onchip (select 0, m = 0); negative
// (minus the cudaError_t) where it cannot launch.
int gcp_cr_onchip_resident(int dtype, int select, int n, int m) {
  if (select)
    return dtype == 0 ? gcp::cr_onchip_resident<float, true>(n, m)
                      : gcp::cr_onchip_resident<double, true>(n, m);
  return dtype == 0 ? gcp::cr_onchip_resident<float, false>(n, 0)
                    : gcp::cr_onchip_resident<double, false>(n, 0);
}

int gcp_smem_optin() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return limit;
}

// The cluster entry points: the arguments of gcp_cr_policy and gcp_cr; one
// draw a thread-block cluster (cudaErrorInvalidValue, without a launch,
// where gcp_cr_cluster_ctas is 0).
int gcp_cr_policy_cluster(int dtype, const void* A, const void* B,
                          const void* C, const void* D, void* T, void* R,
                          void* flags, int batch, int n, int m, int n_iter,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_cr_cluster<float, true>(A, B, C, D, T, R, flags,
                                               batch, n, m, n_iter, s);
  return gcp::launch_cr_cluster<double, true>(A, B, C, D, T, R, flags, batch,
                                              n, m, n_iter, s);
}

int gcp_cr_cluster(int dtype, const void* A, const void* B, const void* C,
                   void* T, void* flags, int batch, int n, int n_iter,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_cr_cluster<float, false>(A, B, C, nullptr, T, nullptr,
                                                flags, batch, n, 0, n_iter, s);
  return gcp::launch_cr_cluster<double, false>(A, B, C, nullptr, T, nullptr,
                                               flags, batch, n, 0, n_iter, s);
}

// CTAs a cluster of the cluster launch at (n, m) (m = 0: gcp_cr_cluster),
// 0 where none fits; rows a CTA; a CTA's shared memory.
int gcp_cr_cluster_ctas(int n, int m) { return gcp::cr_cluster_plan(n, m).ctas; }

int gcp_cr_cluster_rows(int n, int m) { return gcp::cr_cluster_plan(n, m).rows; }

size_t gcp_cr_cluster_smem_bytes(int n, int m) {
  return gcp::cr_cluster_plan(n, m).bytes;
}

// Clusters of that launch the device holds at once (select 1: K1 with m
// columns of D; 0: K4); negative (minus the cudaError_t) if the query fails,
// 0 where no plan fits.
int gcp_cr_cluster_resident(int dtype, int select, int n, int m) {
  const gcp::CrClusterPlan plan = gcp::cr_cluster_plan(n, select ? m : 0);
  if (plan.ctas == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (select)
    return dtype == 0 ? gcp::cr_cluster_config<float, true>(plan, cfg, attr, 0)
                      : gcp::cr_cluster_config<double, true>(plan, cfg, attr,
                                                             0);
  return dtype == 0 ? gcp::cr_cluster_config<float, false>(plan, cfg, attr, 0)
                    : gcp::cr_cluster_config<double, false>(plan, cfg, attr, 0);
}

#if GCP_CR_PROBE
// The probe's clocks (8 sums, see cr_tier_probe): set to 0, and read back.
int gcp_cr_tier_probe_reset() {
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(gcp::cr_tier_probe, zero, sizeof(zero));
}

int gcp_cr_tier_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, gcp::cr_tier_probe, 8 * sizeof(*out));
}
#endif

}  // extern "C"
