// Batched DARE settle (predictive covariance fixed point): four warps per
// draw, one draw a block, the products on the FP64 tensor cores; the
// draw's matrices in shared memory or, for larger states, in the shared
// memory of a cluster of CTAs a draw, or in device memory.
//
// Replaces the TPU kernel _dare_kernel (geconpy_tpu/ops/pallas_dare.py:37,
// reached through pallas_dare_settle).  For each draw, a fixed schedule:
// P = the unconditional covariance by lyap_iters Lyapunov doublings
// (P += A P A'; A = A A from A = T, P = RQR), then hewer_iters Hewer
// polishes, each
//   S = Z P Z' + H inverted by a pivoted Gauss-Jordan elimination,
//   Kp = T (P Z' S^{-1}),  A_cl = T - Kp Z,  Qc = sym(RQR + (Kp H) Kp'),
//   P = sym(Lyapunov doubling of (A_cl, Qc), inner_iters doublings),
// with sym(X) = (X + X') / 2.  Starting from the open-loop unconditional
// covariance matters: with H = 0 the DARE has several fixed points and the
// right one is the limit from there (geconpy_tpu/ops/kalman.py:287-294).
// The schedule has no early exit; the caller gates convergence outside the
// kernel with one Riccati step (dare_residual_settled).  The TPU wrapper
// pads the batch to whole lane tiles with H = I in the padded slots; here
// the grid is exactly one block per draw, so there is no padded slot.
//
// Precision: the kernel reads and writes the caller's dtype but runs the
// recursion in float64, as the settle kernels do: without measurement error
// S = Z P Z' is ill-conditioned on SW-2007.
//
// What bounds it on the H100.  On paper the operations: (lyap_iters +
// hewer_iters * inner_iters) * 3 n^3 multiply-adds per draw, ~7.4M at
// n = 26 with the default 12 + 8 * 16 schedule, on inputs of 2 n^2 + k n +
// k^2 values.  In fact the chain: 140 dependent doublings, each a few small
// products, and the warps of a draw issue about one instruction every ~5
// clocks.  An earlier design (one block of 256 threads per draw, one output
// entry per thread, two shared-memory loads per multiply-add on the FP64
// vector units, three block barriers a doubling, a block-wide elimination
// with three barriers a pivot) took 2.466 ms for 512 draws in float64,
// NVIDIA H100 80GB HBM3 at 700.00 W: ~17 us a doubling.  This design
// (small_linalg.cuh has the helpers and the tile layout):
//
//  * every product is tile_mm: mma.sync m16n8k4 in float64 on matrices
//    zero-padded to whole tiles, so that nothing tests a bound.  In the
//    doublings a warp takes 32 x 16 of the result at a time (kTall), so that
//    six shared-memory loads feed four mma, not eight: 0.492 against 0.535
//    ms with 16 x 16 items (same card and limit);
//  * a doubling takes two phases: A P and A A read the same A and go to
//    different buffers, so the four warps take both at once; P += (A P) A'
//    with the old A follows, then the doubling matrix changes buffers.  Two
//    block barriers a doubling, not three (tile_lyap_doubling, which the
//    settle kernels run in three phases for want of a fifth buffer);
//  * five n x n buffers (T, P, A and the doubling's two work buffers), Z
//    and H.  The Hewer step's n x k products, S and the elimination's
//    scratch live in the two work buffers, which the doubling does not use
//    then; RQR is read from device memory in the epilogue that adds it.  At
//    n = 26, k = 7 a draw takes 52,224 B of shared memory, so an SM holds
//    four draws and 512 draws run in one wave on 132 SMs;
//  * S^{-1} belongs to one warp (warp_solve_innovation: for k <= 8 a
//    Gauss-Jordan elimination in registers, a column per lane; above 8 in
//    shared memory), with the reference's pivot rule (first maximum, NaN
//    largest, ties to the lower row);
//  * A_cl = T - Kp Z and RQR + (Kp H) Kp' are epilogues of their products;
//    sym is a pass over the pairs (i, j), (j, i), in place: each pair is
//    summed once, so both entries get the reference's value.
//
// The large-state kernels.  Five n x n buffers of ceil32(n) rows exceed the
// 232,448 B a block may have from n = 65 on (k = 7), and the reference's
// kernel takes any n.  Two more tiers run the same schedule, chosen by size
// alone (ops/batched_dare.py::dare_tier):
//
//  * the cluster kernel (dare_cluster_kernel), where a draw split in 32-row
//    panels over a thread-block cluster of at most 8 CTAs fits their shared
//    memory (gcp_dare_cluster_fits).  What bounds the device-memory kernel
//    below is its operands' latency: 256 resident layouts of 568 KB at n =
//    104 are 3x the L2, and a draw's 140 doublings, ~960k clocks each, read
//    ~545 MB of its own buffers from HBM to four warps
//    (tools/tail_dare_variants.py DARE_PROBE=1, H100).  Here a draw is a
//    cluster (4 CTAs of 8 warps at n = 104, k = 7): each CTA holds its
//    rows of T, P, A and the two work buffers in shared memory, with Z and
//    H whole; no draw buffer lives in device memory.  A product's A operand
//    and result are the CTA's own rows, its B operand is read where its
//    rows are (cluster_mm, cluster_linalg.cuh; the doublings' with
//    kOneChain), so that every sum runs in the order of the other tiers and
//    their outputs are equal to the bit.  A doubling keeps its two phases
//    (A P and A A, then P += (A P) A') and takes two cluster barriers.  S =
//    Z P Z' + H, its elimination and S^{-1} belong to warp 0 of CTA 0, which
//    has every row of P Z' gathered into it and writes S^{-1} into every
//    peer; symmetrise sends each CTA's rows, transposed, to the CTAs that
//    own their columns, and after a cluster barrier each forms its rows
//    from the pairs.  The grid is persistent (as many clusters as
//    cudaOccupancyMaxActiveClusters allows, each striding over the batch);
//  * beyond that, the device-memory kernel (dare_large_kernel) runs the
//    same schedule on the same layout as the small-state kernel (dare_draw,
//    shared by both) with each block's buffers in a float64 workspace in
//    device memory; the products read their operands through L1 and L2.
//    Its grid is persistent too, so the workspace is one layout per
//    resident block whatever the batch: at 128 registers a thread, four an
//    SM, 528 x 568 KB at n = 104 on an H100.
// The wrapper picks the small-state kernel wherever one draw's layout fits
// (gcp_dare_fits), then the cluster kernel, then the device-memory one.
#include "cluster_linalg.cuh"

#ifndef GCP_DARE_PROBE
// 1: clocks per phase of the first draw (tools/tail_dare_variants.py
// DARE_PROBE=1), as thread 0 of the block that runs it sees them
#define GCP_DARE_PROBE 0
#endif

namespace gcp {

#if GCP_DARE_PROBE
// summed by phase, each phase ending with its barrier: 0 the inputs, 1 the
// Lyapunov start, 2 the Hewer step's products, 3 S and its elimination (one
// warp), 4 the inner doublings, 5 symmetrise, 6 the output, 7 (the cluster
// kernel) of all these, the clocks spent waiting at cluster barriers
constexpr int kDareProbes = 8;
__device__ unsigned long long dare_probe[kDareProbes];
#define DARE_MARK(slot)                                             \
  do {                                                              \
    if (probe) {                                                    \
      const unsigned long long now = clock64();                     \
      dare_probe[slot] += now - probe_t;                            \
      probe_t = now;                                                \
    }                                                               \
  } while (0)
#else
#define DARE_MARK(slot) do {} while (0)
#endif

constexpr int kDareWarps = 4;
constexpr int kDareThreads = 32 * kDareWarps;
constexpr int kDareMinBlocks = 4;   // draws an SM holds: 128 registers

// Offsets (in doubles) of one draw's shared memory, matrices in the tile
// layout; every size even, so that each buffer starts 16-byte aligned.
struct DareLayout {
  int ld, ldk, nr, kr;
  int T, P, A, Z, H, An, W, PZt, S, X, Kp, aug, col, row;
  int total;
  __host__ __device__ DareLayout(int n, int k) {
    nr = ceil32(n);   // stored rows: the doublings' 32-row items read them
    kr = ceil16(k);
    ld = tile_ld(n); ldk = tile_ld(k);
    int o = 0;
    T = o; o += nr * ld;
    P = o; o += nr * ld;
    A = o; o += nr * ld;    // the doubling matrix; A_cl
    Z = o; o += kr * ld;    // k x n
    H = o; o += kr * ldk;   // k x k
    // the doubling's work buffers An and W, and over them, during a Hewer
    // step, its n x k and k x k buffers and the elimination's scratch
    An = o;
    W = o + nr * ld;
    int s = o;
    PZt = s; s += nr * ldk;   // P Z'
    S = s; s += kr * ldk;     // S, then S^{-1}
    X = s; s += nr * ldk;     // P Z' S^{-1}, then Kp H
    Kp = s; s += nr * ldk;
    const int big = k > 8 ? 1 : 0;   // the shared-memory elimination
    aug = s; s += big * 2 * k * k;
    col = s; s += big * ceil8(k);
    row = s; s += big * ceil8(2 * k);
    total = s > o + 2 * nr * ld ? s : o + 2 * nr * ld;
  }
};

// P <- (P + P') / 2 over the logical entries, in place: one thread sums
// each pair once and writes both entries.
__device__ __forceinline__ void symmetrise(double* P, int n, int ld,
                                           int tid) {
  for (int e = tid; e < n * n; e += kDareThreads) {
    const int i = e / n, j = e - i * n;
    if (i <= j) {
      const double s = 0.5 * (P[i * ld + j] + P[j * ld + i]);
      P[i * ld + j] = s;
      P[j * ld + i] = s;
    }
  }
}

// One draw's whole schedule, its buffers at sm: shared memory in the
// small-state kernel, device memory in the large-state one (the same
// layout).  Every thread of the block takes part; the caller synchronises
// the block before sm is reused.
template <typename S>
__device__ __forceinline__ void dare_draw(
    const S* __restrict__ gT, const S* __restrict__ gRQR,
    const S* __restrict__ gZ, const S* __restrict__ gH, S* __restrict__ gP,
    const DareLayout& L, double* sm, size_t b, int n, int k, int lyap_iters,
    int hewer_iters, int inner_iters) {
  // the warp's number through a shuffle, so that the compiler knows it to
  // be the same in all lanes (no reconvergence code around the mma)
  const WarpCtx w{__shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0),
                  kDareWarps, (int)(threadIdx.x & 31)};
  const WarpCtx solo{0, 1, w.lane};
  const int tid = threadIdx.x;
  const int nn = n * n, kn = k * n;
  const int ld = L.ld, ldk = L.ldk;

  double* Tm = sm + L.T;
  double* P = sm + L.P;
  double* A = sm + L.A;
  double* Z = sm + L.Z;
  double* H = sm + L.H;
  double* An = sm + L.An;
  double* W = sm + L.W;
  double* PZt = sm + L.PZt;
  double* Sm = sm + L.S;
  double* X = sm + L.X;
  double* Kp = sm + L.Kp;
  const S* rqr = gRQR + b * nn;
  const S* no_g = nullptr;
  S* no_o = nullptr;
  auto sync = [] { __syncthreads(); };
#if GCP_DARE_PROBE
  const bool probe = b == 0 && tid == 0;
  unsigned long long probe_t = clock64();
#endif

  // ---- inputs, zero-padded: T, P = R Q R', Z, H.  Every other buffer is
  // written whole, pads included, before it is read.
  for (int e = tid; e < L.nr * ld; e += kDareThreads) {
    const int i = e / ld, j = e - i * ld;
    const bool in = i < n && j < n;
    Tm[e] = in ? double(gT[b * nn + i * n + j]) : 0.0;
    P[e] = in ? double(rqr[i * n + j]) : 0.0;
  }
  for (int e = tid; e < L.kr * ld; e += kDareThreads) {
    const int i = e / ld, j = e - i * ld;
    Z[e] = (i < k && j < n) ? double(gZ[b * kn + i * n + j]) : 0.0;
  }
  for (int e = tid; e < L.kr * ldk; e += kDareThreads) {
    const int i = e / ldk, j = e - i * ldk;
    H[e] = (i < k && j < k) ? double(gH[b * k * k + i * k + j]) : 0.0;
  }
  sync();
  DARE_MARK(0);

  // K = 0 start: the unconditional covariance of the stable transition
  tile_lyap_doubling<true>(Tm, P, A, An, W, n, ld, lyap_iters, w, sync);
  DARE_MARK(1);

  for (int h = 0; h < hewer_iters; ++h) {
    // PZt = P Z'
    tile_mm(tile_product(P, ld, Z, ld, true, n, n, k, PZt, ldk), no_g, 0,
            no_o, 0, w);
    sync();
    DARE_MARK(2);
    // one warp: S = Z PZt + H, then S^{-1} in its place
    if (w.warp == 0) {
      TileProduct s = tile_product(Z, ld, PZt, ldk, false, k, n, k, Sm, ldk);
      s.E = H;
      s.lde = ldk;
      tile_mm(s, no_g, 0, no_o, 0, solo);
      __syncwarp();
      double minpiv = INFINITY, logdet = 0.0;
      warp_solve_innovation<false>(Sm, ldk, nullptr, k, sm + L.aug,
                                   sm + L.col, sm + L.row, w.lane, minpiv,
                                   logdet);
    }
    sync();
    DARE_MARK(3);
    // X = PZt S^{-1}
    tile_mm(tile_product(PZt, ldk, Sm, ldk, false, n, k, k, X, ldk), no_g, 0,
            no_o, 0, w);
    sync();
    // Kp = T X
    tile_mm(tile_product(Tm, ld, X, ldk, false, n, n, k, Kp, ldk), no_g, 0,
            no_o, 0, w);
    sync();
    // A = A_cl = T - Kp Z;  X = Kp H
    TileProduct acl = tile_product(Kp, ldk, Z, ld, false, n, k, n, A, ld);
    acl.sign = -1.0;
    acl.E = Tm;
    acl.lde = ld;
    tile_mm(acl, no_g, 0, no_o, 0, w);
    tile_mm(tile_product(Kp, ldk, H, ldk, false, n, k, k, X, ldk), no_g, 0,
            no_o, 0, w);
    sync();
    // P = sym(RQR + (Kp H) Kp'), RQR added from device memory
    tile_mm(tile_product(X, ldk, Kp, ldk, true, n, k, n, P, ld), rqr, n, no_o,
            0, w);
    sync();
    DARE_MARK(2);
    symmetrise(P, n, ld, tid);
    sync();
    DARE_MARK(5);
    // P = sym(the Lyapunov doubling of (A_cl, Qc))
    tile_lyap_doubling<true>(A, P, A, An, W, n, ld, inner_iters, w, sync);
    DARE_MARK(4);
    symmetrise(P, n, ld, tid);
    sync();
    DARE_MARK(5);
  }
  for (int e = tid; e < nn; e += kDareThreads) {
    const int i = e / n, j = e - i * n;
    gP[b * nn + e] = S(P[i * ld + j]);
  }
  DARE_MARK(6);
}

// The small-state kernel: one draw a block, its buffers in shared memory.
template <typename S>
__global__ void __launch_bounds__(kDareThreads, kDareMinBlocks)
    dare_kernel(const S* __restrict__ gT, const S* __restrict__ gRQR,
                const S* __restrict__ gZ, const S* __restrict__ gH,
                S* __restrict__ gP, int n, int k, int lyap_iters,
                int hewer_iters, int inner_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DareLayout L(n, k);
  dare_draw(gT, gRQR, gZ, gH, gP, L, reinterpret_cast<double*>(smem_raw),
            blockIdx.x, n, k, lyap_iters, hewer_iters, inner_iters);
}

// The large-state kernel: the same schedule on the same layout, each
// block's buffers in a float64 workspace in device memory (gwork, L.total
// doubles a block) instead of shared memory.  The grid is persistent: as
// many blocks as are resident at once, each striding over the batch, so
// the workspace scales with the card, not with the batch.
template <typename S>
__global__ void __launch_bounds__(kDareThreads, kDareMinBlocks)
    dare_large_kernel(const S* __restrict__ gT, const S* __restrict__ gRQR,
                      const S* __restrict__ gZ, const S* __restrict__ gH,
                      S* __restrict__ gP, double* gwork, int batch, int n,
                      int k, int lyap_iters, int hewer_iters,
                      int inner_iters) {
  const DareLayout L(n, k);
  double* sm = gwork + (size_t)blockIdx.x * L.total;
  for (size_t b = blockIdx.x; b < (size_t)batch; b += gridDim.x) {
    dare_draw(gT, gRQR, gZ, gH, gP, L, sm, b, n, k, lyap_iters, hewer_iters,
              inner_iters);
    __syncthreads();   // P is written out before the next draw's inputs
  }
}

template <typename S>
int launch_dare(const void* T, const void* RQR, const void* Z, const void* H,
                void* P, int batch, int n, int k, int lyap_iters,
                int hewer_iters, int inner_iters, cudaStream_t stream) {
  const size_t bytes = (size_t)DareLayout(n, k).total * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      dare_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dare_kernel<S><<<batch, kDareThreads, bytes, stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(RQR),
      static_cast<const S*>(Z), static_cast<const S*>(H), static_cast<S*>(P),
      n, k, lyap_iters, hewer_iters, inner_iters);
  return (int)cudaGetLastError();
}

// The large-state launch: as many blocks as the card holds at once, at
// most one a draw, and the workspace they need.
struct DareLargePlan {
  int blocks;
  size_t work_bytes;
};

template <typename S>
DareLargePlan dare_large_plan(int n, int k, int batch) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dare_large_kernel<S>,
                                                kDareThreads, 0);
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  DareLargePlan p;
  p.blocks = batch < resident ? batch : resident;
  p.work_bytes = (size_t)p.blocks * DareLayout(n, k).total * sizeof(double);
  return p;
}

template <typename S>
int launch_dare_large(const void* T, const void* RQR, const void* Z,
                      const void* H, void* P, void* work, size_t work_bytes,
                      int batch, int n, int k, int lyap_iters,
                      int hewer_iters, int inner_iters, cudaStream_t stream) {
  const DareLargePlan plan = dare_large_plan<S>(n, k, batch);
  if (plan.blocks < 1) return 0;
  if (work == nullptr || work_bytes < plan.work_bytes)
    return (int)cudaErrorInvalidValue;
  dare_large_kernel<S><<<plan.blocks, kDareThreads, 0, stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(RQR),
      static_cast<const S*>(Z), static_cast<const S*>(H), static_cast<S*>(P),
      static_cast<double*>(work), batch, n, k, lyap_iters, hewer_iters,
      inner_iters);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The cluster kernel: one draw a thread-block cluster, its buffers in the
// shared memory of the cluster's CTAs (see the note at the top).
// ---------------------------------------------------------------------------

// 8 warps a CTA, as the cluster settle kernel has: at n = 104 a CTA's
// product has 7 work items of 32 x 16, so each warp takes at most one of a
// product (two in a doubling's first phase)
constexpr int kDareClusterWarps = 8;
constexpr int kDareClusterThreads = 32 * kDareClusterWarps;

// Offsets (in doubles) of one CTA's share of a draw in the cluster kernel:
// `rows` rows (a multiple of 32) of T, P, the doubling matrix A and the two
// work buffers Wa and Wp; Z and H whole.  During a Hewer step Wa holds
// this CTA's rows of P Z' (then K H), X and Kp, S (then S^{-1}) whole, the
// elimination's scratch and, in CTA 0, the whole of P Z' gathered from
// every CTA; Wp holds A P in a doubling and the partner entries in
// symmetrise.  Every size even, so that each buffer starts 16-byte aligned.
struct DareClusterLayout {
  int ld, ldk, nr, kr, k8, rows;
  int T, P, A, Wp, Z, H, Wa, PZt, S, X, Kp, aug, col, row, PZall;
  int total;
  __host__ __device__ DareClusterLayout(int n, int k, int panel) {
    nr = ceil16(n); kr = ceil16(k); k8 = ceil8(k);
    ld = tile_ld(n); ldk = tile_ld(k);
    rows = panel;
    int o = 0;
    T = o; o += rows * ld;
    P = o; o += rows * ld;
    A = o; o += rows * ld;
    Wp = o; o += rows * ld;
    Z = o; o += kr * ld;      // k x n
    H = o; o += kr * ldk;     // k x k
    Wa = o;
    int s = o;
    PZt = s; s += rows * ldk;   // P Z', then K H
    S = s; s += kr * ldk;       // S, then S^{-1}
    X = s; s += rows * ldk;     // P Z' S^{-1}
    Kp = s; s += rows * ldk;
    const int big = k > 8 ? 1 : 0;   // the shared-memory elimination
    aug = s; s += big * 2 * k * k;
    col = s; s += big * ceil8(k);
    row = s; s += big * ceil8(2 * k);
    PZall = s; s += nr * ldk;
    total = s > o + rows * ld ? s : o + rows * ld;
  }
};

// One draw's schedule on the cluster, dare_draw's on the row panels: CTA
// rank r holds rows r * rows .. of T, P, A and the work buffers; a
// product's A operand and result are the CTA's own rows and its B operand
// is read where its rows are (cluster_mm).  Every thread of every CTA of
// the cluster takes part.
template <typename S>
__device__ __forceinline__ void dare_cluster_draw(
    const S* __restrict__ gT, const S* __restrict__ gRQR,
    const S* __restrict__ gZ, const S* __restrict__ gH, S* __restrict__ gP,
    const DareClusterLayout& L, double* sm, const ClusterPart& cp, size_t b,
    int n, int k, int lyap_iters, int hewer_iters, int inner_iters,
    WarpCtx w) {
  const WarpCtx solo{0, 1, w.lane};
  const int tid = threadIdx.x;
  const int nn = n * n, kn = k * n;
  const int ld = L.ld, ldk = L.ldk;
  const int rows = cp.rows, row0 = cp.row0;
  double* Tm = sm + L.T;
  double* P = sm + L.P;
  double* A = sm + L.A;
  double* Wp = sm + L.Wp;
  double* Wa = sm + L.Wa;
  double* Z = sm + L.Z;
  double* H = sm + L.H;
  double* PZt = sm + L.PZt;
  double* KH = PZt;   // K H, once P Z' is dead
  double* Sm = sm + L.S;
  double* X = sm + L.X;
  double* Kp = sm + L.Kp;
  const S* rqr = gRQR + b * nn;
  const S* no_g = nullptr;
  S* no_o = nullptr;
#if GCP_DARE_PROBE
  const bool probe = b == 0 && cp.rank == 0 && tid == 0;
  unsigned long long probe_t = clock64();
  auto csync = [&] {
    const unsigned long long t0 = clock64();
    cluster_sync();
    if (probe) dare_probe[7] += clock64() - t0;
  };
#else
  auto csync = [] { cluster_sync(); };
#endif

  // ---- inputs: this CTA's rows of T and P = R Q R', Z and H whole, all
  // zero-padded.  Every other buffer is written whole, pads included,
  // before it is read.
  for (int e = tid; e < rows * ld; e += kDareClusterThreads) {
    const int il = e / ld, j = e - il * ld;
    const int i = row0 + il;
    const bool in = i < n && j < n;
    Tm[e] = in ? double(gT[b * nn + i * n + j]) : 0.0;
    P[e] = in ? double(rqr[i * n + j]) : 0.0;
  }
  for (int e = tid; e < L.kr * ld; e += kDareClusterThreads) {
    const int i = e / ld, j = e - i * ld;
    Z[e] = (i < k && j < n) ? double(gZ[b * kn + i * n + j]) : 0.0;
  }
  for (int e = tid; e < L.kr * ldk; e += kDareClusterThreads) {
    const int i = e / ldk, j = e - i * ldk;
    H[e] = (i < k && j < k) ? double(gH[b * k * k + i * k + j]) : 0.0;
  }
  csync();   // every CTA's panels are written before a peer reads them
  DARE_MARK(0);

  // `iters` Lyapunov doublings P += (A P) A'; A = A A from A = A0, the
  // doubling matrix alternating between A and Wa (tile_lyap_doubling's
  // two phases, with its order of the sums).  Two cluster barriers a
  // doubling: after the first phase, which reads the peers' rows of P,
  // before the second overwrites this CTA's; after the second, before the
  // next first phase reads the peers' new P and A and overwrites the
  // buffer of the old A, whose rows the peers read in the second phase.
  auto doubling = [&](const double* A0, int iters) {
    const double* Ac = A0;
    for (int it = 0; it < iters; ++it) {
      double* next = Ac == A ? Wa : A;
      cluster_mm<S, 2, true>(panel_product(cp, Ac, ld, P, ld, false, true, n,
                                           n, n, Wp, ld),
                             rows, no_g, 0, no_o, 0, w);
      cluster_mm<S, 2, true>(panel_product(cp, Ac, ld, Ac, ld, false, true, n,
                                           n, n, next, ld),
                             rows, no_g, 0, no_o, 0, w);
      csync();
      PanelProduct acc = panel_product(cp, Wp, ld, Ac, ld, true, true, n, n,
                                       n, P, ld);
      acc.E = P;
      acc.lde = ld;
      cluster_mm<S, 2, true>(acc, rows, no_g, 0, no_o, 0, w);
      csync();
      Ac = next;
    }
  };

  // P <- (P + P') / 2 across the cluster: each CTA writes its rows of P,
  // transposed, into the CTAs that own their columns (Wp there, which no
  // product uses meanwhile), and after a cluster barrier forms its own
  // rows from the partner entries it received.  Each entry is the sum of
  // the same pair as in symmetrise, so P stays exactly symmetric.  The
  // caller synchronises after.
  auto symmetrise_cluster = [&] {
    for (int e = tid; e < cp.rloc * n; e += kDareClusterThreads) {
      const int il = e / n, j = e - il * n;
      const int rk = j / rows;
      *peer(Wp + (j - rk * rows) * ld + row0 + il, rk) = P[il * ld + j];
    }
    csync();
    for (int e = tid; e < cp.rloc * n; e += kDareClusterThreads) {
      const int il = e / n, j = e - il * n;
      P[il * ld + j] = 0.5 * (P[il * ld + j] + Wp[il * ld + j]);
    }
  };

  // K = 0 start: the unconditional covariance of the stable transition
  doubling(Tm, lyap_iters);
  DARE_MARK(1);

  for (int h = 0; h < hewer_iters; ++h) {
    // PZt = P Z' (this CTA's rows), and the same rows into CTA 0's whole
    // copy of it
    cluster_mm<S>(panel_product(cp, P, ld, Z, ld, true, false, n, n, k, PZt,
                                ldk),
                  rows, no_g, 0, no_o, 0, w);
    __syncthreads();
    double* gather = peer(sm + L.PZall + row0 * ldk, 0);
    for (int e = tid; e < cp.nloc * ldk; e += kDareClusterThreads)
      gather[e] = PZt[e];
    csync();   // P Z' whole in CTA 0
    DARE_MARK(2);
    // warp 0 of CTA 0: S = Z PZt + H, S^{-1} in its place, and S^{-1} with
    // its zero pads into every peer
    if (cp.rank == 0 && w.warp == 0) {
      PanelProduct sp{Z, ld, sm + L.PZall, ldk, false, false, 0, k, k, n, k,
                      nullptr, 0, nullptr, 0, 0, 1.0, false, H, ldk, Sm, ldk};
      cluster_mm<S, 1>(sp, rows, no_g, 0, no_o, 0, solo);
      __syncwarp();
      double minpiv = INFINITY, logdet = 0.0;
      warp_solve_innovation<false>(Sm, ldk, nullptr, k, sm + L.aug,
                                   sm + L.col, sm + L.row, w.lane, minpiv,
                                   logdet);
      __syncwarp();
      for (int e = w.lane; e < L.k8 * L.k8; e += 32) {
        const int i = e / L.k8, j = e - i * L.k8;
        const double v = Sm[i * ldk + j];
        for (int r = 1; r < cp.ctas; ++r) *peer(Sm + i * ldk + j, r) = v;
      }
    }
    csync();   // S^{-1} in every CTA
    DARE_MARK(3);
    // X = PZt S^{-1}
    cluster_mm<S>(panel_product(cp, PZt, ldk, Sm, ldk, false, false, n, k, k,
                                X, ldk),
                  rows, no_g, 0, no_o, 0, w);
    csync();   // T X reads the peers' rows of X
    // Kp = T X
    cluster_mm<S>(panel_product(cp, Tm, ld, X, ldk, false, true, n, n, k, Kp,
                                ldk),
                  rows, no_g, 0, no_o, 0, w);
    csync();   // (Kp H) Kp' reads the peers' rows of Kp
    // A = A_cl = T - Kp Z;  KH = Kp H
    PanelProduct acl = panel_product(cp, Kp, ldk, Z, ld, false, false, n, k,
                                     n, A, ld);
    acl.sign = -1.0;
    acl.E = Tm;
    acl.lde = ld;
    cluster_mm<S>(acl, rows, no_g, 0, no_o, 0, w);
    cluster_mm<S>(panel_product(cp, Kp, ldk, H, ldk, false, false, n, k, k,
                                KH, ldk),
                  rows, no_g, 0, no_o, 0, w);
    __syncthreads();
    // P = RQR + (Kp H) Kp', RQR added from device memory
    cluster_mm<S>(panel_product(cp, KH, ldk, Kp, ldk, true, true, n, k, n, P,
                                ld),
                  rows, rqr, n, no_o, 0, w);
    __syncthreads();
    DARE_MARK(2);
    symmetrise_cluster();
    csync();   // the doubling reads the peers' rows of the new P
    DARE_MARK(5);
    // P = sym(the Lyapunov doubling of (A_cl, Qc))
    doubling(A, inner_iters);
    DARE_MARK(4);
    symmetrise_cluster();
    __syncthreads();   // P Z' reads this CTA's rows alone
    DARE_MARK(5);
  }
  for (int e = tid; e < cp.rloc * n; e += kDareClusterThreads) {
    const int il = e / n, j = e - il * n;
    gP[b * nn + (size_t)(row0 + il) * n + j] = S(P[il * ld + j]);
  }
  DARE_MARK(6);
}

// The cluster kernel: a cluster of ctas CTAs a draw, CTA r holding the r-th
// panel of `rows` rows.  The grid is persistent (as many clusters as are
// resident, each striding over the batch).  From one draw to the next no
// barrier is needed: after the last symmetrise's cluster barrier no CTA
// reads or writes a peer's shared memory until the next draw's inputs are
// in, which a cluster barrier ends.
template <typename S>
__global__ void __launch_bounds__(kDareClusterThreads, 1)
    dare_cluster_kernel(const S* __restrict__ gT, const S* __restrict__ gRQR,
                        const S* __restrict__ gZ, const S* __restrict__ gH,
                        S* __restrict__ gP, int batch, int n, int k,
                        int lyap_iters, int hewer_iters, int inner_iters,
                        int ctas, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DareClusterLayout L(n, k, rows);
  // the warp's number and the CTA's rank through a shuffle, so that the
  // compiler knows them (and every branch on them) to be warp-uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int rank = __shfl_sync(0xffffffffu, (int)cluster_ctarank(), 0);
  const WarpCtx w{warp, kDareClusterWarps, (int)(threadIdx.x & 31)};
  ClusterPart cp;
  cp.rank = rank;
  cp.ctas = ctas;
  cp.rows = rows;
  cp.row0 = rank * rows;
  cp.nloc = L.nr - cp.row0 < rows ? L.nr - cp.row0 : rows;
  cp.rloc = n - cp.row0 < rows ? n - cp.row0 : rows;
  double* sm = reinterpret_cast<double*>(smem_raw);
  const size_t clusters = gridDim.x / ctas;
  for (size_t b = blockIdx.x / ctas; b < (size_t)batch; b += clusters)
    dare_cluster_draw(gT, gRQR, gZ, gH, gP, L, sm, cp, b, n, k, lyap_iters,
                      hewer_iters, inner_iters, w);
  cluster_sync();   // no CTA leaves while a peer may still address it
}

// How a cluster launch is cut: CTAs a cluster, rows a CTA, and the dynamic
// shared memory of a CTA.  The fewest CTAs (from 2) whose share fits the
// device's shared memory a block; ctas 0 if none up to kClusterMaxCtas
// does.
struct DareClusterPlan {
  int ctas, rows;
  size_t bytes;
};

inline DareClusterPlan dare_cluster_plan(int n, int k) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int tiles = ceil16(n) / 16;
  for (int c = 2; c <= kClusterMaxCtas; ++c) {
    // row tiles a CTA: a whole number of cluster_mm's 32-row items
    const int per = 2 * ((tiles + 2 * c - 1) / (2 * c));
    const size_t share =
        (size_t)DareClusterLayout(n, k, 16 * per).total * sizeof(double);
    if (share > (size_t)limit) continue;
    return DareClusterPlan{(tiles + per - 1) / per, 16 * per, share};
  }
  return DareClusterPlan{0, 0, 0};
}

// The launch configuration of a plan (cluster dimension in attr), and the
// clusters of it the device holds at once (0 if it holds none; the CUDA
// error of the query, negated, if the query fails).
template <typename S>
int dare_cluster_config(const DareClusterPlan& plan, cudaLaunchConfig_t& cfg,
                        cudaLaunchAttribute& attr, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dare_cluster_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)plan.bytes);
  if (err != cudaSuccess) return -(int)err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(plan.ctas, 1, 1);
  cfg.blockDim = dim3(kDareClusterThreads, 1, 1);
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
      &clusters, (const void*)dare_cluster_kernel<S>, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters;
}

template <typename S>
int launch_dare_cluster(const void* T, const void* RQR, const void* Z,
                        const void* H, void* P, int batch, int n, int k,
                        int lyap_iters, int hewer_iters, int inner_iters,
                        cudaStream_t stream) {
  const DareClusterPlan plan = dare_cluster_plan(n, k);
  if (plan.ctas == 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = dare_cluster_config<S>(plan, cfg, attr, stream);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return (int)cudaErrorLaunchOutOfResources;
  if (batch < clusters) clusters = batch;
  cfg.gridDim = dim3(clusters * plan.ctas, 1, 1);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dare_cluster_kernel<S>, static_cast<const S*>(T),
      static_cast<const S*>(RQR), static_cast<const S*>(Z),
      static_cast<const S*>(H), static_cast<S*>(P), batch, n, k, lyap_iters,
      hewer_iters, inner_iters, plan.ctas, plan.rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace gcp

extern "C" {

// dtype: 0 = float32, 1 = float64.  Returns the cudaError_t of the launch.
int gcp_dare(int dtype, const void* T, const void* RQR, const void* Z,
             const void* H, void* P, int batch, int n, int k, int lyap_iters,
             int hewer_iters, int inner_iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_dare<float>(T, RQR, Z, H, P, batch, n, k, lyap_iters,
                                   hewer_iters, inner_iters, s);
  return gcp::launch_dare<double>(T, RQR, Z, H, P, batch, n, k, lyap_iters,
                                  hewer_iters, inner_iters, s);
}

// Shared memory per block (one draw); the recursion is float64 for either
// I/O type.
size_t gcp_dare_smem_bytes(int n, int k) {
  return (size_t)gcp::DareLayout(n, k).total * sizeof(double);
}

// Threads per block (one draw).
int gcp_dare_block_threads(void) { return gcp::kDareThreads; }

// The large-state entry point: gcp_dare's arguments plus a float64
// workspace of work_bytes >= gcp_dare_large_work_bytes(...) in device
// memory (cudaErrorInvalidValue, without a launch, if it is smaller).
int gcp_dare_large(int dtype, const void* T, const void* RQR, const void* Z,
                   const void* H, void* P, void* work, size_t work_bytes,
                   int batch, int n, int k, int lyap_iters, int hewer_iters,
                   int inner_iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_dare_large<float>(T, RQR, Z, H, P, work, work_bytes,
                                         batch, n, k, lyap_iters, hewer_iters,
                                         inner_iters, s);
  return gcp::launch_dare_large<double>(T, RQR, Z, H, P, work, work_bytes,
                                        batch, n, k, lyap_iters, hewer_iters,
                                        inner_iters, s);
}

// Whether one draw's layout fits the device's shared memory (then gcp_dare
// runs; else gcp_dare_large).
int gcp_dare_fits(int n, int k) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return gcp_dare_smem_bytes(n, k) <= (size_t)limit;
}

// The workspace the large-state launch needs for this batch.
size_t gcp_dare_large_work_bytes(int dtype, int n, int k, int batch) {
  return dtype == 0 ? gcp::dare_large_plan<float>(n, k, batch).work_bytes
                    : gcp::dare_large_plan<double>(n, k, batch).work_bytes;
}

// The cluster entry point: gcp_dare's arguments; each draw runs on a
// cluster of CTAs with its buffers in their shared memory
// (cudaErrorInvalidValue, without a launch, where the plan does not fit:
// gcp_dare_cluster_fits).
int gcp_dare_cluster(int dtype, const void* T, const void* RQR,
                     const void* Z, const void* H, void* P, int batch, int n,
                     int k, int lyap_iters, int hewer_iters, int inner_iters,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_dare_cluster<float>(T, RQR, Z, H, P, batch, n, k,
                                           lyap_iters, hewer_iters,
                                           inner_iters, s);
  return gcp::launch_dare_cluster<double>(T, RQR, Z, H, P, batch, n, k,
                                          lyap_iters, hewer_iters,
                                          inner_iters, s);
}

// CTAs a cluster of the cluster plan for n states and k observables (0: it
// does not fit, and the wrapper takes the device-memory kernel), and the
// dynamic shared memory of one of its CTAs; the recursion is float64 for
// either I/O type.
int gcp_dare_cluster_ctas(int n, int k) {
  return gcp::dare_cluster_plan(n, k).ctas;
}

int gcp_dare_cluster_fits(int n, int k) {
  return gcp_dare_cluster_ctas(n, k) > 0;
}

size_t gcp_dare_cluster_smem_bytes(int n, int k) {
  return gcp::dare_cluster_plan(n, k).bytes;
}

// Clusters of that plan the device holds at once, the draws its persistent
// grid runs side by side; 0 where the plan does not fit, minus the CUDA
// error where the query fails.
int gcp_dare_cluster_resident(int dtype, int n, int k) {
  const gcp::DareClusterPlan plan = gcp::dare_cluster_plan(n, k);
  if (plan.ctas == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  return dtype == 0 ? gcp::dare_cluster_config<float>(plan, cfg, attr, 0)
                    : gcp::dare_cluster_config<double>(plan, cfg, attr, 0);
}

// Threads of a CTA of the cluster kernel.
int gcp_dare_cluster_block_threads() { return gcp::kDareClusterThreads; }

#if GCP_DARE_PROBE
// The probe's clocks (kDareProbes sums, see dare_probe): set to 0, and read
// back.
int gcp_dare_probe_reset() {
  const unsigned long long zero[gcp::kDareProbes] = {};
  return (int)cudaMemcpyToSymbol(gcp::dare_probe, zero, sizeof(zero));
}

int gcp_dare_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, gcp::dare_probe,
                                   gcp::kDareProbes * sizeof(*out));
}
#endif

}  // extern "C"
