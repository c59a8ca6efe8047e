// Batched Kalman settle phase: four warps per draw, several draws per block,
// the matrix products on the FP64 tensor cores; the draws' matrices in
// shared memory or, for larger states, in the shared memory of a cluster of
// CTAs a draw, or in device memory.
//
// Replaces the TPU kernel _settle_kernel (geconpy_tpu/ops/pallas_settle.py
// :40, reached through pallas_settle_parts).  For each draw: P0 by
// lyap_iters Lyapunov doublings (P += A P A'; A = A A); n_settle exact
// Riccati steps on the shared observations y_head (Joseph-form covariance
// update, per-step log-likelihood with log det F from the Gauss-Jordan
// pivots); then the frozen-gain quantities of the constant-gain tail:
// M = T - T K Z, TK = T K, F^{-1}, const = -(k log 2pi + log det F) / 2 and
// the predicted state x_pred0 = T x.
//
// The same body, compiled with kFused, is the fused settle + tail kernel: it
// replaces the TPU kernel _fused_kernel (geconpy_tpu/ops/pallas_settle.py
// :108, reached through pallas_settle_filter_loglik).  Instead of writing the
// frozen-gain quantities to device memory it leaves them in shared memory (M
// in a work buffer, TK in that of K H, x_pred0 in that of x_pred) and the
// draw's warps run the constant-gain tail over the rest of the sample: per
// draw the kernel reads its six inputs once and writes one number.  Its tail
// runs in float64 like the settle, straight from the float64 M, TK, F^{-1},
// const and x_pred0; with float32 I/O its result is therefore not bitwise
// that of the settle kernel followed by the tail kernel, which round those
// five to float32 in between.
//
// Precision: the kernel reads and writes the caller's dtype but runs the
// whole recursion in float64.  Without measurement error the innovation
// covariance F of SW-2007 is ill-conditioned (|F^{-1}| up to ~7.5e4), and a
// float32 recursion moved ll_head by up to 2.7e-3 relative between two
// float32 implementations (H100 run); float64 removes that sensitivity.
//
// What bounds it on the H100.  On paper the operations: (lyap_iters * 3 +
// n_settle * 4 + 2) n^3 multiply-adds per draw, ~3.5 MFMA at n = 26, k = 7,
// on inputs of 2 n^2 + k n + k^2 + k values.  In fact the chain: ~290
// dependent steps per draw (8 per Riccati step), each a small product or a
// k-sized elimination, and a warp that walks such a chain alone starts an
// instruction every ~5 clocks.  An earlier design (one block of 256 threads
// per draw, one output entry per thread, two shared-memory loads per
// multiply-add, three block barriers per pivot of the elimination) was bound
// by shared-memory traffic instead: 9.83 ms (settle) and 12.25 ms (fused) for
// 4096 draws, float32 I/O, NVIDIA H100 80GB HBM3 at 700.00 W.  What this
// design does (its times are in PERF.md; chip_smoke.py measures them):
//
//  * every n x n x n, n x n x k and n x k x n product is tile_mm
//    (small_linalg.cuh): mma.sync m16n8k4 in float64 (m8n8k4 starts no faster
//    and so reaches half the rate), a warp per 16 x 16 tile of the result,
//    the sums in registers, 8 shared loads per 2,048 multiply-adds.  Matrices
//    are kept zero-padded to whole tiles, with a leading dimension that makes
//    operand loads free of bank conflicts, so that no load, mma or store
//    tests a bound: at these sizes an index or a mask costs as much as an
//    mma.  The epilogues (+ R Q R', I - K Z, the Joseph sum + K H K',
//    T - T K Z) work on the accumulators;
//  * a draw is four warps that synchronise through a named barrier of their
//    own (8 per Riccati step); a block holds several draws that never wait
//    for each other, and a batch that does not fill the last block is
//    guarded in the kernel.  The warp's number is made known to the compiler
//    as uniform, or every mma is wrapped in reconvergence code;
//  * F = Z P_pred Z' + H, its elimination, v' F^{-1} v and the
//    log-likelihood belong to one warp (warp_solve_innovation: for k <= 8 a
//    Gauss-Jordan elimination in registers, a column per lane, shuffles and
//    no barrier); the vectors x_pred, v, x ride on steps that exist anyway
//    (tile_mv);
//  * R Q R' is only ever added in an epilogue and is read there from device
//    memory (L2), three work buffers rotate through the roles of P, T P,
//    P_pred, I - K Z and (I - K Z) P_pred, and K H shares the buffer of
//    P_pred Z': four n x n buffers per draw, 51,520 B at n = 26, k = 7, so
//    that an SM holds four draws;
//  * the whole of y goes to shared memory once per block (cp.async, waited
//    for after the Lyapunov start), where the head and the fused tail read
//    it; a sample too long for that is read from device memory instead;
//  * in the fused tail every warp advances its rows of the state, with one
//    draw barrier per step; the innovation, its quadratic form and y_t - d
//    are each another warp's side job, one step ahead or behind, so that no
//    warp waits for them.
//
// The large-state kernels.  A draw's four n x n buffers need 4 ceil16(n)
// (ceil8(n) + 4) doubles; from n = 65 (K5 with 200 periods of y beside the
// draw) or 73 (K2 with 32), k = 7, float64, one draw no longer fits the
// 232,448 B a block may have, and the reference's kernels, which size
// their VMEM block by the batch tile, take any n.  Two more tiers run the
// same schedule on the same buffers (settle_start / settle_finish, or their
// cluster twins), chosen by size alone (the wrappers in
// ops/batched_settle.py):
//
//  * the cluster kernel (settle_cluster_kernel), where a draw split in
//    32-row panels over a thread-block cluster of at most 8 CTAs fits their
//    shared memory (gcp_settle_cluster_fits: n <= ~168 at k = 7).  What
//    bounds the device-memory kernel below is its operands' latency: 528
//    resident draws of 427 KB at n = 104 are 4.5x the L2, so every
//    tile_mm operand of the ~8 dependent products of a Riccati step comes
//    from HBM, four warps a draw.  Here a draw is a cluster (4 CTAs of 8
//    warps at n = 104): each CTA holds its rows of T, P, the three work
//    buffers, PZt and K in shared memory, with Z, H, F^{-1}, x and x_pred
//    whole; no draw buffer lives in device memory.  A product's A operand
//    and result are the CTA's own rows; its B operand is read where its
//    rows are, a peer's through distributed shared memory (generic loads
//    of mapa addresses; a staging ring of bulk copies needs a panel or two
//    of every B operand beside the share, and so larger clusters, and is
//    not built).  A work item is 32 rows x 16 columns, so each remote
//    operand feeds two row tiles and each CTA reads each B once a product;
//    the sums run in tile_mm's order, as in the other tiers: on SW-2007's
//    own inputs the two large tiers' outputs are equal to the bit (phase
//    16c of chip_smoke.py prints their largest difference).
//    Barriers: a cluster
//    barrier only where a product reads a peer's rows or overwrites rows a
//    peer reads (four a Riccati step, two a doubling, one a tail step), a
//    CTA barrier elsewhere.  F, its elimination and the log-likelihood stay
//    with one warp of CTA 0, which has the whole of PZt gathered into it
//    (each CTA writes its rows there) and writes F^{-1} into every peer;
//    in the fused tail each CTA writes its rows of the next state into
//    every peer.  What bounds it then (tools/settle_variants.py PROBE=1,
//    n = 104, H100): the products' remote operands, at ~10-40k clocks a
//    product where the FP64 tensor cores need ~6k, worst where every CTA
//    walks the same peer's rows at once (T P: each CTA starting at its own
//    rows took 14% off a draw in a trial build, but changes the order of
//    the sums), and a cluster barrier, ~4k clocks, which makes the 168 tail
//    steps a fifth of a K5 draw.  The grid is
//    persistent (as many clusters as cudaOccupancyMaxActiveClusters
//    allows, each striding over the batch);
//  * beyond that, the large-state kernel (settle_large_kernel), each
//    draw's buffers in a float64 workspace in device memory; shared memory
//    holds y alone.  The products read their operands through L1 and L2, so
//    what bounds it is the operand traffic of tile_mm (eight 8-byte loads a
//    lane per 2,048 multiply-adds).  Its grid is persistent too (each draw
//    slot striding over the batch), so the workspace is the card's resident
//    draws times one layout, not the batch's: at 128 registers a thread,
//    two blocks of two draws an SM, 528 draws x 427 KB at n = 104 on an
//    H100.
#include <type_traits>

#include "cluster_linalg.cuh"

#ifndef GCP_SETTLE_DRAWS
#define GCP_SETTLE_DRAWS 2   // draws per block (fewer if shared memory is short)
#endif
#ifndef GCP_SETTLE_MIN_BLOCKS
#define GCP_SETTLE_MIN_BLOCKS 2   // resident blocks per SM the registers allow
#endif

namespace gcp {

constexpr int kSettleWarps = 4;                 // warps per draw
constexpr int kSettleThreads = 32 * kSettleWarps;
constexpr size_t kSettleMaxYBytes = 48 * 1024;  // y is staged up to this size

// Offsets (in doubles) of one draw's shared memory; matrices in the tile
// layout of small_linalg.cuh, every size even so that each buffer starts
// 16-byte aligned.  With `panel` > 0 the layout is one CTA's share of a
// draw in the cluster kernel: T, the work buffers, PZt and K hold `panel`
// rows of the draw (the CTA's rows); the rest is whole.
struct SettleLayout {
  int ld, ldk, nr, kr, n8, k8, rows;
  int T, W, Z, PZt, K, H, Finv, x, xp, dv, v, yd, v2, yd2, aug, col, row,
      PZall;
  int total;
  __host__ __device__ SettleLayout(int n, int k, int panel = 0) {
    nr = ceil16(n); kr = ceil16(k);   // stored rows
    n8 = ceil8(n); k8 = ceil8(k);     // stored vector lengths
    ld = tile_ld(n); ldk = tile_ld(k);
    rows = panel > 0 ? panel : nr;    // stored rows of T, W, PZt, K
    int o = 0;
    T = o; o += rows * ld;
    W = o; o += 3 * rows * ld;      // three rotating n x n work buffers
    Z = o; o += kr * ld;            // k x n
    PZt = o; o += rows * ldk;       // n x k; K H and T K once it is dead
    K = o; o += rows * ldk;
    H = o; o += kr * ldk;           // k x k
    Finv = o; o += kr * ldk;        // F, then F^{-1}
    x = o; o += n8;
    xp = o; o += n8;
    dv = o; o += k8;
    v = o; o += k8;
    yd = o; o += k8;
    v2 = o; o += k8;                // second buffers of v and y - d (tail)
    yd2 = o; o += k8;
    // scratch of the shared-memory elimination, for k > 8 only
    const int big = k > 8 ? 1 : 0;
    aug = o; o += big * ((k * (2 * k + 1) + 1) & ~1);
    col = o; o += big * k8;
    row = o; o += big * (2 * k8 + 2);
    // the cluster kernel's whole PZt, gathered in CTA 0 for F
    PZall = o; o += panel > 0 ? nr * ldk : 0;
    total = o;
  }
};

// How a launch is cut: draws per block, whether y is staged in shared
// memory, and the dynamic shared memory of a block.
struct SettlePlan {
  int draws;
  int y_in_smem;
  size_t bytes;
};

inline SettlePlan settle_plan(int n, int k, int n_obs, size_t elt) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t per_draw = (size_t)SettleLayout(n, k).total * sizeof(double);
  const size_t ybytes = (((size_t)n_obs * k * elt) + 15) & ~(size_t)15;
  SettlePlan p;
  p.y_in_smem = ybytes <= kSettleMaxYBytes;
  const size_t ys = p.y_in_smem ? ybytes : 0;
  p.draws = GCP_SETTLE_DRAWS;
  while (p.draws > 1 && p.draws * per_draw + ys > (size_t)limit) --p.draws;
  p.bytes = p.draws * per_draw + ys;
  return p;
}

// Barrier over the kSettleThreads threads of one draw (ids 1..draws; 0 is
// __syncthreads()).
__device__ __forceinline__ void draw_barrier(int draw) {
  asm volatile("bar.sync %0, %1;" ::"r"(draw + 1), "r"(kSettleThreads)
               : "memory");
}

template <typename S>
__device__ __forceinline__ void cp_async_elem(S* dst, const S* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
               "n"(sizeof(S))
               : "memory");
}

// One draw's buffers in its workspace: shared memory in the small-state
// kernel, device memory in the large-state one (the same layout); one
// CTA's share of them in the cluster kernel.
struct SettleBufs {
  double *T, *Wa, *Wb, *Wc, *Z, *PZt, *K, *H, *Finv, *x, *xp, *dv, *v, *yd,
      *v2, *yd2, *aug, *col, *row, *PZall;
  __device__ __forceinline__ SettleBufs(double* sm, const SettleLayout& L)
      : T(sm + L.T), Wa(sm + L.W), Wb(sm + L.W + L.rows * L.ld),
        Wc(sm + L.W + 2 * L.rows * L.ld), Z(sm + L.Z), PZt(sm + L.PZt),
        K(sm + L.K), H(sm + L.H), Finv(sm + L.Finv), x(sm + L.x),
        xp(sm + L.xp), dv(sm + L.dv), v(sm + L.v), yd(sm + L.yd),
        v2(sm + L.v2), yd2(sm + L.yd2), aug(sm + L.aug), col(sm + L.col),
        row(sm + L.row), PZall(sm + L.PZall) {}
};

// y to shared memory, asynchronously, for every draw of the block (the
// caller waits with cp.async.wait_all and a block barrier); returns where
// the draws read y from.
template <typename S>
__device__ __forceinline__ const S* stage_y(const S* gy, void* dst,
                                            int n_elems, int y_in_smem) {
  if (!y_in_smem) return gy;
  S* sy = reinterpret_cast<S*>(dst);
  for (int e = threadIdx.x; e < n_elems; e += blockDim.x)
    cp_async_elem(sy + e, gy + e);
  return sy;
}

// The draw's inputs, zero-padded (T, P = R Q R', Z, H, d; x = 0), and P0 by
// the Lyapunov doubling.  Every other buffer is written whole, pads
// included, before it is read.
template <typename S>
__device__ __forceinline__ void settle_start(
    const S* __restrict__ gT, const S* __restrict__ gRQR,
    const S* __restrict__ gZ, const S* __restrict__ gH,
    const S* __restrict__ gd, const SettleLayout& L, const SettleBufs& bf,
    size_t b, int n, int k, int lyap_iters, WarpCtx w, int draw) {
  const int dt = w.warp * 32 + w.lane;   // thread of the draw
  const int nn = n * n, kn = k * n;
  const int ld = L.ld, ldk = L.ldk;
  const S* rqr = gRQR + b * nn;
  for (int e = dt; e < L.nr * ld; e += kSettleThreads) {
    const int i = e / ld, j = e - i * ld;
    const bool in = i < n && j < n;
    bf.T[e] = in ? double(gT[b * nn + i * n + j]) : 0.0;
    bf.Wa[e] = in ? double(rqr[i * n + j]) : 0.0;
  }
  for (int e = dt; e < L.kr * ld; e += kSettleThreads) {
    const int i = e / ld, j = e - i * ld;
    bf.Z[e] = (i < k && j < n) ? double(gZ[b * kn + i * n + j]) : 0.0;
  }
  for (int e = dt; e < L.kr * ldk; e += kSettleThreads) {
    const int i = e / ldk, j = e - i * ldk;
    bf.H[e] = (i < k && j < k) ? double(gH[b * k * k + i * k + j]) : 0.0;
  }
  for (int i = dt; i < L.k8; i += kSettleThreads)
    bf.dv[i] = i < k ? double(gd[b * k + i]) : 0.0;
  for (int i = dt; i < L.n8; i += kSettleThreads) bf.x[i] = 0.0;
  draw_barrier(draw);

  // ---- P0: discrete Lyapunov by doubling.  P stays in Wa; the doubling
  // matrix A starts as T itself and then alternates between Wb and Wc,
  // three phases a doubling (no fifth buffer)
  tile_lyap_doubling(bf.T, bf.Wa, bf.Wb, bf.Wc, nullptr, n, ld, lyap_iters, w,
                     [&] { draw_barrier(draw); });
}

// The rest of a draw once P0 is in Wa and y is readable at ysrc: the
// n_settle Riccati steps, the frozen-gain quantities and, with kFused, the
// constant-gain tail.
template <typename S, bool kFused>
__device__ __forceinline__ void settle_finish(
    const S* __restrict__ gRQR, S* __restrict__ gll, S* __restrict__ gxp,
    S* __restrict__ gM, S* __restrict__ gTK, S* __restrict__ gFinv,
    S* __restrict__ gconst, const SettleLayout& L, const SettleBufs& bf,
    const S* ysrc, size_t b, int n, int k, int n_settle, int n_total,
    WarpCtx w, int draw) {
  const WarpCtx solo{0, 1, w.lane};
  const int dt = w.warp * 32 + w.lane;   // thread of the draw
  const int lane = w.lane;
  const int nn = n * n, kn = k * n;
  const int ld = L.ld, ldk = L.ldk;
  double* Tm = bf.T;
  double* Z = bf.Z;
  double* PZt = bf.PZt;
  double* KH = PZt;   // K H, and T K at the end, once P_pred Z' is dead
  double* K = bf.K;
  double* H = bf.H;
  double* Finv = bf.Finv;
  double* x = bf.x;
  double* xp = bf.xp;
  double* dv = bf.dv;
  double* v = bf.v;
  double* yd = bf.yd;
  const S* no_g = nullptr;
  S* no_o = nullptr;
  const S* rqr = gRQR + b * nn;

  double* P = bf.Wa;     // the covariance
  double* B1 = bf.Wb;    // T P, then I - K Z
  double* B2 = bf.Wc;    // P_pred, then the new covariance
  // owned by warp 0 of the draw, the same value in every lane
  double ll = 0.0, minpiv = INFINITY, logdet = 0.0;

  // P_pred = T P T' + R Q R' into B2 (through B1); the caller's
  // matrix-vector product rides on the first of the two products
  auto predict = [&](auto&& first_step_extra) {
    tile_mm(tile_product(Tm, ld, P, ld, false, n, n, n, B1, ld), no_g, 0,
            no_o, 0, w);
    first_step_extra();
    draw_barrier(draw);
    tile_mm(tile_product(B1, ld, Tm, ld, true, n, n, n, B2, ld), rqr, n,
            no_o, 0, w);
  };

  // one warp: F = Z PZt + H into the buffer of F^{-1}, then the elimination
  // of [F | v | I] (or [F | I]) there; returns v' F^{-1} v
  auto solve_innovation = [&](auto with_v) {
    TileProduct f = tile_product(Z, ld, PZt, ldk, false, k, n, k, Finv, ldk);
    f.E = H;
    f.lde = ldk;
    tile_mm(f, no_g, 0, no_o, 0, solo);
    __syncwarp();
    minpiv = INFINITY;
    logdet = 0.0;
    return warp_solve_innovation<decltype(with_v)::value>(
        Finv, ldk, v, k, bf.aug, bf.col, bf.row, lane, minpiv, logdet);
  };

  // ---- n_settle exact Riccati steps
  for (int t = 0; t < n_settle; ++t) {
    const S* yt = ysrc + (size_t)t * k;
    // B1 = T P;  x_pred = T x;  then P_pred = B1 T' + R Q R' (B2)
    predict([&] {
      tile_mv(Tm, ld, x, n, n, nullptr, 0, nullptr, 0, w,
              [&](int i, double s) { xp[i] = s; });
    });
    draw_barrier(draw);
    // PZt = P_pred Z';  v = y_t - Z x_pred - d
    tile_mm(tile_product(B2, ld, Z, ld, true, n, n, k, PZt, ldk), no_g, 0,
            no_o, 0, w);
    tile_mv(Z, ld, xp, k, n, nullptr, 0, nullptr, 0, w,
            [&](int i, double s) {
              v[i] = i < k ? (double(yt[i]) - s) - dv[i] : 0.0;
            });
    draw_barrier(draw);
    // F^{-1}, v' F^{-1} v and the log-likelihood
    if (w.warp == 0) {
      const double q = solve_innovation(std::true_type{});
      ll = ll - 0.5 * ((double(k) * kLog2Pi + logdet) + q);
    }
    draw_barrier(draw);
    // K = PZt F^{-1}
    tile_mm(tile_product(PZt, ldk, Finv, ldk, false, n, k, k, K, ldk), no_g, 0,
            no_o, 0, w);
    draw_barrier(draw);
    // B1 = I - K Z;  KH = K H;  x = x_pred + K v
    TileProduct ikz = tile_product(K, ldk, Z, ld, false, n, k, n, B1, ld);
    ikz.sign = -1.0;
    ikz.eye = true;
    tile_mm(ikz, no_g, 0, no_o, 0, w);
    tile_mm(tile_product(K, ldk, H, ldk, false, n, k, k, KH, ldk), no_g, 0,
            no_o, 0, w);
    tile_mv(K, ldk, v, n, k, nullptr, 0, nullptr, 0, w,
            [&](int i, double s) { x[i] = xp[i] + s; });
    draw_barrier(draw);
    // P (old, dead) = (I - K Z) P_pred
    tile_mm(tile_product(B1, ld, B2, ld, false, n, n, n, P, ld), no_g, 0,
            no_o, 0, w);
    draw_barrier(draw);
    // new P = that (I - K Z)' + KH K'   (Joseph form), into B2
    TileProduct joseph = tile_product(P, ld, B1, ld, true, n, n, n, B2, ld);
    joseph.A2 = KH;
    joseph.lda2 = ldk;
    joseph.B2 = K;
    joseph.ldb2 = ldk;
    joseph.c2 = k;
    tile_mm(joseph, no_g, 0, no_o, 0, w);
    draw_barrier(draw);
    double* tmp = P; P = B2; B2 = tmp;
  }

  // ---- frozen-gain tail quantities
  predict([&] {
    tile_mv(Tm, ld, x, n, n, nullptr, 0, nullptr, 0, w,
            [&](int i, double s) {
              if constexpr (kFused) xp[i] = s;
              else if (i < n) gxp[b * n + i] = S(s);
            });
  });
  draw_barrier(draw);
  tile_mm(tile_product(B2, ld, Z, ld, true, n, n, k, PZt, ldk), no_g, 0,
          no_o, 0, w);
  draw_barrier(draw);
  if (w.warp == 0) {
    solve_innovation(std::false_type{});
    if constexpr (!kFused) {
      for (int e = lane; e < k * k; e += 32) {
        const int i = e / k, j = e - i * k;
        gFinv[b * k * k + e] = S(Finv[i * ldk + j]);
      }
    }
  }
  draw_barrier(draw);
  // K = PZt F^{-1}
  tile_mm(tile_product(PZt, ldk, Finv, ldk, false, n, k, k, K, ldk), no_g,
          0, no_o, 0, w);
  draw_barrier(draw);
  // TK = T K  (into KH)
  tile_mm(tile_product(Tm, ld, K, ldk, false, n, n, k, KH, ldk), no_g, 0,
          kFused ? no_o : gTK + b * kn, k, w);
  draw_barrier(draw);
  // M = T - TK Z  (fused: into B1; else straight to device memory)
  TileProduct m_prod = tile_product(KH, ldk, Z, ld, false, n, k, n,
                               kFused ? B1 : nullptr, ld);
  m_prod.sign = -1.0;
  m_prod.E = Tm;
  m_prod.lde = ld;
  tile_mm(m_prod, no_g, 0, kFused ? no_o : gM + b * nn, n, w);
  const double cnst = -0.5 * (double(k) * kLog2Pi + logdet);
  if constexpr (!kFused) {
    if (dt == 0) {
      gll[b] = S(ll);
      gconst[b] = S(cnst);
    }
  } else {
    // ---- the constant-gain tail over y[n_settle:n_total], as in
    // filter_tail.cu but in float64 on the settle's own shared memory, one
    // draw barrier per step.  Every warp advances its rows of the state,
    // x <- M x + TK (y_t - d).  Beside that warp 1 writes the innovation
    // v_t = (y_t - d) - Z x_t, warp 0 adds the quadratic form of v_{t-1}
    // (written one step earlier, so it waits for nothing) to the
    // log-likelihood it owns, and warp 2 writes y_{t+1} - d.  v and y - d
    // alternate between two buffers each.
    const double* M = B1;
    const double* TK = KH;
    double* xc = xp;   // predicted state
    double* xn = x;
    double* v2 = bf.v2;
    double* yd2 = bf.yd2;
    auto v_of = [&](int t) { return (t & 1) ? v2 : v; };
    auto yd_of = [&](int t) { return (t & 1) ? yd2 : yd; };
    auto quad_form = [&](const double* vt) {
      double quad = 0.0;
      tile_mv(Finv, ldk, vt, k, k, nullptr, 0, nullptr, 0, solo,
              [&](int i, double s) { quad += vt[i] * s; });
      ll = (ll + cnst) - 0.5 * warp_sum_rows(quad);
    };
    auto stage_yd = [&](int t) {
      const S* yt = ysrc + (size_t)t * k;
      for (int i = lane; i < L.k8; i += 32)
        yd_of(t)[i] = i < k ? double(yt[i]) - dv[i] : 0.0;
    };
    if (w.warp == 2 && n_settle < n_total) stage_yd(n_settle);
    draw_barrier(draw);
    for (int t = n_settle; t < n_total; ++t) {
      const double* ydt = yd_of(t);
      tile_mv(M, ld, xc, n, n, TK, ldk, ydt, k, w,
              [&](int i, double s) { xn[i] = s; });
      if (w.warp == 1) {
        double* vt = v_of(t);
        tile_mv(Z, ld, xc, k, n, nullptr, 0, nullptr, 0, solo,
                [&](int i, double s) { vt[i] = ydt[i] - s; });
      } else if (w.warp == 0) {
        if (t > n_settle) quad_form(v_of(t - 1));
      } else if (w.warp == 2) {
        if (t + 1 < n_total) stage_yd(t + 1);
      }
      draw_barrier(draw);
      double* tmp = xc; xc = xn; xn = tmp;
    }
    if (w.warp == 0) {
      if (n_total > n_settle) quad_form(v_of(n_total - 1));
      if (lane == 0) gll[b] = S(ll);
    }
  }
}


// The small-state kernel: every draw of the block in shared memory.
template <typename S, bool kFused>
__global__ void __launch_bounds__(kSettleThreads* GCP_SETTLE_DRAWS,
                                   GCP_SETTLE_MIN_BLOCKS)
    settle_kernel(const S* __restrict__ gT, const S* __restrict__ gRQR,
                  const S* __restrict__ gZ, const S* __restrict__ gH,
                  const S* __restrict__ gd, const S* __restrict__ gy,
                  S* __restrict__ gll, S* __restrict__ gxp,
                  S* __restrict__ gM, S* __restrict__ gTK,
                  S* __restrict__ gFinv, S* __restrict__ gconst, int batch,
                  int n, int k, int n_settle, int n_total, int lyap_iters,
                  int y_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SettleLayout L(n, k);
  const int draws = blockDim.x / kSettleThreads;
  // the warp's number comes through a shuffle so that the compiler knows it
  // (and the draw, the work items and every branch on them) to be the same
  // in all lanes: the mma then need no reconvergence code around them
  const int block_warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int draw = block_warp / kSettleWarps;
  const WarpCtx w{block_warp - draw * kSettleWarps, kSettleWarps,
                  (int)(threadIdx.x & 31)};
  const size_t b = (size_t)blockIdx.x * draws + draw;
  const bool active = b < (size_t)batch;
  double* sm = reinterpret_cast<double*>(smem_raw) + (size_t)draw * L.total;
  const SettleBufs bf(sm, L);

  const S* ysrc = stage_y(
      gy, reinterpret_cast<double*>(smem_raw) + (size_t)draws * L.total,
      n_total * k, y_in_smem);
  if (active)
    settle_start(gT, gRQR, gZ, gH, gd, L, bf, b, n, k, lyap_iters, w, draw);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();   // y is in shared memory for every draw of the block
  if (!active) return;
  settle_finish<S, kFused>(gRQR, gll, gxp, gM, gTK, gFinv, gconst, L, bf,
                           ysrc, b, n, k, n_settle, n_total, w, draw);
}

// The large-state kernel: the same schedule on the same layout, with each
// draw's buffers in a float64 workspace in device memory (gwork, L.total
// doubles per draw slot) instead of shared memory, which then holds y
// alone.  The grid is persistent: it holds as many blocks as are resident
// at once, and each draw slot strides over the batch, so the workspace
// scales with the card, not with the batch.
template <typename S, bool kFused>
__global__ void __launch_bounds__(kSettleThreads* GCP_SETTLE_DRAWS,
                                   GCP_SETTLE_MIN_BLOCKS)
    settle_large_kernel(const S* __restrict__ gT, const S* __restrict__ gRQR,
                        const S* __restrict__ gZ, const S* __restrict__ gH,
                        const S* __restrict__ gd, const S* __restrict__ gy,
                        S* __restrict__ gll, S* __restrict__ gxp,
                        S* __restrict__ gM, S* __restrict__ gTK,
                        S* __restrict__ gFinv, S* __restrict__ gconst,
                        double* gwork, int batch, int n, int k,
                        int n_settle, int n_total, int lyap_iters,
                        int y_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SettleLayout L(n, k);
  const int draws = blockDim.x / kSettleThreads;
  const int block_warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int draw = block_warp / kSettleWarps;
  const WarpCtx w{block_warp - draw * kSettleWarps, kSettleWarps,
                  (int)(threadIdx.x & 31)};
  const size_t slot = (size_t)blockIdx.x * draws + draw;
  const SettleBufs bf(gwork + slot * L.total, L);

  const S* ysrc = stage_y(gy, smem_raw, n_total * k, y_in_smem);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();   // y is in shared memory for every draw of the block
  // a draw slot past the batch leaves at once: no block barrier follows
  for (size_t b = slot; b < (size_t)batch;
       b += (size_t)gridDim.x * draws) {
    settle_start(gT, gRQR, gZ, gH, gd, L, bf, b, n, k, lyap_iters, w, draw);
    draw_barrier(draw);   // P0 is written (also with lyap_iters = 0)
    settle_finish<S, kFused>(gRQR, gll, gxp, gM, gTK, gFinv, gconst, L, bf,
                             ysrc, b, n, k, n_settle, n_total, w, draw);
    draw_barrier(draw);   // every warp is done with the slot's buffers
  }
}

template <typename S, bool kFused>
int launch_settle(const void* T, const void* RQR, const void* Z,
                  const void* H, const void* d, const void* y, void* ll,
                  void* xp, void* M, void* TK, void* Finv, void* cnst,
                  int batch, int n, int k, int n_settle, int n_total,
                  int lyap_iters, cudaStream_t stream) {
  const SettlePlan plan = settle_plan(n, k, n_total, sizeof(S));
  cudaError_t err = cudaFuncSetAttribute(
      settle_kernel<S, kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)plan.bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + plan.draws - 1) / plan.draws;
  settle_kernel<S, kFused>
      <<<blocks, kSettleThreads * plan.draws, plan.bytes, stream>>>(
          static_cast<const S*>(T), static_cast<const S*>(RQR),
          static_cast<const S*>(Z), static_cast<const S*>(H),
          static_cast<const S*>(d), static_cast<const S*>(y),
          static_cast<S*>(ll), static_cast<S*>(xp), static_cast<S*>(M),
          static_cast<S*>(TK), static_cast<S*>(Finv), static_cast<S*>(cnst),
          batch, n, k, n_settle, n_total, lyap_iters, plan.y_in_smem);
  return (int)cudaGetLastError();
}

// The large-state launch: GCP_SETTLE_DRAWS draws a block, y staged in
// shared memory as in the small-state plan, and as many blocks as the card
// holds at once (at most one per GCP_SETTLE_DRAWS draws of the batch).
struct SettleLargePlan {
  int draws, blocks, y_in_smem;
  size_t smem, work_bytes;
};

template <typename S, bool kFused>
SettleLargePlan settle_large_plan(int n, int k, int n_obs, int batch) {
  SettleLargePlan p;
  const size_t ybytes = (((size_t)n_obs * k * sizeof(S)) + 15) & ~(size_t)15;
  p.y_in_smem = ybytes <= kSettleMaxYBytes;
  p.smem = p.y_in_smem ? ybytes : 0;
  p.draws = GCP_SETTLE_DRAWS;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, settle_large_kernel<S, kFused>, kSettleThreads * p.draws,
      p.smem);
  const int need = (batch + p.draws - 1) / p.draws;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  p.blocks = need < resident ? need : resident;
  p.work_bytes = (size_t)p.blocks * p.draws * SettleLayout(n, k).total *
                 sizeof(double);
  return p;
}

template <typename S, bool kFused>
int launch_settle_large(const void* T, const void* RQR, const void* Z,
                        const void* H, const void* d, const void* y,
                        void* ll, void* xp, void* M, void* TK, void* Finv,
                        void* cnst, void* work, size_t work_bytes, int batch,
                        int n, int k, int n_settle, int n_total,
                        int lyap_iters, cudaStream_t stream) {
  const SettleLargePlan plan =
      settle_large_plan<S, kFused>(n, k, n_total, batch);
  if (plan.blocks < 1) return 0;
  if (work == nullptr || work_bytes < plan.work_bytes)
    return (int)cudaErrorInvalidValue;
  settle_large_kernel<S, kFused>
      <<<plan.blocks, kSettleThreads * plan.draws, plan.smem, stream>>>(
          static_cast<const S*>(T), static_cast<const S*>(RQR),
          static_cast<const S*>(Z), static_cast<const S*>(H),
          static_cast<const S*>(d), static_cast<const S*>(y),
          static_cast<S*>(ll), static_cast<S*>(xp), static_cast<S*>(M),
          static_cast<S*>(TK), static_cast<S*>(Finv), static_cast<S*>(cnst),
          static_cast<double*>(work), batch, n, k, n_settle, n_total,
          lyap_iters, plan.y_in_smem);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The cluster kernel: one draw a thread-block cluster, its buffers in the
// shared memory of the cluster's CTAs (see the note at the top).
// ---------------------------------------------------------------------------

#ifndef GCP_SETTLE_PROBE
// 1: clocks per phase of cluster 0's first draw (tools/settle_variants.py
// PROBE=1).  A probe build adds a CTA barrier between T P and x_pred, so its
// clocks come from a schedule slightly different from the one that ships.
#define GCP_SETTLE_PROBE 0
#endif

// 8 warps a CTA: two a sub-partition issuing DMMAs (12 and 16 spill and run
// slower at n = 104); the fused tail's side jobs take warps 0, 1 and 2.
constexpr int kClusterWarps = 8;
static_assert(kClusterWarps >= 3, "the fused tail's side jobs take 3 warps");
constexpr int kClusterThreads = 32 * kClusterWarps;

#if GCP_SETTLE_PROBE
// clocks of the first draw of cluster 0, as thread 0 of its CTA 0 sees
// them, summed by phase (each phase ends with its barrier): 0 the inputs,
// 1-3 the Lyapunov doubling's A P, P += (A P) A', A A; 4 T P and x_pred,
// 5 P_pred, 6 P_pred Z', 7 v, F and its elimination, 8 K, 9 I - K Z, K H
// and x, 10 (I - K Z) P_pred, 11 the Joseph sum; 12 the frozen-gain
// quantities, 13 the tail; 14 of phase 4, x_pred alone (the probe build
// puts a CTA barrier between T P and x_pred); 15 of phase 4, the first
// step's T P alone
constexpr int kSettleProbes = 16;
__device__ unsigned long long settle_probe[kSettleProbes];
#define SETTLE_MARK(slot)                                           \
  do {                                                              \
    if (probe) {                                                    \
      const unsigned long long now = clock64();                     \
      settle_probe[slot] += now - probe_t;                          \
      probe_t = now;                                                \
    }                                                               \
  } while (0)
#define SETTLE_PROBE_ARGS , bool probe, unsigned long long& probe_t
#define SETTLE_PROBE_PASS , probe, probe_t
#else
#define SETTLE_MARK(slot) do {} while (0)
#define SETTLE_PROBE_ARGS
#define SETTLE_PROBE_PASS
#endif

// The draw's inputs (this CTA's rows of T and P = R Q R'; Z, H and d whole;
// x = 0, F^{-1} = 0) and P0 by the Lyapunov doubling on the panels.
template <typename S>
__device__ __forceinline__ void cluster_start(
    const S* __restrict__ gT, const S* __restrict__ gRQR,
    const S* __restrict__ gZ, const S* __restrict__ gH,
    const S* __restrict__ gd, const SettleLayout& L, const SettleBufs& bf,
    const ClusterPart& cp, size_t b, int n, int k, int lyap_iters,
    WarpCtx w SETTLE_PROBE_ARGS) {
  const int tid = threadIdx.x;
  const int nn = n * n, kn = k * n;
  const int ld = L.ld, ldk = L.ldk;
  const S* rqr = gRQR + b * nn;
  for (int e = tid; e < cp.rows * ld; e += kClusterThreads) {
    const int il = e / ld, j = e - il * ld;
    const int i = cp.row0 + il;
    const bool in = i < n && j < n;
    bf.T[e] = in ? double(gT[b * nn + i * n + j]) : 0.0;
    bf.Wa[e] = in ? double(rqr[i * n + j]) : 0.0;
  }
  for (int e = tid; e < L.kr * ld; e += kClusterThreads) {
    const int i = e / ld, j = e - i * ld;
    bf.Z[e] = (i < k && j < n) ? double(gZ[b * kn + i * n + j]) : 0.0;
  }
  for (int e = tid; e < L.kr * ldk; e += kClusterThreads) {
    const int i = e / ldk, j = e - i * ldk;
    bf.H[e] = (i < k && j < k) ? double(gH[b * k * k + i * k + j]) : 0.0;
    bf.Finv[e] = 0.0;
  }
  for (int i = tid; i < L.k8; i += kClusterThreads)
    bf.dv[i] = i < k ? double(gd[b * k + i]) : 0.0;
  for (int i = tid; i < L.n8; i += kClusterThreads) bf.x[i] = 0.0;
  cluster_sync();   // every CTA's panels are written before a peer reads
  SETTLE_MARK(0);

  // P0: P += (A P) A'; A = A A, from A = T, with P in Wa and A alternating
  // between Wb and Wc.  A P and A A read the peers' rows of P and A, and
  // the second phase overwrites P: a cluster barrier after the first and
  // the third phase, a CTA barrier after the second (A P is read here only)
  const double* A = bf.T;
  for (int it = 0; it < lyap_iters; ++it) {
    double* next = A == bf.Wb ? bf.Wc : bf.Wb;
    cluster_mm<S>(panel_product(cp, A, ld, bf.Wa, ld, false, true, n, n, n,
                                next, ld),
                  cp.rows, nullptr, 0, nullptr, 0, w);
    cluster_sync();
    SETTLE_MARK(1);
    PanelProduct acc = panel_product(cp, next, ld, A, ld, true, true, n, n,
                                     n, bf.Wa, ld);
    acc.E = bf.Wa;
    acc.lde = ld;
    cluster_mm<S>(acc, cp.rows, nullptr, 0, nullptr, 0, w);
    __syncthreads();
    SETTLE_MARK(2);
    cluster_mm<S>(panel_product(cp, A, ld, A, ld, false, true, n, n, n, next,
                                ld),
                  cp.rows, nullptr, 0, nullptr, 0, w);
    cluster_sync();
    SETTLE_MARK(3);
    A = next;
  }
}

// The rest of the draw on the cluster, settle_finish's schedule: a cluster
// barrier where the next product reads a peer's panel (or overwrites one a
// peer reads), a CTA barrier where the data is local.  x_pred and x are
// whole in every CTA: each CTA writes its rows of them into all of its
// peers.  F, its elimination and the log-likelihood belong to warp 0 of
// CTA 0, which writes F^{-1} into every peer; every CTA forms v itself.
template <typename S, bool kFused>
__device__ __forceinline__ void cluster_finish(
    const S* __restrict__ gRQR, S* __restrict__ gll, S* __restrict__ gxp,
    S* __restrict__ gM, S* __restrict__ gTK, S* __restrict__ gFinv,
    S* __restrict__ gconst, const SettleLayout& L, const SettleBufs& bf,
    const ClusterPart& cp, const S* ysrc, size_t b, int n, int k,
    int n_settle, int n_total, WarpCtx w SETTLE_PROBE_ARGS) {
  const WarpCtx solo{0, 1, w.lane};
  const int lane = w.lane;
  const int nn = n * n, kn = k * n;
  const int ld = L.ld, ldk = L.ldk;
  const int rows = cp.rows, row0 = cp.row0;
  const bool lead = cp.rank == 0 && w.warp == 0;   // owns F and ll
  double* Tm = bf.T;
  double* Z = bf.Z;
  double* PZt = bf.PZt;
  double* KH = PZt;   // K H, and T K at the end, once P_pred Z' is dead
  double* K = bf.K;
  double* H = bf.H;
  double* Finv = bf.Finv;
  double* x = bf.x;
  double* xp = bf.xp;
  double* dv = bf.dv;
  double* v = bf.v;
  const S* no_g = nullptr;
  S* no_o = nullptr;
  const S* rqr = gRQR + b * nn;

  double* P = bf.Wa;
  double* B1 = bf.Wb;
  double* B2 = bf.Wc;
  double ll = 0.0, minpiv = INFINITY, logdet = 0.0;

  // this CTA's row i (local) of a vector whole in every CTA, into all of
  // them: the four lanes of a row share the stores
  auto put_all = [&](double* vec, int il, double s) {
    for (int q = lane & 3; q < cp.ctas; q += 4) *peer(vec + row0 + il, q) = s;
  };

  // P_pred = T P T' + R Q R' into B2 (through B1)
  auto predict = [&](auto&& first_step_extra) {
    cluster_mm<S>(panel_product(cp, Tm, ld, P, ld, false, true, n, n, n, B1,
                                ld),
                  rows, no_g, 0, no_o, 0, w);
    first_step_extra();
    __syncthreads();
    cluster_mm<S>(panel_product(cp, B1, ld, Tm, ld, true, true, n, n, n, B2,
                                ld),
                  rows, rqr, n, no_o, 0, w);
  };

  // P_pred Z' (this CTA's rows), and the same rows into CTA 0's whole
  // copy of it; the caller's cluster barrier follows
  auto pzt = [&] {
    cluster_mm<S>(panel_product(cp, B2, ld, Z, ld, true, false, n, n, k, PZt,
                                ldk),
                  rows, no_g, 0, no_o, 0, w);
    __syncthreads();
    double* gather = peer(bf.PZall + row0 * ldk, 0);
    for (int e = threadIdx.x; e < cp.nloc * ldk; e += kClusterThreads)
      gather[e] = PZt[e];
  };

  // warp 0 of CTA 0: F = Z PZt + H into the buffer of F^{-1} (from the
  // gathered PZt), its elimination, F^{-1} into every peer; returns
  // v' F^{-1} v
  auto solve_innovation = [&](auto with_v) {
    PanelProduct f{Z, ld, bf.PZall, ldk, false, false, 0, k, k, n, k,
                   nullptr, 0, nullptr, 0, 0, 1.0, false, H, ldk, Finv, ldk};
    cluster_mm<S, 1>(f, rows, no_g, 0, no_o, 0, solo);
    __syncwarp();
    minpiv = INFINITY;
    logdet = 0.0;
    const double q = warp_solve_innovation<decltype(with_v)::value>(
        Finv, ldk, v, k, bf.aug, bf.col, bf.row, lane, minpiv, logdet);
    for (int e = lane; e < k * k; e += 32) {
      const int i = e / k, j = e - i * k;
      const double fv = Finv[i * ldk + j];
      for (int r = 1; r < cp.ctas; ++r) *peer(Finv + i * ldk + j, r) = fv;
    }
    return q;
  };

  // v = y_t - Z x_pred - d, by one warp of each CTA
  auto innovation = [&](const S* yt) {
    tile_mv(Z, ld, xp, k, n, nullptr, 0, nullptr, 0, solo,
            [&](int i, double s) {
              v[i] = i < k ? (double(yt[i]) - s) - dv[i] : 0.0;
            });
    __syncwarp();
  };

  // ---- n_settle exact Riccati steps
  for (int t = 0; t < n_settle; ++t) {
    const S* yt = ysrc + (size_t)t * k;
    // B1 = T P;  x_pred = T x;  then P_pred = B1 T' + R Q R' (B2)
    cluster_mm<S>(panel_product(cp, Tm, ld, P, ld, false, true, n, n, n, B1,
                                ld),
                  rows, no_g, 0, no_o, 0, w);
#if GCP_SETTLE_PROBE
    __syncthreads();
    SETTLE_MARK(t == 0 ? 15 : 4);
#endif
    tile_mv(Tm, ld, x, cp.rloc, n, nullptr, 0, nullptr, 0, w,
            [&](int i, double s) { put_all(xp, i, s); });
    __syncthreads();
    SETTLE_MARK(14);
    cluster_mm<S>(panel_product(cp, B1, ld, Tm, ld, true, true, n, n, n, B2,
                                ld),
                  rows, rqr, n, no_o, 0, w);
    __syncthreads();
    SETTLE_MARK(5);
    // PZt = P_pred Z'
    pzt();
    cluster_sync();   // PZt in CTA 0 and x_pred whole in every CTA
    SETTLE_MARK(6);
    // v; F^{-1}, v' F^{-1} v and the log-likelihood
    if (w.warp == 0) {
      innovation(yt);
      if (lead) {
        const double q = solve_innovation(std::true_type{});
        ll = ll - 0.5 * ((double(k) * kLog2Pi + logdet) + q);
      }
    }
    cluster_sync();   // F^{-1} in every CTA
    SETTLE_MARK(7);
    // K = PZt F^{-1}
    cluster_mm<S>(panel_product(cp, PZt, ldk, Finv, ldk, false, false, n, k,
                                k, K, ldk),
                  rows, no_g, 0, no_o, 0, w);
    __syncthreads();
    SETTLE_MARK(8);
    // B1 = I - K Z;  KH = K H;  x = x_pred + K v
    PanelProduct ikz = panel_product(cp, K, ldk, Z, ld, false, false, n, k,
                                     n, B1, ld);
    ikz.sign = -1.0;
    ikz.eye = true;
    cluster_mm<S>(ikz, rows, no_g, 0, no_o, 0, w);
    cluster_mm<S>(panel_product(cp, K, ldk, H, ldk, false, false, n, k, k,
                                KH, ldk),
                  rows, no_g, 0, no_o, 0, w);
    tile_mv(K, ldk, v, cp.rloc, k, nullptr, 0, nullptr, 0, w,
            [&](int i, double s) { put_all(x, i, xp[row0 + i] + s); });
    __syncthreads();
    SETTLE_MARK(9);
    // P (old, dead) = (I - K Z) P_pred
    cluster_mm<S>(panel_product(cp, B1, ld, B2, ld, false, true, n, n, n, P,
                                ld),
                  rows, no_g, 0, no_o, 0, w);
    cluster_sync();   // B1 whole; no peer reads B2 any more
    SETTLE_MARK(10);
    // new P = that (I - K Z)' + KH K'   (Joseph form), into B2
    PanelProduct joseph = panel_product(cp, P, ld, B1, ld, true, true, n, n,
                                        n, B2, ld);
    joseph.A2 = KH;
    joseph.lda2 = ldk;
    joseph.B2 = K;
    joseph.ldb2 = ldk;
    joseph.c2 = k;
    cluster_mm<S>(joseph, rows, no_g, 0, no_o, 0, w);
    cluster_sync();
    SETTLE_MARK(11);
    double* tmp = P; P = B2; B2 = tmp;
  }

  // ---- frozen-gain tail quantities
  predict([&] {
    tile_mv(Tm, ld, x, cp.rloc, n, nullptr, 0, nullptr, 0, w,
            [&](int i, double s) {
              if constexpr (kFused) put_all(xp, i, s);
              else if (row0 + i < n) gxp[b * n + row0 + i] = S(s);
            });
  });
  __syncthreads();
  pzt();
  cluster_sync();
  if (lead) {
    solve_innovation(std::false_type{});
    if constexpr (!kFused) {
      for (int e = lane; e < k * k; e += 32) {
        const int i = e / k, j = e - i * k;
        gFinv[b * k * k + e] = S(Finv[i * ldk + j]);
      }
    }
  }
  cluster_sync();
  // K = PZt F^{-1}
  cluster_mm<S>(panel_product(cp, PZt, ldk, Finv, ldk, false, false, n, k, k,
                              K, ldk),
                rows, no_g, 0, no_o, 0, w);
  cluster_sync();   // T K reads the peers' rows of K
  // TK = T K  (into KH)
  cluster_mm<S>(panel_product(cp, Tm, ld, K, ldk, false, true, n, n, k, KH,
                              ldk),
                rows, no_g, 0, kFused ? no_o : gTK + b * kn, k, w);
  __syncthreads();
  // M = T - TK Z  (fused: into B1; else straight to device memory)
  PanelProduct m_prod = panel_product(cp, KH, ldk, Z, ld, false, false, n, k,
                                      n, kFused ? B1 : nullptr, ld);
  m_prod.sign = -1.0;
  m_prod.E = Tm;
  m_prod.lde = ld;
  cluster_mm<S>(m_prod, rows, no_g, 0, kFused ? no_o : gM + b * nn, n, w);
  const double cnst = -0.5 * (double(k) * kLog2Pi + logdet);
  __syncthreads();
  SETTLE_MARK(12);
  if constexpr (!kFused) {
    if (lead && lane == 0) {
      gll[b] = S(ll);
      gconst[b] = S(cnst);
    }
  } else {
    // ---- the constant-gain tail, settle_finish's schedule on the cluster:
    // every CTA advances its rows of the state, x <- M x + TK (y_t - d),
    // and writes them into every peer (one cluster barrier a step); warp 1
    // of CTA 0 writes v_t = (y_t - d) - Z x_t before the barrier's
    // arrival, warp 0 of CTA 0 adds the quadratic form of v_{t-1} and warp
    // 2 of every CTA writes y_{t+1} - d between its arrival and its wait
    const double* M = B1;
    const double* TK = KH;
    double* xc = xp;   // predicted state, whole in every CTA
    double* xn = x;
    double* v2 = bf.v2;
    double* yd = bf.yd;
    double* yd2 = bf.yd2;
    auto v_of = [&](int t) { return (t & 1) ? v2 : v; };
    auto yd_of = [&](int t) { return (t & 1) ? yd2 : yd; };
    auto quad_form = [&](const double* vt) {
      double quad = 0.0;
      tile_mv(Finv, ldk, vt, k, k, nullptr, 0, nullptr, 0, solo,
              [&](int i, double s) { quad += vt[i] * s; });
      ll = (ll + cnst) - 0.5 * warp_sum_rows(quad);
    };
    auto stage_yd = [&](int t) {
      const S* yt = ysrc + (size_t)t * k;
      for (int i = lane; i < L.k8; i += 32)
        yd_of(t)[i] = i < k ? double(yt[i]) - dv[i] : 0.0;
    };
    if (w.warp == 2 && n_settle < n_total) stage_yd(n_settle);
    __syncthreads();   // M, TK and y - d are this CTA's own
    for (int t = n_settle; t < n_total; ++t) {
      const double* ydt = yd_of(t);
      tile_mv(M, ld, xc, cp.rloc, n, TK, ldk, ydt, k, w,
              [&](int i, double s) { put_all(xn, i, s); });
      if (cp.rank == 0 && w.warp == 1) {
        double* vt = v_of(t);
        tile_mv(Z, ld, xc, k, n, nullptr, 0, nullptr, 0, solo,
                [&](int i, double s) { vt[i] = ydt[i] - s; });
      }
      // this CTA's rows of the state are in every peer, and x_t is read:
      // a peer may overwrite it after the wait
      cluster_arrive();
      if (lead) {
        if (t > n_settle) quad_form(v_of(t - 1));
      } else if (w.warp == 2) {
        if (t + 1 < n_total) stage_yd(t + 1);
      }
      __syncthreads();   // the side jobs' buffers, for the next step
      cluster_wait();
      double* tmp = xc; xc = xn; xn = tmp;
    }
    if (lead) {
      if (n_total > n_settle) quad_form(v_of(n_total - 1));
      if (lane == 0) gll[b] = S(ll);
    }
    SETTLE_MARK(13);
  }
}

// The cluster kernel: a cluster of ctas CTAs a draw, CTA r holding the r-th
// panel of `rows` rows of the draw's matrices, and y staged in every CTA as
// in the other kernels.  The grid is persistent (as many clusters as are
// resident, each striding over the batch).
template <typename S, bool kFused>
__global__ void __launch_bounds__(kClusterThreads, 1)
    settle_cluster_kernel(const S* __restrict__ gT, const S* __restrict__ gRQR,
                          const S* __restrict__ gZ, const S* __restrict__ gH,
                          const S* __restrict__ gd, const S* __restrict__ gy,
                          S* __restrict__ gll, S* __restrict__ gxp,
                          S* __restrict__ gM, S* __restrict__ gTK,
                          S* __restrict__ gFinv, S* __restrict__ gconst,
                          int batch, int n, int k, int n_settle, int n_total,
                          int lyap_iters, int ctas, int rows, int y_in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SettleLayout L(n, k, rows);
  // the warp's number and the CTA's rank through a shuffle, so that the
  // compiler knows them (and every branch on them) to be warp-uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int rank = __shfl_sync(0xffffffffu, (int)cluster_ctarank(), 0);
  const WarpCtx w{warp, kClusterWarps, (int)(threadIdx.x & 31)};
  ClusterPart cp;
  cp.rank = rank;
  cp.ctas = ctas;
  cp.rows = rows;
  cp.row0 = rank * rows;
  cp.nloc = L.nr - cp.row0 < rows ? L.nr - cp.row0 : rows;
  cp.rloc = n - cp.row0 < rows ? n - cp.row0 : rows;
  double* sm = reinterpret_cast<double*>(smem_raw);
  const SettleBufs bf(sm, L);

  const S* ysrc = stage_y(gy, sm + L.total, n_total * k, y_in_smem);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();   // y is in this CTA's shared memory
  const size_t clusters = gridDim.x / ctas;
  for (size_t b = blockIdx.x / ctas; b < (size_t)batch; b += clusters) {
#if GCP_SETTLE_PROBE
    const bool probe = b == 0 && threadIdx.x == 0;
    unsigned long long probe_t = clock64();
#endif
    cluster_start(gT, gRQR, gZ, gH, gd, L, bf, cp, b, n, k, lyap_iters,
                  w SETTLE_PROBE_PASS);
    cluster_finish<S, kFused>(gRQR, gll, gxp, gM, gTK, gFinv, gconst, L, bf,
                              cp, ysrc, b, n, k, n_settle, n_total,
                              w SETTLE_PROBE_PASS);
    cluster_sync();   // no peer reads this draw's buffers any more
  }
}

// How a cluster launch is cut: CTAs a cluster, rows a CTA, whether y is
// staged beside them, and the dynamic shared memory of a CTA.  The fewest
// CTAs whose share fits the device's shared memory a block; ctas 0 if none
// up to kClusterMaxCtas does.
struct ClusterPlan {
  int ctas, rows, y_in_smem;
  size_t bytes;
};

inline ClusterPlan settle_cluster_plan(int n, int k, int n_obs, size_t elt) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int tiles = ceil16(n) / 16;
  const size_t ybytes = (((size_t)n_obs * k * elt) + 15) & ~(size_t)15;
  ClusterPlan p{0, 0, 0, 0};
  for (int c = 2; c <= kClusterMaxCtas; ++c) {
    // row tiles a CTA: a whole number of cluster_mm's 32-row items
    const int per = 2 * ((tiles + 2 * c - 1) / (2 * c));
    const size_t share =
        (size_t)SettleLayout(n, k, 16 * per).total * sizeof(double);
    if (share > (size_t)limit) continue;
    p.ctas = (tiles + per - 1) / per;      // CTAs that hold rows
    p.rows = 16 * per;
    p.y_in_smem = ybytes <= kSettleMaxYBytes && share + ybytes <= (size_t)limit;
    p.bytes = share + (p.y_in_smem ? ybytes : 0);
    return p;
  }
  return p;
}

// The launch configuration of a plan (cluster dimension in attr), and the
// clusters of it the device holds at once (0 if it holds none; the CUDA
// error of the query, negated, if the query fails).
template <typename S, bool kFused>
int settle_cluster_config(const ClusterPlan& plan, cudaLaunchConfig_t& cfg,
                          cudaLaunchAttribute& attr, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      settle_cluster_kernel<S, kFused>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.bytes);
  if (err != cudaSuccess) return -(int)err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(plan.ctas, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
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
      &clusters, (const void*)settle_cluster_kernel<S, kFused>, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return clusters;
}

template <typename S, bool kFused>
int launch_settle_cluster(const void* T, const void* RQR, const void* Z,
                          const void* H, const void* d, const void* y,
                          void* ll, void* xp, void* M, void* TK, void* Finv,
                          void* cnst, int batch, int n, int k, int n_settle,
                          int n_total, int lyap_iters, cudaStream_t stream) {
  const ClusterPlan plan = settle_cluster_plan(n, k, n_total, sizeof(S));
  if (plan.ctas == 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = settle_cluster_config<S, kFused>(plan, cfg, attr, stream);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return (int)cudaErrorLaunchOutOfResources;
  if (batch < clusters) clusters = batch;
  cfg.gridDim = dim3(clusters * plan.ctas, 1, 1);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, settle_cluster_kernel<S, kFused>, static_cast<const S*>(T),
      static_cast<const S*>(RQR), static_cast<const S*>(Z),
      static_cast<const S*>(H), static_cast<const S*>(d),
      static_cast<const S*>(y), static_cast<S*>(ll), static_cast<S*>(xp),
      static_cast<S*>(M), static_cast<S*>(TK), static_cast<S*>(Finv),
      static_cast<S*>(cnst), batch, n, k, n_settle, n_total, lyap_iters,
      plan.ctas, plan.rows, plan.y_in_smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace gcp

extern "C" {

// dtype: 0 = float32, 1 = float64.  Returns the cudaError_t of the launch.
int gcp_settle(int dtype, const void* T, const void* RQR, const void* Z,
               const void* H, const void* d, const void* y, void* ll,
               void* xp, void* M, void* TK, void* Finv, void* cnst, int batch,
               int n, int k, int n_settle, int lyap_iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_settle<float, false>(
        T, RQR, Z, H, d, y, ll, xp, M, TK, Finv, cnst, batch, n, k, n_settle,
        n_settle, lyap_iters, s);
  return gcp::launch_settle<double, false>(
      T, RQR, Z, H, d, y, ll, xp, M, TK, Finv, cnst, batch, n, k, n_settle,
      n_settle, lyap_iters, s);
}

// Fused settle + tail: y holds all n_total >= n_settle observations and ll
// receives the whole sample's log-likelihood.
int gcp_settle_filter(int dtype, const void* T, const void* RQR,
                      const void* Z, const void* H, const void* d,
                      const void* y, void* ll, int batch, int n, int k,
                      int n_settle, int n_total, int lyap_iters,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_settle<float, true>(
        T, RQR, Z, H, d, y, ll, nullptr, nullptr, nullptr, nullptr, nullptr,
        batch, n, k, n_settle, n_total, lyap_iters, s);
  return gcp::launch_settle<double, true>(
      T, RQR, Z, H, d, y, ll, nullptr, nullptr, nullptr, nullptr, nullptr,
      batch, n, k, n_settle, n_total, lyap_iters, s);
}

// Dynamic shared memory per block of the launch that either entry point
// above makes for n states, k observables and n_obs rows of y in this dtype
// (the recursion is float64 for either I/O type), on the current device.
size_t gcp_settle_smem_bytes(int dtype, int n, int k, int n_obs) {
  return gcp::settle_plan(n, k, n_obs, dtype == 0 ? 4 : 8).bytes;
}

// Draws per block of that launch (kSettleThreads threads each).
int gcp_settle_draws_per_block(int dtype, int n, int k, int n_obs) {
  return gcp::settle_plan(n, k, n_obs, dtype == 0 ? 4 : 8).draws;
}

// The large-state entry points: the same arguments, plus a float64
// workspace of work_bytes >= gcp_settle_large_work_bytes(...) in device
// memory (cudaErrorInvalidValue, without a launch, if it is smaller).
int gcp_settle_large(int dtype, const void* T, const void* RQR,
                     const void* Z, const void* H, const void* d,
                     const void* y, void* ll, void* xp, void* M, void* TK,
                     void* Finv, void* cnst, void* work, size_t work_bytes,
                     int batch, int n, int k, int n_settle, int lyap_iters,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_settle_large<float, false>(
        T, RQR, Z, H, d, y, ll, xp, M, TK, Finv, cnst, work, work_bytes,
        batch, n, k, n_settle, n_settle, lyap_iters, s);
  return gcp::launch_settle_large<double, false>(
      T, RQR, Z, H, d, y, ll, xp, M, TK, Finv, cnst, work, work_bytes, batch,
      n, k, n_settle, n_settle, lyap_iters, s);
}

int gcp_settle_filter_large(int dtype, const void* T, const void* RQR,
                            const void* Z, const void* H, const void* d,
                            const void* y, void* ll, void* work,
                            size_t work_bytes, int batch, int n, int k,
                            int n_settle, int n_total, int lyap_iters,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_settle_large<float, true>(
        T, RQR, Z, H, d, y, ll, nullptr, nullptr, nullptr, nullptr, nullptr,
        work, work_bytes, batch, n, k, n_settle, n_total, lyap_iters, s);
  return gcp::launch_settle_large<double, true>(
      T, RQR, Z, H, d, y, ll, nullptr, nullptr, nullptr, nullptr, nullptr,
      work, work_bytes, batch, n, k, n_settle, n_total, lyap_iters, s);
}

// Whether the small-state plan fits one draw a block in the device's
// shared memory (then gcp_settle / gcp_settle_filter run; else the large
// entry points).
int gcp_settle_fits(int dtype, int n, int k, int n_obs) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return gcp_settle_smem_bytes(dtype, n, k, n_obs) <= (size_t)limit;
}

// The workspace the large-state launch needs for this batch: one draw
// slot of the float64 layout per resident draw (fused: the K5 launch).
size_t gcp_settle_large_work_bytes(int dtype, int fused, int n, int k,
                                   int n_obs, int batch) {
  if (fused)
    return dtype == 0
               ? gcp::settle_large_plan<float, true>(n, k, n_obs, batch)
                     .work_bytes
               : gcp::settle_large_plan<double, true>(n, k, n_obs, batch)
                     .work_bytes;
  return dtype == 0
             ? gcp::settle_large_plan<float, false>(n, k, n_obs, batch)
                   .work_bytes
             : gcp::settle_large_plan<double, false>(n, k, n_obs, batch)
                   .work_bytes;
}

// The cluster entry points: gcp_settle's and gcp_settle_filter's arguments;
// each draw runs on a cluster of CTAs with its buffers in their shared
// memory (cudaErrorInvalidValue, without a launch, where the plan does not
// fit: gcp_settle_cluster_fits).
int gcp_settle_cluster(int dtype, const void* T, const void* RQR,
                       const void* Z, const void* H, const void* d,
                       const void* y, void* ll, void* xp, void* M, void* TK,
                       void* Finv, void* cnst, int batch, int n, int k,
                       int n_settle, int lyap_iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_settle_cluster<float, false>(
        T, RQR, Z, H, d, y, ll, xp, M, TK, Finv, cnst, batch, n, k, n_settle,
        n_settle, lyap_iters, s);
  return gcp::launch_settle_cluster<double, false>(
      T, RQR, Z, H, d, y, ll, xp, M, TK, Finv, cnst, batch, n, k, n_settle,
      n_settle, lyap_iters, s);
}

int gcp_settle_filter_cluster(int dtype, const void* T, const void* RQR,
                              const void* Z, const void* H, const void* d,
                              const void* y, void* ll, int batch, int n,
                              int k, int n_settle, int n_total,
                              int lyap_iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_settle_cluster<float, true>(
        T, RQR, Z, H, d, y, ll, nullptr, nullptr, nullptr, nullptr, nullptr,
        batch, n, k, n_settle, n_total, lyap_iters, s);
  return gcp::launch_settle_cluster<double, true>(
      T, RQR, Z, H, d, y, ll, nullptr, nullptr, nullptr, nullptr, nullptr,
      batch, n, k, n_settle, n_total, lyap_iters, s);
}

// CTAs a cluster of the cluster plan for n states, k observables and n_obs
// rows of y in this dtype (0: it does not fit, and the wrappers take the
// large-state kernel), and the dynamic shared memory of one of its CTAs.
int gcp_settle_cluster_ctas(int dtype, int n, int k, int n_obs) {
  return gcp::settle_cluster_plan(n, k, n_obs, dtype == 0 ? 4 : 8).ctas;
}

int gcp_settle_cluster_fits(int dtype, int n, int k, int n_obs) {
  return gcp_settle_cluster_ctas(dtype, n, k, n_obs) > 0;
}

size_t gcp_settle_cluster_smem_bytes(int dtype, int n, int k, int n_obs) {
  return gcp::settle_cluster_plan(n, k, n_obs, dtype == 0 ? 4 : 8).bytes;
}

// Clusters of that plan the device holds at once (fused: the K5 kernel),
// the draws its persistent grid runs side by side; 0 where the plan does
// not fit, minus the CUDA error where the query fails.
int gcp_settle_cluster_resident(int dtype, int fused, int n, int k,
                                int n_obs) {
  const gcp::ClusterPlan plan =
      gcp::settle_cluster_plan(n, k, n_obs, dtype == 0 ? 4 : 8);
  if (plan.ctas == 0) return 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (fused)
    return dtype == 0
               ? gcp::settle_cluster_config<float, true>(plan, cfg, attr, 0)
               : gcp::settle_cluster_config<double, true>(plan, cfg, attr, 0);
  return dtype == 0
             ? gcp::settle_cluster_config<float, false>(plan, cfg, attr, 0)
             : gcp::settle_cluster_config<double, false>(plan, cfg, attr, 0);
}

// Threads of a CTA of the cluster kernel.
int gcp_settle_cluster_block_threads() { return gcp::kClusterThreads; }

#if GCP_SETTLE_PROBE
// The probe's clocks (kSettleProbes sums, see settle_probe): set to 0,
// and read back.
int gcp_settle_probe_reset() {
  const unsigned long long zero[gcp::kSettleProbes] = {};
  return (int)cudaMemcpyToSymbol(gcp::settle_probe, zero, sizeof(zero));
}

int gcp_settle_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, gcp::settle_probe,
                                   gcp::kSettleProbes * sizeof(*out));
}
#endif

}  // extern "C"
