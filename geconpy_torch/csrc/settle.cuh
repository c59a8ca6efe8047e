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
//
// The tiers' kernels and entry points lie in settle.cu (small-state),
// settle_cluster.cu and settle_large.cu, which the build compiles side by
// side (as one file they took ~110 s of nvcc 12.9 on an H100 machine's
// host, the other sources <= 27 s); this header holds what they share.
#pragma once

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

}  // namespace gcp
