// K2 and K5 in the cluster tier: one draw a thread-block cluster, its
// buffers in the shared memory of the cluster's CTAs (settle.cuh's note).
#include "settle.cuh"

namespace gcp {

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
