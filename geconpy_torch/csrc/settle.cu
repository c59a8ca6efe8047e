// Batched Kalman settle phase: one thread block per draw.
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
// frozen-gain quantities to device memory it keeps them in shared memory (M
// in the buffer of I - K Z, TK in that of K H, x_pred0 in that of x_pred,
// all free once the settle is over, so the block needs no more shared memory
// than the settle alone) and runs the constant-gain tail of filter_tail.cu
// over the rest of the sample: per draw it reads its six inputs once and
// writes one number.  Its tail runs in float64 like the settle, straight
// from the float64 M, TK, F^{-1}, const and x_pred0; with float32 I/O its
// result is therefore not bitwise that of the settle kernel followed by the
// tail kernel, which round those five to float32 in between.  One thread
// owns the log-likelihood through both phases.  On an NVIDIA H100 80GB HBM3
// at 700 W (n = 26, k = 7, 32 + 168 periods, 4096 draws, float32 I/O) the
// fused kernel takes 12.25 ms where the settle kernel takes 9.83 ms and the
// tail kernel 1.45 ms: each tail step waits on a read of y_t, two block
// barriers and dot products run by k and n of the 256 threads, with 5
// blocks per SM to hide them where the tail kernel has 32.
//
// Precision: the kernel reads and writes the caller's dtype but runs the
// whole recursion in float64.  Without measurement error the innovation
// covariance F of SW-2007 is ill-conditioned (|F^{-1}| up to ~7.5e4), and a
// float32 recursion moved ll_head by up to 2.7e-3 relative between two
// float32 implementations (H100 run); float64 removes that sensitivity at
// twice the shared memory.
//
// What bounds it on the H100: (lyap_iters * 3 + n_settle * 6) n^3 FMAs per
// draw in dependent steps, ~5 MFMA at n = 26, on inputs of 2 n^2 + k n +
// k^2 + k values: latency- and shared-memory-bound.  The design keeps P and
// every intermediate in shared memory for the whole settle, one block per
// draw, and reads y_head directly from device memory (the TPU's one-hot
// row extraction and lane padding are gone).
#include "small_linalg.cuh"

namespace gcp {

__host__ __device__ inline size_t settle_smem_elems(int n, int k) {
  // 6 n^2 + Z, PZt, K, KH, TK-scratch (k n each) + H, Finv (k^2) + aug
  // k x (2k + 1) + vectors + scalars / reduce slots
  return (size_t)6 * n * n + (size_t)4 * k * n + (size_t)2 * k * k +
         (size_t)k * (2 * k + 1) + 3 * (size_t)n + 4 * (size_t)k +
         (2 * k + 1) + 48;
}

template <typename S, bool kFused>
__global__ void settle_kernel(const S* __restrict__ gT,
                              const S* __restrict__ gRQR,
                              const S* __restrict__ gZ,
                              const S* __restrict__ gH,
                              const S* __restrict__ gd,
                              const S* __restrict__ gy,
                              S* __restrict__ gll, S* __restrict__ gxp,
                              S* __restrict__ gM, S* __restrict__ gTK,
                              S* __restrict__ gFinv, S* __restrict__ gconst,
                              int n, int k, int n_settle, int n_total,
                              int lyap_iters) {
  using Acc = double;  // the recursion runs in float64 for either I/O type
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* sm = reinterpret_cast<Acc*>(smem_raw);
  const int nn = n * n;
  const int kn = k * n;
  Acc* Tm = sm;
  Acc* RQR = Tm + nn;
  Acc* P = RQR + nn;
  Acc* Pp = P + nn;
  Acc* W1 = Pp + nn;
  Acc* W2 = W1 + nn;
  Acc* Z = W2 + nn;     // k x n
  Acc* PZt = Z + kn;    // n x k
  Acc* K = PZt + kn;    // n x k
  Acc* KH = K + kn;     // n x k
  Acc* H = KH + kn;     // k x k
  Acc* Finv = H + k * k;
  Acc* aug = Finv + k * k;  // k x (2k + 1)
  Acc* x = aug + k * (2 * k + 1);
  Acc* xp = x + n;
  Acc* dv = xp + n;     // d (k)
  Acc* v = dv + k;      // innovation (k)
  GJScratch<Acc> gj;
  gj.col = v + k;     // k
  gj.row = gj.col + k;  // 2k + 1
  Acc* scal = gj.row + (2 * k + 1);  // [0] pivot [1] minpiv [2] logdet
                                   // [3] ll [4] vFv  [8] prow
  gj.pivot = scal;
  gj.prow = reinterpret_cast<int*>(scal + 8);

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  for (int e = tid; e < nn; e += blockDim.x) {
    Tm[e] = gT[b * nn + e];
    RQR[e] = gRQR[b * nn + e];
    P[e] = RQR[e];
    Pp[e] = Tm[e];        // Pp holds the doubling matrix A
  }
  for (int e = tid; e < kn; e += blockDim.x) Z[e] = gZ[b * kn + e];
  for (int e = tid; e < k * k; e += blockDim.x) H[e] = gH[b * k * k + e];
  for (int i = tid; i < k; i += blockDim.x) dv[i] = gd[b * k + i];
  for (int i = tid; i < n; i += blockDim.x) x[i] = Acc(0);
  if (tid == 0) scal[3] = Acc(0);
  __syncthreads();

  // ---- P0: discrete Lyapunov by doubling
  Acc* Am = Pp;
  Acc* An = W2;
  for (int it = 0; it < lyap_iters; ++it) {
    for_each_mm(Am, n, P, n, false, n, n, n,
                [&](int i, int j, Acc s) { W1[i * n + j] = s; });
    __syncthreads();
    for (int e = tid; e < nn; e += blockDim.x) {
      const int i = e / n, j = e - i * n;
      Acc sp = Acc(0), sa = Acc(0);
      for (int l = 0; l < n; ++l) {
        sp += W1[i * n + l] * Am[j * n + l];
        sa += Am[i * n + l] * Am[l * n + j];
      }
      P[e] = P[e] + sp;
      An[e] = sa;
    }
    __syncthreads();
    Acc* t = Am; Am = An; An = t;
  }

  // ---- n_settle exact Riccati steps
  for (int t = 0; t < n_settle; ++t) {
    const S* yt = gy + (size_t)t * k;
    // x_pred = T x;  W1 = T P
    for (int i = tid; i < n; i += blockDim.x) {
      Acc s = Acc(0);
      for (int l = 0; l < n; ++l) s += Tm[i * n + l] * x[l];
      xp[i] = s;
    }
    for_each_mm(Tm, n, P, n, false, n, n, n,
                [&](int i, int j, Acc s) { W1[i * n + j] = s; });
    __syncthreads();
    // P_pred = W1 T' + RQR;  v = y_t - Z x_pred - d
    for_each_mm(W1, n, Tm, n, true, n, n, n, [&](int i, int j, Acc s) {
      Pp[i * n + j] = s + RQR[i * n + j];
    });
    for (int i = tid; i < k; i += blockDim.x) {
      Acc s = Acc(0);
      for (int l = 0; l < n; ++l) s += Z[i * n + l] * xp[l];
      v[i] = (yt[i] - s) - dv[i];
    }
    __syncthreads();
    // PZt = P_pred Z'
    for_each_mm(Pp, n, Z, n, true, n, n, k,
                [&](int i, int j, Acc s) { PZt[i * k + j] = s; });
    __syncthreads();
    // aug = [F | v | I],  F = Z PZt + H
    {
      const int w = 2 * k + 1;
      for_each_mm(Z, n, PZt, k, false, k, n, k, [&](int i, int j, Acc s) {
        aug[i * w + j] = s + H[i * k + j];
      });
      for (int e = tid; e < k * (k + 1); e += blockDim.x) {
        const int i = e / (k + 1), j = e - i * (k + 1);
        aug[i * w + k + j] = j == 0 ? v[i] : Acc(j - 1 == i ? 1 : 0);
      }
      if (tid == 0) { scal[1] = Acc(INFINITY); scal[2] = Acc(0); }
      __syncthreads();
      gj_solve(aug, k, w, gj, &scal[1], &scal[2]);
      // K = PZt Finv;  vFv = v . (F^{-1} v)
      for_each_mm(PZt, k, aug + k + 1, w, false, n, k, k,
                  [&](int i, int j, Acc s) { K[i * k + j] = s; });
      if (tid == 0) {
        Acc q = Acc(0);
        for (int i = 0; i < k; ++i) q += v[i] * aug[i * w + k];
        scal[4] = q;
      }
    }
    __syncthreads();
    // x = x_pred + K v;  W2 = I - K Z;  KH = K H
    for (int i = tid; i < n; i += blockDim.x) {
      Acc s = Acc(0);
      for (int l = 0; l < k; ++l) s += K[i * k + l] * v[l];
      x[i] = xp[i] + s;
    }
    for_each_mm(K, k, Z, n, false, n, k, n, [&](int i, int j, Acc s) {
      W2[i * n + j] = Acc(i == j ? 1 : 0) - s;
    });
    for_each_mm(K, k, H, k, false, n, k, k,
                [&](int i, int j, Acc s) { KH[i * k + j] = s; });
    __syncthreads();
    // W1 = (I - K Z) P_pred
    for_each_mm(W2, n, Pp, n, false, n, n, n,
                [&](int i, int j, Acc s) { W1[i * n + j] = s; });
    __syncthreads();
    // P = W1 (I - K Z)' + KH K'   (Joseph form)
    for (int e = tid; e < nn; e += blockDim.x) {
      const int i = e / n, j = e - i * n;
      Acc s1 = Acc(0), s2 = Acc(0);
      for (int l = 0; l < n; ++l) s1 += W1[i * n + l] * W2[j * n + l];
      for (int l = 0; l < k; ++l) s2 += KH[i * k + l] * K[j * k + l];
      P[e] = s1 + s2;
    }
    if (tid == 0)
      scal[3] = scal[3] - Acc(0.5) * ((Acc(k) * Acc(kLog2Pi) + scal[2]) + scal[4]);
    __syncthreads();
  }

  // ---- frozen-gain tail quantities
  for_each_mm(Tm, n, P, n, false, n, n, n,
              [&](int i, int j, Acc s) { W1[i * n + j] = s; });
  for (int i = tid; i < n; i += blockDim.x) {
    Acc s = Acc(0);
    for (int l = 0; l < n; ++l) s += Tm[i * n + l] * x[l];
    if constexpr (kFused) xp[i] = s; else gxp[b * n + i] = s;
  }
  __syncthreads();
  for_each_mm(W1, n, Tm, n, true, n, n, n, [&](int i, int j, Acc s) {
    Pp[i * n + j] = s + RQR[i * n + j];
  });
  __syncthreads();
  for_each_mm(Pp, n, Z, n, true, n, n, k,
              [&](int i, int j, Acc s) { PZt[i * k + j] = s; });
  __syncthreads();
  const int w = 2 * k;
  for_each_mm(Z, n, PZt, k, false, k, n, k, [&](int i, int j, Acc s) {
    aug[i * w + j] = s + H[i * k + j];
  });
  for (int e = tid; e < k * k; e += blockDim.x) {
    const int i = e / k, j = e - i * k;
    aug[i * w + k + j] = Acc(i == j ? 1 : 0);
  }
  if (tid == 0) { scal[1] = Acc(INFINITY); scal[2] = Acc(0); }
  __syncthreads();
  gj_solve(aug, k, w, gj, &scal[1], &scal[2]);
  for (int e = tid; e < k * k; e += blockDim.x) {
    const int i = e / k, j = e - i * k;
    Finv[e] = aug[i * w + k + j];
    if constexpr (!kFused) gFinv[b * k * k + e] = Finv[e];
  }
  __syncthreads();
  // K = PZt Finv
  for_each_mm(PZt, k, Finv, k, false, n, k, k,
              [&](int i, int j, Acc s) { K[i * k + j] = s; });
  __syncthreads();
  // TK = T K  (into KH)
  for_each_mm(Tm, n, K, k, false, n, n, k, [&](int i, int j, Acc s) {
    KH[i * k + j] = s;
    if constexpr (!kFused) gTK[b * kn + i * k + j] = s;
  });
  __syncthreads();
  // M = T - TK Z  (fused: into W2, whose I - K Z is no longer needed)
  for_each_mm(KH, k, Z, n, false, n, k, n, [&](int i, int j, Acc s) {
    if constexpr (kFused) W2[i * n + j] = Tm[i * n + j] - s;
    else gM[b * nn + i * n + j] = Tm[i * n + j] - s;
  });
  if constexpr (!kFused) {
    if (tid == 0) {
      gll[b] = scal[3];
      gconst[b] = Acc(-0.5) * (Acc(k) * Acc(kLog2Pi) + scal[2]);
    }
  } else {
    // ---- the constant-gain tail over y[n_settle:n_total], as in
    // filter_tail.cu but in float64 on the settle's own shared memory
    __syncthreads();
    const Acc* M = W2;
    const Acc* TK = KH;
    Acc* yd = gj.col;     // y_t - d (k)
    Acc* xc = xp;         // predicted state
    Acc* xn = x;
    const Acc cnst = Acc(-0.5) * (Acc(k) * Acc(kLog2Pi) + scal[2]);
    Acc ll = scal[3];     // thread 0 goes on owning the log-likelihood
    // thread 0 sums the quadratic form while another warp's threads advance
    // the state
    const int row0 = blockDim.x > 32 ? 32 : 0;
    for (int t = n_settle; t < n_total; ++t) {
      const S* yt = gy + (size_t)t * k;
      for (int i = tid; i < k; i += blockDim.x) {
        const Acc ydi = Acc(yt[i]) - dv[i];
        Acc s = Acc(0);
        for (int l = 0; l < n; ++l) s += Z[i * n + l] * xc[l];
        yd[i] = ydi;
        v[i] = ydi - s;
      }
      __syncthreads();
      if (tid == 0) {
        Acc quad = Acc(0);
        for (int i = 0; i < k; ++i)
          for (int j = 0; j < k; ++j) quad += v[i] * Finv[i * k + j] * v[j];
        ll = (ll + cnst) - Acc(0.5) * quad;
      }
      for (int i = tid - row0; i >= 0 && i < n; i += blockDim.x - row0) {
        Acc s1 = Acc(0), s2 = Acc(0);
        for (int l = 0; l < n; ++l) s1 += M[i * n + l] * xc[l];
        for (int l = 0; l < k; ++l) s2 += TK[i * k + l] * yd[l];
        xn[i] = s1 + s2;
      }
      __syncthreads();
      Acc* tmp = xc; xc = xn; xn = tmp;
    }
    if (tid == 0) gll[b] = ll;
  }
}

template <typename S, bool kFused>
int launch_settle(const void* T, const void* RQR, const void* Z,
                  const void* H, const void* d, const void* y, void* ll,
                  void* xp, void* M, void* TK, void* Finv, void* cnst,
                  int batch, int n, int k, int n_settle, int n_total,
                  int lyap_iters, cudaStream_t stream) {
  const size_t bytes = settle_smem_elems(n, k) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      settle_kernel<S, kFused>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  settle_kernel<S, kFused><<<batch, 256, bytes, stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(RQR),
      static_cast<const S*>(Z), static_cast<const S*>(H),
      static_cast<const S*>(d), static_cast<const S*>(y), static_cast<S*>(ll),
      static_cast<S*>(xp), static_cast<S*>(M), static_cast<S*>(TK),
      static_cast<S*>(Finv), static_cast<S*>(cnst), n, k, n_settle, n_total,
      lyap_iters);
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

// shared memory per block, of either kernel; the recursion is float64 for
// either I/O type
size_t gcp_settle_smem_bytes(int n, int k) {
  return gcp::settle_smem_elems(n, k) * sizeof(double);
}

}  // extern "C"
