// Batched DARE settle (predictive covariance fixed point): one thread block
// per draw.
//
// Replaces the TPU kernel _dare_kernel (geconpy_tpu/ops/pallas_dare.py:37,
// reached through pallas_dare_settle).  For each draw, a fixed schedule:
// P = the unconditional covariance by lyap_iters Lyapunov doublings
// (P += A P A'; A = A A from A = T, P = RQR), then hewer_iters Hewer
// polishes, each
//   S = Z P Z' + H inverted by the pivoted Gauss-Jordan helper,
//   Kp = T (P Z' S^{-1}),  A_cl = T - Kp Z,  Qc = sym(RQR + (Kp H) Kp'),
//   P = sym(Lyapunov doubling of (A_cl, Qc), inner_iters doublings).
// Starting from the open-loop unconditional covariance matters: with H = 0
// the DARE has several fixed points and the right one is the limit from
// there (geconpy_tpu/ops/kalman.py:287-294).  The schedule has no early
// exit; the caller gates convergence outside the kernel with one Riccati
// step (dare_residual_settled).  The TPU wrapper pads the batch to whole
// lane tiles with H = I in the padded slots; here the grid is exactly one
// block per draw, so there is no padded slot to keep finite.
//
// Precision: the kernel reads and writes the caller's dtype but runs the
// recursion in float64, as the settle kernel does: without measurement
// error S = Z P Z' is ill-conditioned on SW-2007.
//
// What bounds it on the H100: (lyap_iters + hewer_iters * inner_iters) * 3
// n^3 FMAs per draw in dependent doubling steps, ~7.4 MFMA at n = 26 with
// the default 12 + 8 * 16 schedule, on inputs of 2 n^2 + k n + k^2 values:
// latency- and shared-memory-bound, far from HBM.  The design keeps every
// matrix in shared memory for the whole schedule (one block per draw, about
// 40 KB in float64 at n = 26, k = 7) and spreads each n x n product's
// entries over the block's threads.
#include "small_linalg.cuh"

namespace gcp {

__host__ __device__ inline size_t dare_smem_elems(int n, int k) {
  // T, RQR, P, A, A-next, W1 (n^2 each); Z, PZt, Kp, KpH (k n each); H
  // (k^2); aug k x 2k; GJ column (k) and row (2k); scalars / reduce slots
  return (size_t)6 * n * n + (size_t)4 * k * n + (size_t)k * k +
         (size_t)2 * k * k + 3 * (size_t)k + 48;
}

// P += A P A'; A = A A, iters times.  Am / An are swapped in place so the
// caller's pointers follow the current doubling matrix.
__device__ void lyap_doubling(double*& Am, double*& An, double* P, double* W1,
                              int n, int iters) {
  const int nn = n * n;
  for (int it = 0; it < iters; ++it) {
    for_each_mm(Am, n, P, n, false, n, n, n,
                [&](int i, int j, double s) { W1[i * n + j] = s; });
    __syncthreads();
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int i = e / n, j = e - i * n;
      double sp = 0.0, sa = 0.0;
      for (int l = 0; l < n; ++l) {
        sp += W1[i * n + l] * Am[j * n + l];
        sa += Am[i * n + l] * Am[l * n + j];
      }
      P[e] = P[e] + sp;
      An[e] = sa;
    }
    __syncthreads();
    double* t = Am; Am = An; An = t;
  }
}

// P <- (P + P') / 2, through W1
__device__ void symmetrise(double* P, double* W1, int n) {
  const int nn = n * n;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) W1[e] = P[e];
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    P[e] = 0.5 * (W1[e] + W1[j * n + i]);
  }
  __syncthreads();
}

template <typename S>
__global__ void dare_kernel(const S* __restrict__ gT,
                            const S* __restrict__ gRQR,
                            const S* __restrict__ gZ,
                            const S* __restrict__ gH, S* __restrict__ gP,
                            int n, int k, int lyap_iters, int hewer_iters,
                            int inner_iters) {
  using Acc = double;  // the recursion runs in float64 for either I/O type
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* sm = reinterpret_cast<Acc*>(smem_raw);
  const int nn = n * n;
  const int kn = k * n;
  const int w = 2 * k;
  Acc* Tm = sm;
  Acc* RQR = Tm + nn;
  Acc* P = RQR + nn;
  Acc* Am = P + nn;
  Acc* An = Am + nn;
  Acc* W1 = An + nn;
  Acc* Z = W1 + nn;     // k x n
  Acc* PZt = Z + kn;    // n x k
  Acc* Kp = PZt + kn;   // n x k
  Acc* KpH = Kp + kn;   // n x k (first P Z' S^{-1}, then Kp H)
  Acc* H = KpH + kn;    // k x k
  Acc* aug = H + k * k; // k x 2k
  GJScratch<Acc> gj;
  gj.col = aug + k * w;  // k
  gj.row = gj.col + k;   // 2k
  Acc* scal = gj.row + w;  // [0] pivot [1] minpiv [2] logdet [4] prow
  gj.pivot = scal;
  gj.prow = reinterpret_cast<int*>(scal + 4);

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  for (int e = tid; e < nn; e += blockDim.x) {
    Tm[e] = gT[b * nn + e];
    RQR[e] = gRQR[b * nn + e];
    P[e] = RQR[e];
    Am[e] = Tm[e];
  }
  for (int e = tid; e < kn; e += blockDim.x) Z[e] = gZ[b * kn + e];
  for (int e = tid; e < k * k; e += blockDim.x) H[e] = gH[b * k * k + e];
  __syncthreads();

  // K = 0 start: the unconditional covariance of the stable transition
  lyap_doubling(Am, An, P, W1, n, lyap_iters);

  for (int h = 0; h < hewer_iters; ++h) {
    // PZt = P Z'
    for_each_mm(P, n, Z, n, true, n, n, k,
                [&](int i, int j, Acc s) { PZt[i * k + j] = s; });
    __syncthreads();
    // aug = [Z PZt + H | I]
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
    // KpH = PZt S^{-1}
    for_each_mm(PZt, k, aug + k, w, false, n, k, k,
                [&](int i, int j, Acc s) { KpH[i * k + j] = s; });
    __syncthreads();
    // Kp = T (PZt S^{-1})
    for_each_mm(Tm, n, KpH, k, false, n, n, k,
                [&](int i, int j, Acc s) { Kp[i * k + j] = s; });
    __syncthreads();
    // A_cl = T - Kp Z;  KpH = Kp H
    for_each_mm(Kp, k, Z, n, false, n, k, n, [&](int i, int j, Acc s) {
      Am[i * n + j] = Tm[i * n + j] - s;
    });
    for_each_mm(Kp, k, H, k, false, n, k, k,
                [&](int i, int j, Acc s) { KpH[i * k + j] = s; });
    __syncthreads();
    // P = sym(RQR + KpH Kp')
    for_each_mm(KpH, k, Kp, k, true, n, k, n, [&](int i, int j, Acc s) {
      P[i * n + j] = RQR[i * n + j] + s;
    });
    __syncthreads();
    symmetrise(P, W1, n);
    lyap_doubling(Am, An, P, W1, n, inner_iters);
    symmetrise(P, W1, n);
  }
  for (int e = tid; e < nn; e += blockDim.x) gP[b * nn + e] = S(P[e]);
}

template <typename S>
int launch_dare(const void* T, const void* RQR, const void* Z, const void* H,
                void* P, int batch, int n, int k, int lyap_iters,
                int hewer_iters, int inner_iters, cudaStream_t stream) {
  const size_t bytes = dare_smem_elems(n, k) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      dare_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dare_kernel<S><<<batch, 256, bytes, stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(RQR),
      static_cast<const S*>(Z), static_cast<const S*>(H), static_cast<S*>(P),
      n, k, lyap_iters, hewer_iters, inner_iters);
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

// shared memory per block; the recursion is float64 for either I/O type
size_t gcp_dare_smem_bytes(int n, int k) {
  return gcp::dare_smem_elems(n, k) * sizeof(double);
}

}  // extern "C"
