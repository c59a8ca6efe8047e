// Batched cycle reduction: one thread block per draw.
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
// 4096-draw batch (4.7e-4 with this kernel in float64; H100 run); the
// float64 recursion costs 8.6 ms against 7.2 ms in float32 at that batch.
//
// What bounds it on the H100: the per-draw recursion is sequential (each
// elimination step depends on the last), about n_iter * (n^3 GJ + 4 n^3
// matmul) FMAs per draw, ~2.3 MFMA at n = 26, reading only 3 n^2 + n m
// inputs.  So it is latency- and shared-memory-bound, not HBM-bound.  The
// design keeps the whole recursion in shared memory (no device-memory
// traffic between iterations), gives each draw its own block so 4096 draws
// spread over the 132 SMs, and uses the block's threads for the entries of
// each step.  A faster layout (several draws per block, register tiles,
// skipping the eliminated columns) is later work.
#include "small_linalg.cuh"

#include <stdint.h>

namespace gcp {

// shared-memory layout (float64 elements): 6 n^2 matrices, the augmented
// system n x W with W = max(3n, n + m), the GJ column (n) and row (W), and
// a small tail of scalars / reduction slots
__host__ __device__ inline int cr_width(int n, int m) {
  return (3 * n > n + m) ? 3 * n : n + m;
}

__host__ __device__ inline size_t cr_smem_elems(int n, int m) {
  const int W = cr_width(n, m);
  return (size_t)6 * n * n + (size_t)n * W + n + W + 48;
}

template <typename S, bool kSelect>
__global__ void cr_kernel(const S* __restrict__ gA, const S* __restrict__ gB,
                          const S* __restrict__ gC, const S* __restrict__ gD,
                          S* __restrict__ gT, S* __restrict__ gR,
                          S* __restrict__ gflags, int n, int m, int n_iter) {
  using Acc = double;  // the recursion runs in float64 for either I/O type
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* sm = reinterpret_cast<Acc*>(smem_raw);
  const int nn = n * n;
  const int W = cr_width(n, m);
  Acc* A0 = sm;
  Acc* A1 = A0 + nn;
  Acc* A2 = A1 + nn;
  Acc* Ahat = A2 + nn;
  Acc* N0 = Ahat + nn;
  Acc* N2 = N0 + nn;
  Acc* aug = N2 + nn;
  GJScratch<Acc> gj;
  gj.col = aug + (size_t)n * W;
  gj.row = gj.col + n;
  Acc* scal = gj.row + W;   // [0] pivot [1] minpiv(step) [2] logdet
                          // [3] minpiv(all) [4..15] unused [16..47] reduce
  gj.pivot = scal;
  gj.prow = reinterpret_cast<int*>(scal + 4);
  Acc* red = scal + 16;

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const S* A = gA + b * nn;
  const S* B = gB + b * nn;
  const S* C = gC + b * nn;
  const S* D = kSelect ? gD + b * (size_t)n * m : nullptr;

  for (int e = tid; e < nn; e += blockDim.x) {
    A0[e] = A[e];
    A1[e] = B[e];
    A2[e] = C[e];
    Ahat[e] = B[e];
  }
  if (tid == 0) scal[3] = Acc(INFINITY);
  __syncthreads();

  for (int it = 0; it < n_iter; ++it) {
    // aug = [A1 | A0 | A2]  (n x 3n)
    const int w = 3 * n;
    for (int e = tid; e < n * w; e += blockDim.x) {
      const int i = e / w, j = e - i * w;
      aug[e] = j < n ? A1[i * n + j]
                     : (j < 2 * n ? A0[i * n + j - n] : A2[i * n + j - 2 * n]);
    }
    if (tid == 0) { scal[1] = Acc(INFINITY); scal[2] = Acc(0); }
    __syncthreads();
    gj_solve(aug, n, w, gj, &scal[1], &scal[2]);
    if (tid == 0) scal[3] = nan_min(scal[3], scal[1]);
    const Acc* Q0 = aug + n;       // leading dimension w
    const Acc* Q2 = aug + 2 * n;
    // A1 <- A1 - A0 Q2 - A2 Q0;  Ahat <- Ahat - A2 Q0;
    // N0 <- -A0 Q0;  N2 <- -A2 Q2
    for (int e = tid; e < nn; e += blockDim.x) {
      const int i = e / n, j = e - i * n;
      const Acc* a0 = A0 + i * n;
      const Acc* a2 = A2 + i * n;
      Acc s02 = Acc(0), s20 = Acc(0), s00 = Acc(0), s22 = Acc(0);
      for (int l = 0; l < n; ++l) {
        const Acc q0 = Q0[l * w + j];
        const Acc q2 = Q2[l * w + j];
        s02 += a0[l] * q2;
        s20 += a2[l] * q0;
        s00 += a0[l] * q0;
        s22 += a2[l] * q2;
      }
      A1[e] = (A1[e] - s02) - s20;
      Ahat[e] = Ahat[e] - s20;
      N0[e] = -s00;
      N2[e] = -s22;
    }
    __syncthreads();
    Acc* t0 = A0; A0 = N0; N0 = t0;
    Acc* t2 = A2; A2 = N2; N2 = t2;
  }

  // tail = max|A0_final| + max|A2_final|
  Acc m0 = Acc(0), m2 = Acc(0);
  for (int e = tid; e < nn; e += blockDim.x) {
    m0 = nan_max(m0, Acc(fabs(A0[e])));
    m2 = nan_max(m2, Acc(fabs(A2[e])));
  }
  const Acc tail = block_max(m0, red) + block_max(m2, red);

  // T = Ahat^{-1} (-A)   (aug n x 2n); T -> N0 (shared) and device memory
  {
    const int w = 2 * n;
    for (int e = tid; e < n * w; e += blockDim.x) {
      const int i = e / w, j = e - i * w;
      aug[e] = j < n ? Ahat[i * n + j] : -A[i * n + j - n];
    }
    if (tid == 0) { scal[1] = Acc(INFINITY); scal[2] = Acc(0); }
    __syncthreads();
    gj_solve(aug, n, w, gj, &scal[1], &scal[2]);
    if (tid == 0) scal[3] = nan_min(scal[3], scal[1]);
    for (int e = tid; e < nn; e += blockDim.x) {
      const int i = e / n, j = e - i * n;
      const Acc t = aug[i * w + n + j];
      N0[e] = t;
      gT[b * nn + e] = t;
      if (kSelect) N2[e] = C[e];
    }
    __syncthreads();
  }
  if constexpr (!kSelect) {
    if (tid == 0) {
      gflags[b * 2 + 0] = scal[3];
      gflags[b * 2 + 1] = tail;
    }
    return;
  }
  Acc* Tm = N0;
  // M = B + C T -> A1;  aug = [M | -D]  (n x (n + m))
  {
    const int w = n + m;
    for_each_mm(N2, n, Tm, n, false, n, n, n, [&](int i, int j, Acc s) {
      const Acc v = B[i * n + j] + s;
      A1[i * n + j] = v;
      aug[i * w + j] = v;
    });
    for (int e = tid; e < n * m; e += blockDim.x) {
      const int i = e / m, j = e - i * m;
      aug[i * w + n + j] = -D[e];
    }
    if (tid == 0) { scal[1] = Acc(INFINITY); scal[2] = Acc(0); }
    __syncthreads();
    gj_solve(aug, n, w, gj, &scal[1], &scal[2]);
    for (int e = tid; e < n * m; e += blockDim.x) {
      const int i = e / m, j = e - i * m;
      gR[b * (size_t)n * m + e] = aug[i * w + n + j];
    }
  }
  // resid = max|A + M T|
  Acc rmax = Acc(0);
  for_each_mm(A1, n, Tm, n, false, n, n, n, [&](int i, int j, Acc s) {
    rmax = nan_max(rmax, Acc(fabs(A[i * n + j] + s)));
  });
  const Acc resid = block_max(rmax, red);
  if (tid == 0) {
    gflags[b * 3 + 0] = nan_min(scal[3], scal[1]);
    gflags[b * 3 + 1] = tail;
    gflags[b * 3 + 2] = resid;
  }
}

template <typename S, bool kSelect>
int launch_cr(const void* A, const void* B, const void* C, const void* D,
              void* T, void* R, void* flags, int batch, int n, int m,
              int n_iter, cudaStream_t stream) {
  const size_t bytes = cr_smem_elems(n, m) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      cr_kernel<S, kSelect>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cr_kernel<S, kSelect><<<batch, 256, bytes, stream>>>(
      static_cast<const S*>(A), static_cast<const S*>(B),
      static_cast<const S*>(C), static_cast<const S*>(D), static_cast<S*>(T),
      static_cast<S*>(R), static_cast<S*>(flags), n, m, n_iter);
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

// shared memory per block; the recursion is float64 for either I/O type
size_t gcp_cr_policy_smem_bytes(int n, int m) {
  return gcp::cr_smem_elems(n, m) * sizeof(double);
}

size_t gcp_cr_smem_bytes(int n) {
  return gcp::cr_smem_elems(n, 0) * sizeof(double);
}

}  // extern "C"
