// Batched constant-gain Kalman filter tail: one thread block per draw.
//
// Replaces the TPU kernel _tail_kernel (geconpy_tpu/ops/pallas_filter.py
// :34, reached through pallas_filter_tail).  For each draw and step t:
//   yd = y_t - d;  v = yd - Z x;  ll += const - v' F^{-1} v / 2;
//   x <- M x + TK yd.
//
// What bounds it on the H100: each step is n^2 + n k + k n + k^2 FMAs
// (~1.3 kFMA at n = 26, k = 7) that depend on the previous step's x, so the
// 168-step recursion is latency-bound; the per-draw matrices (n^2 + 2 n k +
// k^2 values) are read from device memory once.  The design keeps them in
// shared memory for the whole recursion, runs a block of 64 threads per
// draw (4096 draws fill the SMs' resident-block slots), and reads y_t
// straight from device memory, shared by every draw (L1/L2 resident).
#include "small_linalg.cuh"

namespace gcp {

constexpr int kTailThreads = 64;

__host__ __device__ inline size_t tail_smem_elems(int n, int k) {
  return (size_t)n * n + (size_t)2 * n * k + (size_t)k * k + 2 * (size_t)n +
         3 * (size_t)k + 8;
}

template <typename S>
__global__ void filter_tail_kernel(const S* __restrict__ gy,
                                   const S* __restrict__ gM,
                                   const S* __restrict__ gTK,
                                   const S* __restrict__ gZ,
                                   const S* __restrict__ gd,
                                   const S* __restrict__ gFinv,
                                   const S* __restrict__ gconst,
                                   const S* __restrict__ gx0,
                                   S* __restrict__ gll, int n, int k,
                                   int n_steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const int nn = n * n, nk = n * k;
  S* M = sm;
  S* TK = M + nn;       // n x k
  S* Z = TK + nk;       // k x n
  S* Finv = Z + nk;     // k x k
  S* x = Finv + k * k;
  S* xn = x + n;
  S* d = xn + n;
  S* yd = d + k;
  S* v = yd + k;

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  for (int e = tid; e < nn; e += blockDim.x) M[e] = gM[b * nn + e];
  for (int e = tid; e < nk; e += blockDim.x) {
    TK[e] = gTK[b * nk + e];
    Z[e] = gZ[b * nk + e];
  }
  for (int e = tid; e < k * k; e += blockDim.x) Finv[e] = gFinv[b * k * k + e];
  for (int i = tid; i < n; i += blockDim.x) x[i] = gx0[b * n + i];
  for (int i = tid; i < k; i += blockDim.x) d[i] = gd[b * k + i];
  const S cnst = gconst[b];
  S ll = S(0);   // thread 0's copy is the result
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    const S* yt = gy + (size_t)t * k;
    for (int i = tid; i < k; i += blockDim.x) {
      const S ydi = yt[i] - d[i];
      S s = S(0);
      for (int l = 0; l < n; ++l) s += Z[i * n + l] * x[l];
      yd[i] = ydi;
      v[i] = ydi - s;
    }
    __syncthreads();
    if (tid == 0) {
      S quad = S(0);
      for (int i = 0; i < k; ++i)
        for (int j = 0; j < k; ++j) quad += v[i] * Finv[i * k + j] * v[j];
      ll = (ll + cnst) - S(0.5) * quad;
    }
    for (int i = tid; i < n; i += blockDim.x) {
      S s1 = S(0), s2 = S(0);
      for (int l = 0; l < n; ++l) s1 += M[i * n + l] * x[l];
      for (int l = 0; l < k; ++l) s2 += TK[i * k + l] * yd[l];
      xn[i] = s1 + s2;
    }
    __syncthreads();
    S* tmp = x; x = xn; xn = tmp;
  }
  if (tid == 0) gll[b] = ll;
}

template <typename S>
int launch_filter_tail(const void* y, const void* M, const void* TK,
                       const void* Z, const void* d, const void* Finv,
                       const void* cnst, const void* x0, void* ll, int batch,
                       int n, int k, int n_steps, cudaStream_t stream) {
  const size_t bytes = tail_smem_elems(n, k) * sizeof(S);
  cudaError_t err = cudaFuncSetAttribute(
      filter_tail_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  filter_tail_kernel<S><<<batch, kTailThreads, bytes, stream>>>(
      static_cast<const S*>(y), static_cast<const S*>(M),
      static_cast<const S*>(TK), static_cast<const S*>(Z),
      static_cast<const S*>(d), static_cast<const S*>(Finv),
      static_cast<const S*>(cnst), static_cast<const S*>(x0),
      static_cast<S*>(ll), n, k, n_steps);
  return (int)cudaGetLastError();
}

}  // namespace gcp

extern "C" {

// dtype: 0 = float32, 1 = float64.  Returns the cudaError_t of the launch.
int gcp_filter_tail(int dtype, const void* y, const void* M, const void* TK,
                    const void* Z, const void* d, const void* Finv,
                    const void* cnst, const void* x0, void* ll, int batch,
                    int n, int k, int n_steps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_filter_tail<float>(y, M, TK, Z, d, Finv, cnst, x0, ll,
                                          batch, n, k, n_steps, s);
  return gcp::launch_filter_tail<double>(y, M, TK, Z, d, Finv, cnst, x0, ll,
                                         batch, n, k, n_steps, s);
}

size_t gcp_filter_tail_smem_bytes(int n, int k, int elem_size) {
  return gcp::tail_smem_elems(n, k) * (size_t)elem_size;
}

const char* gcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
