// Batched constant-gain Kalman filter tail: one warp per draw, the draw's
// matrices in that warp's registers, no barrier in the step loop; and, for
// larger states, one block per draw with its matrices in shared memory.
//
// Replaces the TPU kernel _tail_kernel (geconpy_tpu/ops/pallas_filter.py
// :34, reached through pallas_filter_tail).  For each draw and step t:
//   yd = y_t - d;  v = yd - Z x;  ll += const - v' F^{-1} v / 2;
//   x <- M x + TK yd.
// It computes in the caller's dtype, as the reference kernel does (float32
// on the sweep).
//
// What bounds it on the H100: each step is n^2 + 2 n k + k^2 multiply-adds
// per draw (~1.3k at n = 26, k = 7) that depend on the previous step's x,
// 168 dependent steps on SW-2007; the per-draw matrices are read from
// device memory once.  So it is bound by how many instructions a draw's
// step takes, not by memory.  An earlier design (a 64-thread block per
// draw, matrices in shared memory, two block barriers a step, thread 0
// alone summing the quadratic form) took 1.441 ms for 4096 draws in
// float32, NVIDIA H100 80GB HBM3 at 700.00 W: ~17k clocks a step.  This
// design:
//
//  * one warp owns one draw.  Lane i holds row i of M and of TK (and row
//    i + 32 when 32 < n <= 64: kRows = 2), x_i, and, on lanes i < k, row i
//    of Z and of F^{-1} and d_i, all zero-padded to whole compile-time
//    widths, so that every loop is unrolled over registers and tests no
//    bound;
//  * a step hands x, y_t - d and v round the warp through a few hundred
//    bytes of shared memory of its own: each lane writes its entries, and
//    after __syncwarp every lane reads them all back as broadcasts, four
//    floats (two doubles) a load, and accumulates its entries of M x and,
//    on lanes < k, of Z x from the same values, two accumulators each for
//    ILP; F^{-1} v and TK (y_t - d) likewise; v' F^{-1} v is a warp
//    reduction by shuffles.  No barrier but the warp's own: the only chain
//    from step to step is x.  Broadcasting x by __shfl_sync instead, a
//    shuffle a column, took 0.249 against 0.159 ms (same card and limit):
//    the SM runs one shuffle a clock;
//  * y_t is shared by every draw and read through the read-only L1 path
//    (__ldg): 168 x 7 values in float32 stay resident there;
//  * four draws (warps) a block; a warp past the batch returns at once.
//    4096 draws are ~31 warps an SM, two waves at 128 registers a thread,
//    and the work is bound by issue either way (1, 4 and 8 draws a block
//    read alike).
//
// That small-state kernel holds a draw in one warp's registers, so it takes
// n <= 64 and k <= 32 (the largest filter core of the bundled models is 26,
// with 7 observables).  The reference's kernel takes any n and k, and lag
// augmentation reaches past 64 (SW-2007 observing year-on-year inflation:
// 4 lag blocks of 26, n = 104).  Those shapes go to the large-state kernel
// below (filter_tail_large_kernel: a block per draw, a thread per row of
// the stacked step, one block barrier a step), which the wrapper picks for
// n > 64 or k > 32.
#include <cuda_runtime.h>

#ifndef GCP_TAIL_DRAWS
#define GCP_TAIL_DRAWS 4   // draws (warps) per block
#endif

namespace gcp {

constexpr int kTailDraws = GCP_TAIL_DRAWS;
constexpr int kTailMaxN = 64;
constexpr int kTailMaxK = 32;

// four consecutive entries of a 16-byte aligned array in shared memory
__device__ __forceinline__ void load4(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const double* p, double (&out)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 c = *reinterpret_cast<const double2*>(p + 2);
  out[0] = a.x; out[1] = a.y; out[2] = c.x; out[3] = c.y;
}

// kRows rows of M a lane (n <= 32 * kRows), each held as kCols = 32 * kRows
// columns; kK >= k columns held per row of TK and F^{-1}.
template <typename S, int kRows, int kK>
__global__ void __launch_bounds__(32 * kTailDraws)
    filter_tail_kernel(const S* __restrict__ gy, const S* __restrict__ gM,
                       const S* __restrict__ gTK, const S* __restrict__ gZ,
                       const S* __restrict__ gd, const S* __restrict__ gFinv,
                       const S* __restrict__ gconst,
                       const S* __restrict__ gx0, S* __restrict__ gll,
                       int batch, int n, int k, int n_steps) {
  constexpr int kCols = 32 * kRows;
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const size_t b = (size_t)blockIdx.x * kTailDraws + (threadIdx.x >> 5);
  if (b >= (size_t)batch) return;   // the whole warp: no barrier follows
  const size_t nn = (size_t)n * n, nk = (size_t)n * k;

  S m[kRows][kCols], tk[kRows][kK], x[kRows], z[kCols], fi[kK];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = lane + 32 * r;
    const bool in = row < n;
    const S* mrow = gM + b * nn + (size_t)row * n;
    const S* tkrow = gTK + b * nk + (size_t)row * k;
#pragma unroll
    for (int l = 0; l < kCols; ++l) m[r][l] = (in && l < n) ? mrow[l] : S(0);
#pragma unroll
    for (int j = 0; j < kK; ++j) tk[r][j] = (in && j < k) ? tkrow[j] : S(0);
    x[r] = in ? gx0[b * n + row] : S(0);
  }
  const bool obs = lane < k;
  const S* zrow = gZ + b * nk + (size_t)lane * n;
  const S* firow = gFinv + b * (size_t)k * k + (size_t)lane * k;
#pragma unroll
  for (int l = 0; l < kCols; ++l) z[l] = (obs && l < n) ? zrow[l] : S(0);
#pragma unroll
  for (int j = 0; j < kK; ++j) fi[j] = (obs && j < k) ? firow[j] : S(0);
  const S d = obs ? gd[b * k + lane] : S(0);
  const S cnst = gconst[b];
  S ll = S(0);

  // the warp's broadcast buffers: x, y_t - d and v
  __shared__ __align__(16) S bcast[kTailDraws][kCols + 2 * kK];
  S* xs = bcast[threadIdx.x >> 5];
  S* yds = xs + kCols;
  S* vs = yds + kK;

  for (int t = 0; t < n_steps; ++t) {
    // y_t - d on lanes < k (zero elsewhere)
    const S yd = obs ? __ldg(gy + (size_t)t * k + lane) - d : S(0);
    S tky[kRows], mx0[kRows], mx1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) tky[r] = mx0[r] = mx1[r] = S(0);
    S zx0 = S(0), zx1 = S(0), fv = S(0);
    // every lane writes its entries, then reads all of them back as
    // broadcasts, four floats (two doubles) a load
#pragma unroll
    for (int r = 0; r < kRows; ++r) xs[lane + 32 * r] = x[r];
    if (lane < kK) yds[lane] = yd;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kK; j += 4) {
      S ydj[4];
      load4(yds + j, ydj);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < kRows; ++r) tky[r] += tk[r][j + q] * ydj[q];
    }
#pragma unroll
    for (int l = 0; l < kCols; l += 4) {
      S xl[4];
      load4(xs + l, xl);
#pragma unroll
      for (int q = 0; q < 4; q += 2) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          mx0[r] += m[r][l + q] * xl[q];
          mx1[r] += m[r][l + q + 1] * xl[q + 1];
        }
        zx0 += z[l + q] * xl[q];
        zx1 += z[l + q + 1] * xl[q + 1];
      }
    }
    const S v = yd - (zx0 + zx1);
    if (lane < kK) vs[lane] = v;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kK; j += 4) {
      S vj[4];
      load4(vs + j, vj);
#pragma unroll
      for (int q = 0; q < 4; ++q) fv += fi[j + q] * vj[q];
    }
    // v on lanes < k; v' F^{-1} v = sum_i v_i (F^{-1} v)_i
    S quad = v * fv;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      quad += __shfl_xor_sync(kAll, quad, off);
    ll = (ll + cnst) - S(0.5) * quad;
#pragma unroll
    for (int r = 0; r < kRows; ++r) x[r] = (mx0[r] + mx1[r]) + tky[r];
  }
  if (lane == 0) gll[b] = ll;
}

template <typename S, int kRows, int kK>
int launch_tail(const void* y, const void* M, const void* TK, const void* Z,
                const void* d, const void* Finv, const void* cnst,
                const void* x0, void* ll, int batch, int n, int k,
                int n_steps, cudaStream_t stream) {
  const int blocks = (batch + kTailDraws - 1) / kTailDraws;
  filter_tail_kernel<S, kRows, kK><<<blocks, 32 * kTailDraws, 0, stream>>>(
      static_cast<const S*>(y), static_cast<const S*>(M),
      static_cast<const S*>(TK), static_cast<const S*>(Z),
      static_cast<const S*>(d), static_cast<const S*>(Finv),
      static_cast<const S*>(cnst), static_cast<const S*>(x0),
      static_cast<S*>(ll), batch, n, k, n_steps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The large-state variant, for n > kTailMaxN or k > kTailMaxK: one block per
// draw, its threads spread over the n + k rows of the stacked step
//
//   [x_{t+1}]   [M  TK] [x_t    ]          v_t = (y_t - d) - Z x_t,
//   [Z x_t  ] = [Z   0] [y_t - d],
//
// a row a thread (rows r, r + blockDim.x, ...).  u = [x_t; y_t - d] lives
// in shared memory in two buffers: a step reads one and writes x_{t+1} and
// y_{t+1} - d into the other, and writes v_t into one of two v buffers, so
// that one block barrier a step is all the synchronisation.  Warp 0 adds
// v_t' F^{-1} v_t to the log-likelihood during step t + 1 (a warp
// reduction; any k).  With kSmem the stacked matrix [M TK; Z 0] is copied
// once into shared memory, rows of odd length (no bank conflicts when each
// thread walks its own row), and F^{-1} beside it; without it (the matrix
// does not fit) every step reads the rows from device memory, where L2
// keeps them, through the read-only path.
// ---------------------------------------------------------------------------

constexpr int kTailLargeMaxThreads = 256;

// Shared memory of the large-state kernel's vectors (two u buffers, two v
// buffers and d), and of its matrices with kSmem, in elements.
struct TailLargeLayout {
  int nk, lda, u, v, d, A, Finv, vec_total, total;
  __host__ __device__ TailLargeLayout(int n, int k) {
    nk = n + k;
    lda = nk | 1;
    const int nk4 = (nk + 3) & ~3, k4 = (k + 3) & ~3;
    u = 0;
    v = u + 2 * nk4;
    d = v + 2 * k4;
    vec_total = d + k4;
    A = vec_total;
    Finv = A + nk * lda;
    total = Finv + k * k;
  }
};

template <typename S>
__device__ __forceinline__ S dot_row(const S* a, const S* u, int len) {
  S s0 = S(0), s1 = S(0), s2 = S(0), s3 = S(0);
  int l = 0;
  for (; l + 4 <= len; l += 4) {
    s0 += a[l] * u[l];
    s1 += a[l + 1] * u[l + 1];
    s2 += a[l + 2] * u[l + 2];
    s3 += a[l + 3] * u[l + 3];
  }
  for (; l < len; ++l) s0 += a[l] * u[l];
  return (s0 + s1) + (s2 + s3);
}

template <typename S>
__device__ __forceinline__ S ldg_dot_row(const S* __restrict__ a,
                                         const S* u, int len) {
  S s0 = S(0), s1 = S(0), s2 = S(0), s3 = S(0);
  int l = 0;
  for (; l + 4 <= len; l += 4) {
    s0 += __ldg(a + l) * u[l];
    s1 += __ldg(a + l + 1) * u[l + 1];
    s2 += __ldg(a + l + 2) * u[l + 2];
    s3 += __ldg(a + l + 3) * u[l + 3];
  }
  for (; l < len; ++l) s0 += __ldg(a + l) * u[l];
  return (s0 + s1) + (s2 + s3);
}

template <typename S, bool kSmem>
__global__ void __launch_bounds__(kTailLargeMaxThreads)
    filter_tail_large_kernel(const S* __restrict__ gy,
                             const S* __restrict__ gM,
                             const S* __restrict__ gTK,
                             const S* __restrict__ gZ,
                             const S* __restrict__ gd,
                             const S* __restrict__ gFinv,
                             const S* __restrict__ gconst,
                             const S* __restrict__ gx0, S* __restrict__ gll,
                             int n, int k, int n_steps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  S* sm = reinterpret_cast<S*>(smem_raw);
  const TailLargeLayout L(n, k);
  const int tid = threadIdx.x, lane = tid & 31, nthreads = blockDim.x;
  const size_t b = blockIdx.x;
  const size_t nn = (size_t)n * n, nk = (size_t)n * k;
  const S* M = gM + b * nn;
  const S* TK = gTK + b * nk;
  const S* Zb = gZ + b * nk;
  const S* Fb = gFinv + b * (size_t)k * k;
  const int nk4 = L.v / 2;
  S* u[2] = {sm + L.u, sm + L.u + nk4};
  S* vb[2] = {sm + L.v, sm + L.v + (L.d - L.v) / 2};
  S* dv = sm + L.d;
  S* A = sm + L.A;
  S* Fs = sm + L.Finv;

  if (kSmem) {
    // [M TK; Z 0], rows of length lda (odd), and F^{-1}
    for (int e = tid; e < L.nk * L.lda; e += nthreads) {
      const int r = e / L.lda, c = e - r * L.lda;
      S val = S(0);
      if (r < n) {
        if (c < n) val = M[(size_t)r * n + c];
        else if (c < L.nk) val = TK[(size_t)r * k + (c - n)];
      } else if (c < n) {
        val = Zb[(size_t)(r - n) * n + c];
      }
      A[e] = val;
    }
    for (int e = tid; e < k * k; e += nthreads) Fs[e] = Fb[e];
  }
  for (int i = tid; i < k; i += nthreads) dv[i] = gd[b * k + i];
  for (int i = tid; i < n; i += nthreads) u[0][i] = gx0[b * n + i];
  __syncthreads();
  if (n_steps > 0)
    for (int i = tid; i < k; i += nthreads)
      u[0][n + i] = __ldg(gy + i) - dv[i];
  const S cnst = gconst[b];
  const S* F = kSmem ? Fs : Fb;
  S ll = S(0);   // warp 0's
  // warp 0: ll += const - v' F^{-1} v / 2
  auto add_quad = [&](const S* vt) {
    S q = S(0);
    for (int i = lane; i < k; i += 32) {
      const S fv = kSmem ? dot_row(F + (size_t)i * k, vt, k)
                         : ldg_dot_row(F + (size_t)i * k, vt, k);
      q += vt[i] * fv;
    }
    for (int off = 16; off > 0; off >>= 1)
      q += __shfl_xor_sync(0xffffffffu, q, off);
    ll = (ll + cnst) - S(0.5) * q;
  };
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    const S* cur = u[t & 1];
    S* nxt = u[(t + 1) & 1];
    S* vt = vb[t & 1];
    if (tid < 32 && t > 0) add_quad(vb[(t - 1) & 1]);
    for (int r = tid; r < L.nk; r += nthreads) {
      S s;
      if (kSmem) {
        s = dot_row(A + (size_t)r * L.lda, cur, r < n ? L.nk : n);
      } else if (r < n) {
        s = ldg_dot_row(M + (size_t)r * n, cur, n) +
            ldg_dot_row(TK + (size_t)r * k, cur + n, k);
      } else {
        s = ldg_dot_row(Zb + (size_t)(r - n) * n, cur, n);
      }
      if (r < n) nxt[r] = s;
      else vt[r - n] = cur[r] - s;
    }
    if (t + 1 < n_steps)
      for (int i = tid; i < k; i += nthreads)
        nxt[n + i] = __ldg(gy + (size_t)(t + 1) * k + i) - dv[i];
    __syncthreads();
  }
  if (tid < 32) {
    if (n_steps > 0) add_quad(vb[(n_steps - 1) & 1]);
    if (lane == 0) gll[b] = ll;
  }
}

// Threads of the large-state block: a row each up to 256, at least two
// warps.
inline int tail_large_threads(int n, int k) {
  const int rows = ((n + k) + 31) & ~31;
  return rows < 64 ? 64 : (rows > kTailLargeMaxThreads ? kTailLargeMaxThreads
                                                       : rows);
}

// Shared memory of the large-state launch in this element size, and
// whether the matrices are in it.
inline size_t tail_large_smem(int n, int k, size_t elt, bool* in_smem) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const TailLargeLayout L(n, k);
  const size_t all = (size_t)L.total * elt;
  *in_smem = all <= (size_t)limit;
  return *in_smem ? all : (size_t)L.vec_total * elt;
}

template <typename S>
int launch_tail_large(const void* y, const void* M, const void* TK,
                      const void* Z, const void* d, const void* Finv,
                      const void* cnst, const void* x0, void* ll, int batch,
                      int n, int k, int n_steps, cudaStream_t stream) {
  bool in_smem = false;
  const size_t bytes = tail_large_smem(n, k, sizeof(S), &in_smem);
  const int threads = tail_large_threads(n, k);
  auto kernel = in_smem ? filter_tail_large_kernel<S, true>
                        : filter_tail_large_kernel<S, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, threads, bytes, stream>>>(
      static_cast<const S*>(y), static_cast<const S*>(M),
      static_cast<const S*>(TK), static_cast<const S*>(Z),
      static_cast<const S*>(d), static_cast<const S*>(Finv),
      static_cast<const S*>(cnst), static_cast<const S*>(x0),
      static_cast<S*>(ll), n, k, n_steps);
  return (int)cudaGetLastError();
}

template <typename S>
int launch_filter_tail(const void* y, const void* M, const void* TK,
                       const void* Z, const void* d, const void* Finv,
                       const void* cnst, const void* x0, void* ll, int batch,
                       int n, int k, int n_steps, cudaStream_t stream) {
  if (n > kTailMaxN || k > kTailMaxK) return (int)cudaErrorInvalidValue;
  if (n <= 32) {
    if (k <= 8)
      return launch_tail<S, 1, 8>(y, M, TK, Z, d, Finv, cnst, x0, ll, batch,
                                  n, k, n_steps, stream);
    return launch_tail<S, 1, 32>(y, M, TK, Z, d, Finv, cnst, x0, ll, batch,
                                 n, k, n_steps, stream);
  }
  if (k <= 8)
    return launch_tail<S, 2, 8>(y, M, TK, Z, d, Finv, cnst, x0, ll, batch, n,
                                k, n_steps, stream);
  return launch_tail<S, 2, 32>(y, M, TK, Z, d, Finv, cnst, x0, ll, batch, n,
                               k, n_steps, stream);
}

}  // namespace gcp

extern "C" {

// dtype: 0 = float32, 1 = float64.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue, without a launch, for n or k beyond the
// small-state kernel's range: gcp_filter_tail_large takes those).
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

// The launch's geometry: draws (one warp each) and threads per block, its
// static shared memory for n states and k observables in this element
// size, and the largest n and k the kernel takes.
int gcp_filter_tail_draws_per_block(void) { return gcp::kTailDraws; }
int gcp_filter_tail_block_threads(void) { return 32 * gcp::kTailDraws; }
size_t gcp_filter_tail_smem_bytes(int n, int k, int elem_size) {
  const int cols = n <= 32 ? 32 : 64, kk = k <= 8 ? 8 : 32;
  return (size_t)gcp::kTailDraws * (cols + 2 * kk) * elem_size;
}
int gcp_filter_tail_max_n(void) { return gcp::kTailMaxN; }
int gcp_filter_tail_max_k(void) { return gcp::kTailMaxK; }

// The large-state kernel, for any n and k (the same arguments).
int gcp_filter_tail_large(int dtype, const void* y, const void* M,
                          const void* TK, const void* Z, const void* d,
                          const void* Finv, const void* cnst, const void* x0,
                          void* ll, int batch, int n, int k, int n_steps,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch < 1) return 0;
  if (dtype == 0)
    return gcp::launch_tail_large<float>(y, M, TK, Z, d, Finv, cnst, x0, ll,
                                         batch, n, k, n_steps, s);
  return gcp::launch_tail_large<double>(y, M, TK, Z, d, Finv, cnst, x0, ll,
                                        batch, n, k, n_steps, s);
}

const char* gcp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
