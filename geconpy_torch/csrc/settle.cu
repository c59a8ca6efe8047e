// K2 and K5 in the small-state tier: every draw of a block in its shared
// memory (settle.cuh's note).
#include "settle.cuh"

namespace gcp {

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

// Whether the small-state plan fits one draw a block in the device's
// shared memory (then gcp_settle / gcp_settle_filter run; else the large
// entry points).
int gcp_settle_fits(int dtype, int n, int k, int n_obs) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return gcp_settle_smem_bytes(dtype, n, k, n_obs) <= (size_t)limit;
}

}  // extern "C"
