// K2 and K5 in the device-memory tier: each draw's buffers in a float64
// workspace in device memory (settle.cuh's note).
#include "settle.cuh"

namespace gcp {

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

}  // namespace gcp

extern "C" {

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

}  // extern "C"
