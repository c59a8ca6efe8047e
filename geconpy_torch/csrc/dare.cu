// Batched DARE settle (predictive covariance fixed point): four warps per
// draw, one draw a block, the products on the FP64 tensor cores; the
// draw's matrices in shared memory or, for larger states, in device memory.
//
// Replaces the TPU kernel _dare_kernel (geconpy_tpu/ops/pallas_dare.py:37,
// reached through pallas_dare_settle).  For each draw, a fixed schedule:
// P = the unconditional covariance by lyap_iters Lyapunov doublings
// (P += A P A'; A = A A from A = T, P = RQR), then hewer_iters Hewer
// polishes, each
//   S = Z P Z' + H inverted by a pivoted Gauss-Jordan elimination,
//   Kp = T (P Z' S^{-1}),  A_cl = T - Kp Z,  Qc = sym(RQR + (Kp H) Kp'),
//   P = sym(Lyapunov doubling of (A_cl, Qc), inner_iters doublings),
// with sym(X) = (X + X') / 2.  Starting from the open-loop unconditional
// covariance matters: with H = 0 the DARE has several fixed points and the
// right one is the limit from there (geconpy_tpu/ops/kalman.py:287-294).
// The schedule has no early exit; the caller gates convergence outside the
// kernel with one Riccati step (dare_residual_settled).  The TPU wrapper
// pads the batch to whole lane tiles with H = I in the padded slots; here
// the grid is exactly one block per draw, so there is no padded slot.
//
// Precision: the kernel reads and writes the caller's dtype but runs the
// recursion in float64, as the settle kernels do: without measurement error
// S = Z P Z' is ill-conditioned on SW-2007.
//
// What bounds it on the H100.  On paper the operations: (lyap_iters +
// hewer_iters * inner_iters) * 3 n^3 multiply-adds per draw, ~7.4M at
// n = 26 with the default 12 + 8 * 16 schedule, on inputs of 2 n^2 + k n +
// k^2 values.  In fact the chain: 140 dependent doublings, each a few small
// products, and the warps of a draw issue about one instruction every ~5
// clocks.  An earlier design (one block of 256 threads per draw, one output
// entry per thread, two shared-memory loads per multiply-add on the FP64
// vector units, three block barriers a doubling, a block-wide elimination
// with three barriers a pivot) took 2.466 ms for 512 draws in float64,
// NVIDIA H100 80GB HBM3 at 700.00 W: ~17 us a doubling.  This design
// (small_linalg.cuh has the helpers and the tile layout):
//
//  * every product is tile_mm: mma.sync m16n8k4 in float64 on matrices
//    zero-padded to whole tiles, so that nothing tests a bound.  In the
//    doublings a warp takes 32 x 16 of the result at a time (kTall), so that
//    six shared-memory loads feed four mma, not eight: 0.492 against 0.535
//    ms with 16 x 16 items (same card and limit);
//  * a doubling takes two phases: A P and A A read the same A and go to
//    different buffers, so the four warps take both at once; P += (A P) A'
//    with the old A follows, then the doubling matrix changes buffers.  Two
//    block barriers a doubling, not three (tile_lyap_doubling, which the
//    settle kernels run in three phases for want of a fifth buffer);
//  * five n x n buffers (T, P, A and the doubling's two work buffers), Z
//    and H.  The Hewer step's n x k products, S and the elimination's
//    scratch live in the two work buffers, which the doubling does not use
//    then; RQR is read from device memory in the epilogue that adds it.  At
//    n = 26, k = 7 a draw takes 52,224 B of shared memory, so an SM holds
//    four draws and 512 draws run in one wave on 132 SMs;
//  * S^{-1} belongs to one warp (warp_solve_innovation: for k <= 8 a
//    Gauss-Jordan elimination in registers, a column per lane; above 8 in
//    shared memory), with the reference's pivot rule (first maximum, NaN
//    largest, ties to the lower row);
//  * A_cl = T - Kp Z and RQR + (Kp H) Kp' are epilogues of their products;
//    sym is a pass over the pairs (i, j), (j, i), in place: each pair is
//    summed once, so both entries get the reference's value.
//
// The large-state kernel.  Five n x n buffers of ceil32(n) rows exceed the
// 232,448 B a block may have from n = 65 on (k = 7), and the reference's
// kernel takes any n.  dare_large_kernel runs the same schedule on the same
// layout (dare_draw, shared by both kernels) with each block's buffers in a
// float64 workspace in device memory; the products read their operands
// through L1 and L2.  Its grid is persistent (the resident blocks, each
// striding over the batch), so the workspace is one layout per resident
// block whatever the batch: at 128 registers a thread, four an SM, 528 x
// 568 KB at n = 104 on an H100.  The wrapper picks the
// small-state kernel wherever one draw's layout fits (gcp_dare_fits).
#include "small_linalg.cuh"


namespace gcp {

constexpr int kDareWarps = 4;
constexpr int kDareThreads = 32 * kDareWarps;
constexpr int kDareMinBlocks = 4;   // draws an SM holds: 128 registers

// Offsets (in doubles) of one draw's shared memory, matrices in the tile
// layout; every size even, so that each buffer starts 16-byte aligned.
struct DareLayout {
  int ld, ldk, nr, kr;
  int T, P, A, Z, H, An, W, PZt, S, X, Kp, aug, col, row;
  int total;
  __host__ __device__ DareLayout(int n, int k) {
    nr = ceil32(n);   // stored rows: the doublings' 32-row items read them
    kr = ceil16(k);
    ld = tile_ld(n); ldk = tile_ld(k);
    int o = 0;
    T = o; o += nr * ld;
    P = o; o += nr * ld;
    A = o; o += nr * ld;    // the doubling matrix; A_cl
    Z = o; o += kr * ld;    // k x n
    H = o; o += kr * ldk;   // k x k
    // the doubling's work buffers An and W, and over them, during a Hewer
    // step, its n x k and k x k buffers and the elimination's scratch
    An = o;
    W = o + nr * ld;
    int s = o;
    PZt = s; s += nr * ldk;   // P Z'
    S = s; s += kr * ldk;     // S, then S^{-1}
    X = s; s += nr * ldk;     // P Z' S^{-1}, then Kp H
    Kp = s; s += nr * ldk;
    const int big = k > 8 ? 1 : 0;   // the shared-memory elimination
    aug = s; s += big * 2 * k * k;
    col = s; s += big * ceil8(k);
    row = s; s += big * ceil8(2 * k);
    total = s > o + 2 * nr * ld ? s : o + 2 * nr * ld;
  }
};

// P <- (P + P') / 2 over the logical entries, in place: one thread sums
// each pair once and writes both entries.
__device__ __forceinline__ void symmetrise(double* P, int n, int ld,
                                           int tid) {
  for (int e = tid; e < n * n; e += kDareThreads) {
    const int i = e / n, j = e - i * n;
    if (i <= j) {
      const double s = 0.5 * (P[i * ld + j] + P[j * ld + i]);
      P[i * ld + j] = s;
      P[j * ld + i] = s;
    }
  }
}

// One draw's whole schedule, its buffers at sm: shared memory in the
// small-state kernel, device memory in the large-state one (the same
// layout).  Every thread of the block takes part; the caller synchronises
// the block before sm is reused.
template <typename S>
__device__ __forceinline__ void dare_draw(
    const S* __restrict__ gT, const S* __restrict__ gRQR,
    const S* __restrict__ gZ, const S* __restrict__ gH, S* __restrict__ gP,
    const DareLayout& L, double* sm, size_t b, int n, int k, int lyap_iters,
    int hewer_iters, int inner_iters) {
  // the warp's number through a shuffle, so that the compiler knows it to
  // be the same in all lanes (no reconvergence code around the mma)
  const WarpCtx w{__shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0),
                  kDareWarps, (int)(threadIdx.x & 31)};
  const WarpCtx solo{0, 1, w.lane};
  const int tid = threadIdx.x;
  const int nn = n * n, kn = k * n;
  const int ld = L.ld, ldk = L.ldk;

  double* Tm = sm + L.T;
  double* P = sm + L.P;
  double* A = sm + L.A;
  double* Z = sm + L.Z;
  double* H = sm + L.H;
  double* An = sm + L.An;
  double* W = sm + L.W;
  double* PZt = sm + L.PZt;
  double* Sm = sm + L.S;
  double* X = sm + L.X;
  double* Kp = sm + L.Kp;
  const S* rqr = gRQR + b * nn;
  const S* no_g = nullptr;
  S* no_o = nullptr;
  auto sync = [] { __syncthreads(); };

  // ---- inputs, zero-padded: T, P = R Q R', Z, H.  Every other buffer is
  // written whole, pads included, before it is read.
  for (int e = tid; e < L.nr * ld; e += kDareThreads) {
    const int i = e / ld, j = e - i * ld;
    const bool in = i < n && j < n;
    Tm[e] = in ? double(gT[b * nn + i * n + j]) : 0.0;
    P[e] = in ? double(rqr[i * n + j]) : 0.0;
  }
  for (int e = tid; e < L.kr * ld; e += kDareThreads) {
    const int i = e / ld, j = e - i * ld;
    Z[e] = (i < k && j < n) ? double(gZ[b * kn + i * n + j]) : 0.0;
  }
  for (int e = tid; e < L.kr * ldk; e += kDareThreads) {
    const int i = e / ldk, j = e - i * ldk;
    H[e] = (i < k && j < k) ? double(gH[b * k * k + i * k + j]) : 0.0;
  }
  sync();

  // K = 0 start: the unconditional covariance of the stable transition
  tile_lyap_doubling<true>(Tm, P, A, An, W, n, ld, lyap_iters, w, sync);

  for (int h = 0; h < hewer_iters; ++h) {
    // PZt = P Z'
    tile_mm(tile_product(P, ld, Z, ld, true, n, n, k, PZt, ldk), no_g, 0,
            no_o, 0, w);
    sync();
    // one warp: S = Z PZt + H, then S^{-1} in its place
    if (w.warp == 0) {
      TileProduct s = tile_product(Z, ld, PZt, ldk, false, k, n, k, Sm, ldk);
      s.E = H;
      s.lde = ldk;
      tile_mm(s, no_g, 0, no_o, 0, solo);
      __syncwarp();
      double minpiv = INFINITY, logdet = 0.0;
      warp_solve_innovation<false>(Sm, ldk, nullptr, k, sm + L.aug,
                                   sm + L.col, sm + L.row, w.lane, minpiv,
                                   logdet);
    }
    sync();
    // X = PZt S^{-1}
    tile_mm(tile_product(PZt, ldk, Sm, ldk, false, n, k, k, X, ldk), no_g, 0,
            no_o, 0, w);
    sync();
    // Kp = T X
    tile_mm(tile_product(Tm, ld, X, ldk, false, n, n, k, Kp, ldk), no_g, 0,
            no_o, 0, w);
    sync();
    // A = A_cl = T - Kp Z;  X = Kp H
    TileProduct acl = tile_product(Kp, ldk, Z, ld, false, n, k, n, A, ld);
    acl.sign = -1.0;
    acl.E = Tm;
    acl.lde = ld;
    tile_mm(acl, no_g, 0, no_o, 0, w);
    tile_mm(tile_product(Kp, ldk, H, ldk, false, n, k, k, X, ldk), no_g, 0,
            no_o, 0, w);
    sync();
    // P = sym(RQR + (Kp H) Kp'), RQR added from device memory
    tile_mm(tile_product(X, ldk, Kp, ldk, true, n, k, n, P, ld), rqr, n, no_o,
            0, w);
    sync();
    symmetrise(P, n, ld, tid);
    sync();
    // P = sym(the Lyapunov doubling of (A_cl, Qc))
    tile_lyap_doubling<true>(A, P, A, An, W, n, ld, inner_iters, w, sync);
    symmetrise(P, n, ld, tid);
    sync();
  }
  for (int e = tid; e < nn; e += kDareThreads) {
    const int i = e / n, j = e - i * n;
    gP[b * nn + e] = S(P[i * ld + j]);
  }
}

// The small-state kernel: one draw a block, its buffers in shared memory.
template <typename S>
__global__ void __launch_bounds__(kDareThreads, kDareMinBlocks)
    dare_kernel(const S* __restrict__ gT, const S* __restrict__ gRQR,
                const S* __restrict__ gZ, const S* __restrict__ gH,
                S* __restrict__ gP, int n, int k, int lyap_iters,
                int hewer_iters, int inner_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DareLayout L(n, k);
  dare_draw(gT, gRQR, gZ, gH, gP, L, reinterpret_cast<double*>(smem_raw),
            blockIdx.x, n, k, lyap_iters, hewer_iters, inner_iters);
}

// The large-state kernel: the same schedule on the same layout, each
// block's buffers in a float64 workspace in device memory (gwork, L.total
// doubles a block) instead of shared memory.  The grid is persistent: as
// many blocks as are resident at once, each striding over the batch, so
// the workspace scales with the card, not with the batch.
template <typename S>
__global__ void __launch_bounds__(kDareThreads, kDareMinBlocks)
    dare_large_kernel(const S* __restrict__ gT, const S* __restrict__ gRQR,
                      const S* __restrict__ gZ, const S* __restrict__ gH,
                      S* __restrict__ gP, double* gwork, int batch, int n,
                      int k, int lyap_iters, int hewer_iters,
                      int inner_iters) {
  const DareLayout L(n, k);
  double* sm = gwork + (size_t)blockIdx.x * L.total;
  for (size_t b = blockIdx.x; b < (size_t)batch; b += gridDim.x) {
    dare_draw(gT, gRQR, gZ, gH, gP, L, sm, b, n, k, lyap_iters, hewer_iters,
              inner_iters);
    __syncthreads();   // P is written out before the next draw's inputs
  }
}

template <typename S>
int launch_dare(const void* T, const void* RQR, const void* Z, const void* H,
                void* P, int batch, int n, int k, int lyap_iters,
                int hewer_iters, int inner_iters, cudaStream_t stream) {
  const size_t bytes = (size_t)DareLayout(n, k).total * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      dare_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dare_kernel<S><<<batch, kDareThreads, bytes, stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(RQR),
      static_cast<const S*>(Z), static_cast<const S*>(H), static_cast<S*>(P),
      n, k, lyap_iters, hewer_iters, inner_iters);
  return (int)cudaGetLastError();
}

// The large-state launch: as many blocks as the card holds at once, at
// most one a draw, and the workspace they need.
struct DareLargePlan {
  int blocks;
  size_t work_bytes;
};

template <typename S>
DareLargePlan dare_large_plan(int n, int k, int batch) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dare_large_kernel<S>,
                                                kDareThreads, 0);
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  DareLargePlan p;
  p.blocks = batch < resident ? batch : resident;
  p.work_bytes = (size_t)p.blocks * DareLayout(n, k).total * sizeof(double);
  return p;
}

template <typename S>
int launch_dare_large(const void* T, const void* RQR, const void* Z,
                      const void* H, void* P, void* work, size_t work_bytes,
                      int batch, int n, int k, int lyap_iters,
                      int hewer_iters, int inner_iters, cudaStream_t stream) {
  const DareLargePlan plan = dare_large_plan<S>(n, k, batch);
  if (plan.blocks < 1) return 0;
  if (work == nullptr || work_bytes < plan.work_bytes)
    return (int)cudaErrorInvalidValue;
  dare_large_kernel<S><<<plan.blocks, kDareThreads, 0, stream>>>(
      static_cast<const S*>(T), static_cast<const S*>(RQR),
      static_cast<const S*>(Z), static_cast<const S*>(H), static_cast<S*>(P),
      static_cast<double*>(work), batch, n, k, lyap_iters, hewer_iters,
      inner_iters);
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

// Shared memory per block (one draw); the recursion is float64 for either
// I/O type.
size_t gcp_dare_smem_bytes(int n, int k) {
  return (size_t)gcp::DareLayout(n, k).total * sizeof(double);
}

// Threads per block (one draw).
int gcp_dare_block_threads(void) { return gcp::kDareThreads; }

// The large-state entry point: gcp_dare's arguments plus a float64
// workspace of work_bytes >= gcp_dare_large_work_bytes(...) in device
// memory (cudaErrorInvalidValue, without a launch, if it is smaller).
int gcp_dare_large(int dtype, const void* T, const void* RQR, const void* Z,
                   const void* H, void* P, void* work, size_t work_bytes,
                   int batch, int n, int k, int lyap_iters, int hewer_iters,
                   int inner_iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gcp::launch_dare_large<float>(T, RQR, Z, H, P, work, work_bytes,
                                         batch, n, k, lyap_iters, hewer_iters,
                                         inner_iters, s);
  return gcp::launch_dare_large<double>(T, RQR, Z, H, P, work, work_bytes,
                                        batch, n, k, lyap_iters, hewer_iters,
                                        inner_iters, s);
}

// Whether one draw's layout fits the device's shared memory (then gcp_dare
// runs; else gcp_dare_large).
int gcp_dare_fits(int n, int k) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return gcp_dare_smem_bytes(n, k) <= (size_t)limit;
}

// The workspace the large-state launch needs for this batch.
size_t gcp_dare_large_work_bytes(int dtype, int n, int k, int batch) {
  return dtype == 0 ? gcp::dare_large_plan<float>(n, k, batch).work_bytes
                    : gcp::dare_large_plan<double>(n, k, batch).work_bytes;
}

}  // extern "C"
