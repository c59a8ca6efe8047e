// Rate and latency of the float64 mma.sync shapes on one GPU.
//
// Build and run on a machine with the card (no PyTorch needed):
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/dmma_rate \
//        tools/dmma_rate.cu && build/dmma_rate
//
// For each shape (m8n8k4, m16n8k4, m16n8k8, m16n8k16) it times a loop of
// mma on register operands, once with one dependent chain in one warp per
// SM (the latency of an mma) and once with four chains per warp and 16 or
// 32 warps per SM (the rate of the card), and prints TFLOP/s and clocks per
// mma at the SM clock given below.  This is what decided the shape that
// tile_mm (geconpy_torch/csrc/small_linalg.cuh) uses.
#include <cstdio>
#include <cuda_runtime.h>

constexpr double kClockGHz = 1.755;   // H100 SXM boost clock, for the clocks column

__device__ __forceinline__ void m884(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1},{%2},{%3},{%0,%1};"
               : "+d"(c[0]), "+d"(c[1]) : "d"(a[0]), "d"(b[0]));
}
__device__ __forceinline__ void m1684(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5},{%6},{%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}
__device__ __forceinline__ void m1688(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5,%6,%7},{%8,%9},{%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}
__device__ __forceinline__ void m16816(double* c, const double* a, const double* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3},{%4,%5,%6,%7,%8,%9,%10,%11},{%12,%13,%14,%15},{%0,%1,%2,%3};"
               : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
                 "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <int kShape, int kChains>
__global__ void loop(double* out, int iters, double seed) {
  double a[8], b[4], c[kChains][4];
  for (int i = 0; i < 8; ++i) a[i] = seed + threadIdx.x * 1e-9 + i;
  for (int i = 0; i < 4; ++i) b[i] = seed * 0.5 + i;
  for (int q = 0; q < kChains; ++q)
    for (int i = 0; i < 4; ++i) c[q][i] = 0.0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int q = 0; q < kChains; ++q) {
      if (kShape == 0) m884(c[q], a, b);
      if (kShape == 1) m1684(c[q], a, b);
      if (kShape == 2) m1688(c[q], a, b);
      if (kShape == 3) m16816(c[q], a, b);
    }
  }
  double s = 0.0;
  for (int q = 0; q < kChains; ++q)
    for (int i = 0; i < 4; ++i) s += c[q][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kShape, int kChains>
void run(const char* name, double fma_per_mma, int threads, int blocks_per_sm,
         int sms) {
  double* out;
  cudaMalloc(&out, sizeof(double) * sms * blocks_per_sm * threads);
  const int iters = 20000;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  loop<kShape, kChains><<<sms * blocks_per_sm, threads>>>(out, 100, 1.0);
  cudaEventRecord(e0);
  loop<kShape, kChains><<<sms * blocks_per_sm, threads>>>(out, iters, 1.0);
  cudaEventRecord(e1);
  cudaDeviceSynchronize();
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double warps_per_sm = blocks_per_sm * threads / 32.0;
  const double mma_per_sm = warps_per_sm * iters * kChains;
  const double clocks = ms * 1e-3 * kClockGHz * 1e9;
  printf("%-9s %d chain(s) a warp, %2.0f warps/SM: %7.3f ms, %6.2f TFLOP/s, "
         "%5.1f clocks per mma per SM, %6.1f per warp  [%s]\n",
         name, kChains, warps_per_sm, ms,
         2.0 * mma_per_sm * sms * fma_per_mma / ms / 1e9, clocks / mma_per_sm,
         clocks / (iters * kChains), cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  cudaDeviceProp prop;
  if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
    fprintf(stderr, "dmma_rate: no CUDA device\n");
    return 2;
  }
  const int sms = prop.multiProcessorCount;
  printf("%s, %d SMs\n", prop.name, sms);
  run<0, 1>("m8n8k4", 256, 32, 1, sms);
  run<0, 4>("m8n8k4", 256, 128, 4, sms);
  run<0, 4>("m8n8k4", 256, 256, 4, sms);
  run<1, 1>("m16n8k4", 512, 32, 1, sms);
  run<1, 4>("m16n8k4", 512, 128, 4, sms);
  run<1, 4>("m16n8k4", 512, 256, 4, sms);
  run<2, 1>("m16n8k8", 1024, 32, 1, sms);
  run<2, 4>("m16n8k8", 1024, 128, 4, sms);
  run<3, 1>("m16n8k16", 2048, 32, 1, sms);
  run<3, 4>("m16n8k16", 2048, 128, 4, sms);
  return 0;
}
