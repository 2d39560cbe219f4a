// Rate of the 1-bit tensor-core product on Hopper (sm_90a):
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc, the product the
// port's packed Hamming search and top-k run (src/repro_torch/csrc/hamming.cu).
// NVIDIA publishes no 1-bit peak for the H100; chip_smoke.py bounds the
// Hamming kernels by this rate. Built and driven by
// benchmarks/torch_hamming_b1_probe.py; not part of the port's kernel library.
//
// b1_peak_kernel: every warp runs 8 independent b1 products on registers in a
// loop, the instruction's rate without memory traffic.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ void mma_b1(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void b1_peak_kernel(int* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + 1) + i;
  b[0] = seed ^ threadIdx.x;
  b[1] = ~seed + threadIdx.x;
  int d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_b1(d[j], a, b);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int b1_peak_launch(void* out, int blocks, int threads, int iters, void* stream) {
  b1_peak_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((int*)out, iters, 12345u);
  return (int)cudaGetLastError();
}
