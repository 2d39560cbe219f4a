// Bitwise majority bundling for Hopper (sm_90a), plain C interface.
//
// Replaces majority_pallas / _majority_kernel of
// src/repro/kernels/majority/kernel.py: out[n] = (sum_m h[m, n]) * 2 > M over
// uint8 {0,1} inputs [M, N] (N = B*d flattened), so even-M ties give 0.
//
// What bounds it on the H100: bytes. It reads M*N bytes and writes N and does
// about M operations per output, far below the card's operations-per-byte
// balance. CUDA and not Triton: the body is a dozen lines, and one build route
// for all four kernels keeps the build to one nvcc pass per source.
//
// Design. One thread per four consecutive outputs; for each m a warp reads
// 128 consecutive bytes, so every load is coalesced. The M axis, which the
// Pallas block keeps whole, is the loop inside the thread.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;

__global__ void __launch_bounds__(THREADS)
majority_kernel(const unsigned char* __restrict__ h, unsigned char* __restrict__ out,
                int M, int N) {
  const size_t base = ((size_t)blockIdx.x * THREADS + threadIdx.x) * PER_THREAD;
  int cnt[PER_THREAD] = {0, 0, 0, 0};
  for (int m = 0; m < M; ++m) {
    const unsigned char* row = h + (size_t)m * N;
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      if (base + i < (size_t)N) cnt[i] += row[base + i];
    }
  }
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    if (base + i < (size_t)N) out[base + i] = cnt[i] * 2 > M ? 1 : 0;
  }
}

}  // namespace

extern "C" int majority_bundle_launch(const void* h, void* out, int M, int N,
                                      void* stream) {
  const int per_block = THREADS * PER_THREAD;
  majority_kernel<<<(N + per_block - 1) / per_block, THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)h, (unsigned char*)out, M, N);
  return (int)cudaGetLastError();
}
