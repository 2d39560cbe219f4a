// Bipolar associative matmul for Hopper (sm_90a), plain C interface.
//
// Replaces assoc_matmul_pallas / _assoc_kernel of
// src/repro/kernels/assoc_matmul/kernel.py: dots[g, b, c] =
// sum_k (2 q[g,b,k] - 1) (2 p[g,c,k] - 1) for uint8 {0,1} inputs, written as
// f32. The bank axis g is the vmap the JAX serve wraps around the kernel
// (one bank per IMC core, or per (core, permuted bank)); G = 1 is the plain
// [B, K] x [C, K] product.
//
// What bounds it on the H100: at the serve's shapes (B = 256, C = 100,
// K = 512 per bank) it moves G*(B+C)*K bytes in and G*B*C*4 bytes out and
// does 2*G*B*C*K operations; its bound against the int8 peak (1,979 TOP/s) is
// set by the bytes. At tall shapes it becomes operation-bound. This first
// kernel uses __dp4a on the CUDA cores, not the tensor cores, so it sits far
// from the int8 peak there; wgmma is later work.
//
// Design. As in kernel.py:1-9, device memory holds the {0,1} bytes (1 B per
// element): a block stages a 64 x 64-byte tile of queries and one of
// prototypes into shared memory, turning each byte into a +-1 int8 lane as it
// stages, so the bipolar form never reaches device memory. Lanes at or past K
// stage as 0, so the contraction padding adds 0, never +1 (the mask at
// kernel.py:26-29). 256 threads each accumulate a 4 x 4 block of exact int32
// dots with __dp4a over four lanes at a time, then write f32 (exact, since
// |dot| <= K < 2^24, which the wrapper checks). The Pallas k grid axis and its
// VMEM accumulator become the loop over k tiles inside the block.

#include <cuda_runtime.h>
#include <cstddef>

namespace {

constexpr int BM = 64;         // queries per block
constexpr int BN = 64;         // classes per block
constexpr int BKW = 16;        // int8x4 words per k tile (64 bytes)
constexpr int THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each

// Four consecutive {0,1} bytes at row[k..k+3] as four +-1 int8 lanes; lanes at
// or past K are 0.
__device__ __forceinline__ int bipolar_word(const unsigned char* row, int k, int K) {
  int w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = (k + i < K) ? 2 * (int)row[k + i] - 1 : 0;
    w |= (v & 0xFF) << (8 * i);
  }
  return w;
}

__global__ void __launch_bounds__(THREADS)
assoc_matmul_kernel(const unsigned char* __restrict__ q,
                    const unsigned char* __restrict__ p, float* __restrict__ out,
                    int B, int C, int K) {
  __shared__ int qs[BM][BKW + 1];
  __shared__ int ps[BN][BKW + 1];
  const int g = blockIdx.z;
  const int c0 = blockIdx.x * BN;
  const int b0 = blockIdx.y * BM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const unsigned char* qg = q + (size_t)g * B * K;
  const unsigned char* pg = p + (size_t)g * C * K;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += 4 * BKW) {
    for (int i = threadIdx.x; i < BM * BKW; i += THREADS) {
      const int r = i / BKW, kw = i % BKW, k = k0 + 4 * kw;
      const int b = b0 + r, c = c0 + r;
      qs[r][kw] = b < B ? bipolar_word(qg + (size_t)b * K, k, K) : 0;
      ps[r][kw] = c < C ? bipolar_word(pg + (size_t)c * K, k, K) : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BKW; ++kw) {
      int a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[ty + 16 * i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ps[tx + 16 * j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (b < B && c < C) out[((size_t)g * B + b) * C + c] = (float)acc[i][j];
    }
  }
}

}  // namespace

extern "C" int assoc_matmul_launch(const void* q, const void* p, void* out, int G,
                                   int B, int C, int K, void* stream) {
  dim3 grid((C + BN - 1) / BN, (B + BM - 1) / BM, G);
  assoc_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)q, (const unsigned char*)p, (float*)out, B, C, K);
  return (int)cudaGetLastError();
}
