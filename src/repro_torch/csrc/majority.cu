// Bitwise majority bundling for Hopper (sm_90a), plain C interface.
//
// Replaces majority_pallas / _majority_kernel of
// src/repro/kernels/majority/kernel.py: out[n] = (sum_m h[m, n]) * 2 > M over
// uint8 inputs [M, N] (N = B*d flattened), so even-M ties give 0. The
// reference sums the byte values as int32, not their bits, so every byte
// value counts as itself.
//
// What bounds it on the H100: bytes. It reads M*N bytes and writes N and does
// about M operations per output, far below the card's operations-per-byte
// balance. CUDA and not Triton: the body is short, and one build route for
// all the kernels keeps the build to one nvcc pass per source.
//
// Design. One thread per 16 consecutive outputs: for each row m one 16-byte
// load (a warp reads 512 consecutive bytes), four rows' loads issued before
// any is used, so they are in flight together, and one 16-byte store. The M axis, which
// the Pallas block keeps whole, is the loop inside the thread. The counts run
// in 16-bit lanes: w & 0x00FF00FF and (w >> 8) & 0x00FF00FF hold bytes 0, 2
// and 1, 3 of a word, each in its own 16-bit lane, and adding them as plain
// 32-bit words is exact for up to 257 rows (257 * 255 = 65535), so the lanes
// are flushed into 32-bit counters every 257 rows. count * 2 > M is decided as
// count > M / 2 (floor), which cannot overflow. Where the input is not all
// 16-byte rows on 16-byte addresses (N % 16 != 0, or a sliced input whose
// base is not aligned), a (row, chunk) that is not a whole 16 bytes on a
// 16-byte address is read a byte at a time; the tail chunk is stored a byte
// at a time.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 16;       // outputs (bytes) a thread
constexpr int FLUSH = 257;    // rows a 16-bit lane sums exactly
constexpr int UNROLL = 4;     // rows whose loads are in flight together
constexpr uint32_t LANES = 0x00FF00FFu;

// Bytes [i, i + VEC) of one row as four words, bytes past N as 0.
template <bool ALIGNED>
__device__ __forceinline__ uint4 load_chunk(const unsigned char* __restrict__ row, size_t i,
                                            size_t N) {
  const unsigned char* src = row + i;
  if (ALIGNED || (i + VEC <= N && reinterpret_cast<uintptr_t>(src) % VEC == 0)) {
    return *reinterpret_cast<const uint4*>(src);
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < VEC; ++b) {
    if (i + b < N) w[b / 4] |= (uint32_t)src[b] << (8 * (b % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ALIGNED: N % 16 == 0 and a 16-byte aligned base, so every chunk of every
// row is one 16-byte load. MT > 0: M = MT, known when compiled, so the row
// loops unroll whole (no flush: MT < 257); MT = 0: M read at run time.
template <bool ALIGNED, int MT>
__global__ void __launch_bounds__(THREADS)
majority_kernel(const unsigned char* __restrict__ h, unsigned char* __restrict__ out, int M_,
                int N) {
  const int M = MT > 0 ? MT : M_;
  const size_t i = ((size_t)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (i >= (size_t)N) return;
  uint32_t cnt[VEC];
#pragma unroll
  for (int b = 0; b < VEC; ++b) cnt[b] = 0;
  for (int m0 = 0; m0 < M; m0 += FLUSH) {
    const int m1 = min(M, m0 + FLUSH);
    uint32_t lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};   // bytes 4k, 4k+2 | 4k+1, 4k+3
    for (int m = m0; m < m1; m += UNROLL) {
      uint4 v[UNROLL];                          // the loads first, all in flight
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        v[u] = m + u < m1 ? load_chunk<ALIGNED>(h + (size_t)(m + u) * N, i, N)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          lo[k] += w[k] & LANES;
          hi[k] += (w[k] >> 8) & LANES;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      cnt[4 * k] += lo[k] & 0xFFFFu;
      cnt[4 * k + 1] += hi[k] & 0xFFFFu;
      cnt[4 * k + 2] += lo[k] >> 16;
      cnt[4 * k + 3] += hi[k] >> 16;
    }
  }
  const uint32_t half = (uint32_t)M / 2;   // count * 2 > M  <=>  count > floor(M / 2)
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[k] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) o[k] |= (uint32_t)(cnt[4 * k + b] > half) << (8 * b);
  }
  if (i + VEC <= (size_t)N) {              // out is a fresh, 16-byte aligned tensor
    *reinterpret_cast<uint4*>(out + i) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int b = 0; b < VEC; ++b) {
      if (i + b < (size_t)N) out[i + b] = (o[b / 4] >> (8 * (b % 4))) & 1;
    }
  }
}

template <bool ALIGNED, int MT>
int launch(const void* h, void* out, int M, int N, cudaStream_t stream) {
  const size_t chunks = ((size_t)N + VEC - 1) / VEC;
  const unsigned blocks = (unsigned)((chunks + THREADS - 1) / THREADS);
  majority_kernel<ALIGNED, MT><<<blocks, THREADS, 0, stream>>>((const unsigned char*)h,
                                                               (unsigned char*)out, M, N);
  return (int)cudaGetLastError();
}

// M = 1 .. 8 (the serve's M = m_tx among them) with M known when compiled:
// the row loads are issued together, and the serve's call sits on the
// launch floor (PERF.md)
template <int MT = 1>
int launch_small(const void* h, void* out, int M, int N, cudaStream_t stream) {
  if constexpr (MT <= 8) {
    return M == MT ? launch<true, MT>(h, out, M, N, stream)
                   : launch_small<MT + 1>(h, out, M, N, stream);
  } else {
    return launch<true, 0>(h, out, M, N, stream);
  }
}

}  // namespace

extern "C" int majority_bundle_launch(const void* h, void* out, int M, int N,
                                      void* stream) {
  const bool aligned = N % VEC == 0 && reinterpret_cast<uintptr_t>(h) % VEC == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return aligned ? launch_small(h, out, M, N, st) : launch<false, 0>(h, out, M, N, st);
}
