// Sparse-query vs packed-prototype Hamming kernels for Hopper (sm_90a),
// plain C interface.
//
// Replaces two TPU kernels of src/repro/kernels/sparse/kernel.py:
//   * sparse_search_pallas / _search_kernel -> sparse_search_kernel
//     full distances [B, C] int32.
//   * sparse_topk_banked_pallas / _topk_banked_kernel -> sparse_topk_banked_kernel
//     per-bank fused top-1 (min distance, first argmin).
// Both compute dist = |q| + popcount(p) - 2 * |q AND p|, the overlap by
// gathering the word that holds each query index and testing its bit.
//
// What bounds them on the H100: the bytes they must move are the index
// lists, the prototype rows and the outputs, 4*(B*k + C*W) (+ outputs); at
// d = 2^20 the prototypes dominate (128 KB a row). The work is B*C*k
// gathers, which at the serve shape (G = 64, B = 256, C = 100, k = 2048) is
// 3.4e9, far more than the bytes: the kernels are bound by the gathers.
//
// Design. A TPU grid step holds a tile of whole prototype rows in VMEM; here
// a row of 128 KB fills most of one block's shared memory. So a block stages
// R rows (as many as fit 200 KB, at most 32) in shared memory with
// coalesced 16-byte loads, and every gather is a shared-memory read; the
// index lists are read through L1 (__ldg), never staged (32 lists of 2048
// slots would be 256 KB). |p| is counted once per row by a pre-pass kernel
// (row_popcount_kernel) into a scratch vector, not once per query tile. A
// warp owns one query at a time: its lanes stride over the k slots, skip
// SENTINEL slots (and any entry outside the row) without dereferencing them,
// and one warp reduction gives the distance. Empty queries (all SENTINEL)
// get dist = |p|.
//
// Top-1 ordering. One block owns a (bank, tile of 32 queries) and walks the
// bank's rows in increasing order; each query belongs to one warp, which
// meets the classes in increasing order and replaces its best only on a
// strictly smaller distance, so the first minimum wins, the tie rule of
// kernel.py:89-113, with no cross-warp reduction and no dist*C + col key
// (which overflows int32 at C = 6400, d = 2^20). Columns at or past c_real
// are never visited (the reference poisons them; the same result while
// c_real >= 1, which the wrapper checks).

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int QB = 32;               // queries per block
constexpr int QPW = QB / WARPS;      // queries per warp
constexpr int SENTINEL = 0x7fffffff;
constexpr int ROWS_MAX = 32;
constexpr int SMEM_BUDGET = 200 * 1024;
constexpr unsigned FULL = 0xffffffffu;

constexpr int MAX_GRID_Y = 65535;

// Prototype rows staged in shared memory at once; 0 when one row of W words
// does not fit (the launch then refuses the shape).
int rows_per_tile(int W) {
  if (W <= 0 || W > SMEM_BUDGET / 4) return 0;
  const int r = SMEM_BUDGET / (4 * W);
  return r > ROWS_MAX ? ROWS_MAX : r;
}

// Copy n contiguous words from global to shared memory, 16 bytes a load
// where the source is aligned.
__device__ __forceinline__ void stage_rows(int* dst, const int* __restrict__ src,
                                           size_t n) {
  if ((n & 3) == 0 && (reinterpret_cast<size_t>(src) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (size_t i = threadIdx.x; i < n / 4; i += THREADS) d4[i] = __ldg(s4 + i);
  } else {
    for (size_t i = threadIdx.x; i < n; i += THREADS) dst[i] = __ldg(src + i);
  }
}

// |q| - 2*|q AND row| of one query against one staged row, summed over the
// warp (every lane gets the sum).
__device__ __forceinline__ int warp_partial(const int* __restrict__ qrow, int K,
                                            const int* row, int W) {
  int acc = 0;
  for (int i = threadIdx.x & 31; i < K; i += 32) {
    const int x = __ldg(qrow + i);
    if (x == SENTINEL) continue;
    const unsigned w = static_cast<unsigned>(x) >> 5;
    acc += 1;
    if (w < static_cast<unsigned>(W)) acc -= 2 * ((row[w] >> (x & 31)) & 1);
  }
  return __reduce_add_sync(FULL, acc);
}

__global__ void __launch_bounds__(THREADS)
row_popcount_kernel(const int* __restrict__ p, int* __restrict__ pop, int W) {
  __shared__ int part[WARPS];
  const int* row = p + static_cast<size_t>(blockIdx.x) * W;
  int acc = 0;
  for (int i = threadIdx.x; i < W; i += THREADS) acc += __popc(__ldg(row + i));
  acc = __reduce_add_sync(FULL, acc);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += part[k];
    pop[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
sparse_search_kernel(const int* __restrict__ q, const int* __restrict__ p,
                     const int* __restrict__ pop, int* __restrict__ out, int B,
                     int C, int W, int K, int R) {
  extern __shared__ int4 smem4[];
  int* rows = reinterpret_cast<int*>(smem4);   // [R][W]
  const int b0 = blockIdx.x * QB;
  const int c0 = blockIdx.y * R;
  const int r = min(R, C - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage_rows(rows, p + static_cast<size_t>(c0) * W, static_cast<size_t>(r) * W);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const int b = b0 + warp + WARPS * j;
    if (b >= B) continue;   // warp-uniform
    const int* qrow = q + static_cast<size_t>(b) * K;
    for (int rr = 0; rr < r; ++rr) {
      const int d = warp_partial(qrow, K, rows + static_cast<size_t>(rr) * W, W) +
                    pop[c0 + rr];
      if (lane == 0) out[static_cast<size_t>(b) * C + c0 + rr] = d;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
sparse_topk_banked_kernel(const int* __restrict__ q, const int* __restrict__ p,
                          const int* __restrict__ pop, int* __restrict__ dist,
                          int* __restrict__ idx, int B, int C, int W, int K,
                          int c_real, int R) {
  extern __shared__ int4 smem4[];
  int* rows = reinterpret_cast<int*>(smem4);   // [R][W]
  const int g = blockIdx.y;
  const int b0 = blockIdx.x * QB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* pg = p + static_cast<size_t>(g) * C * W;
  const int* popg = pop + static_cast<size_t>(g) * C;

  int best_d[QPW], best_c[QPW];
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    best_d[j] = INT_MAX;
    best_c[j] = INT_MAX;
  }
  const int c_end = min(C, c_real);
  for (int c0 = 0; c0 < c_end; c0 += R) {
    const int r = min(R, c_end - c0);
    __syncthreads();   // the previous tile is consumed
    stage_rows(rows, pg + static_cast<size_t>(c0) * W, static_cast<size_t>(r) * W);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int b = b0 + warp + WARPS * j;
      if (b >= B) continue;   // warp-uniform
      const int* qrow = q + (static_cast<size_t>(g) * B + b) * K;
      for (int rr = 0; rr < r; ++rr) {
        const int d = warp_partial(qrow, K, rows + static_cast<size_t>(rr) * W, W) +
                      popg[c0 + rr];
        if (d < best_d[j]) {   // strict: the earlier class keeps a tie
          best_d[j] = d;
          best_c[j] = c0 + rr;
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int b = b0 + warp + WARPS * j;
      if (b < B) {
        dist[static_cast<size_t>(g) * B + b] = best_d[j];
        idx[static_cast<size_t>(g) * B + b] = best_c[j];
      }
    }
  }
}

// Opt in to `bytes` of dynamic shared memory on every launch (the 48 KB
// default covers static and dynamic memory together).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" int sparse_search_launch(const void* q, const void* p, void* pop, void* out,
                                    int B, int C, int W, int K, void* stream) {
  const int R = rows_per_tile(W);
  if (R == 0 || (C + R - 1) / R > MAX_GRID_Y) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_popcount_kernel<<<C, THREADS, 0, s>>>(static_cast<const int*>(p),
                                             static_cast<int*>(pop), W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(R) * W * sizeof(int);
  err = allow_smem(sparse_search_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((B + QB - 1) / QB, (C + R - 1) / R);
  sparse_search_kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const int*>(q), static_cast<const int*>(p),
      static_cast<const int*>(pop), static_cast<int*>(out), B, C, W, K, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sparse_topk_banked_launch(const void* q, const void* p, void* pop,
                                         void* dist, void* idx, int G, int B, int C,
                                         int W, int K, int c_real, void* stream) {
  const int R = rows_per_tile(W);
  if (R == 0 || G > MAX_GRID_Y) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_popcount_kernel<<<G * C, THREADS, 0, s>>>(static_cast<const int*>(p),
                                                 static_cast<int*>(pop), W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(R) * W * sizeof(int);
  err = allow_smem(sparse_topk_banked_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((B + QB - 1) / QB, G);
  sparse_topk_banked_kernel<<<grid, THREADS, smem, s>>>(
      static_cast<const int*>(q), static_cast<const int*>(p),
      static_cast<const int*>(pop), static_cast<int*>(dist), static_cast<int*>(idx),
      B, C, W, K, c_real, R);
  return static_cast<int>(cudaGetLastError());
}
