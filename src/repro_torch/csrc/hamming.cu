// Packed Hamming search kernels for Hopper (sm_90a), plain C interface.
//
// Replaces four TPU kernels of src/repro/kernels/hamming/kernel.py:
//   * hamming_topk_banked_pallas / _topk_banked_kernel -> hamming_topk_banked_kernel
//     per-bank fused top-1 (min distance, first argmin) over XOR+popcount.
//   * hamming_topk_k_banked_pallas / _topk_k_banked_kernel -> hamming_topk_k_banked_kernel
//     per-bank fused top-k, rank-sorted ascending by (distance, class index).
//   * hamming_pallas / _hamming_kernel -> hamming_search_kernel
//     full distances [B, C] int32.
//   * hamming_banked_pallas / _hamming_banked_kernel -> the same kernel with
//     a bank axis in the grid: per-bank full distances [G, B, C] int32.
//
// What bounds them on the H100: none has a tensor-core form. The top-1 and
// top-k read G*(B+C)*W*4 bytes and write 8 bytes per query and rank, so at
// the serve's shapes (W = 16 words) they are small and latency-bound; their
// arithmetic is G*B*C*W popcounts, and __popc issues at a quarter of the
// int32 ALU rate, so at tall shapes (C per core in the thousands, W = 64)
// they are popcount-bound. The full searches also write B*C*4 bytes, which
// bounds them when W is small.
//
// Design. The Pallas grid walks the class axis in order and carries the
// running (min, argmin) in a revisited VMEM tile; here that axis becomes a
// loop inside one block. A block owns one bank and a tile of QB queries,
// staged once in shared memory; it streams the bank's prototypes through
// shared memory one tile of 128 rows at a time (row stride W+1 words, so the
// 32 lanes of a warp read 32 different banks). Each thread owns one class row
// of the tile and keeps, in registers, the running best (dist, col) of each
// of the QB queries; it meets its classes in increasing order and replaces
// only on a strictly smaller distance. At the end a lexicographic
// (dist, col) reduction over the block (warp shuffles, then the warps in
// order) gives the first minimum, exactly the tie rule of kernel.py:93-105.
// Columns at or past c_real are never visited, which equals the reference's
// 2^30 poison whenever c_real >= 1 (the wrapper checks that). The full search
// uses the same staging with one class per thread and QB accumulators, and
// writes each query's row of 128 distances with coalesced stores; its grid's
// z axis is the bank.
//
// Top-k. The TPU kernel merges a [bq, k] buffer of int32 keys dist*c_pad +
// col with each tile by k rounds of min-extraction; that key overflows int32
// once (d+1)*C reaches 2^31. Here each query keeps a sorted buffer of its k
// best (dist, col) pairs in shared memory and pairs are compared, so there is
// no overflow limit. The tile's distances go to shared memory; then one warp
// per query walks the tile's columns in increasing order (a ballot of the
// columns that beat the buffer's worst entry, then one column at a time) and
// inserts each survivor after every buffered entry of equal or smaller
// distance. Every buffered column is smaller than every column of the tile,
// so that position is the lexicographic (dist, col) rank, and a column whose
// distance only ties the worst entry of a full buffer never enters: every
// rank keeps the first-minimum rule across tiles. The buffer starts full of
// (INT_MAX, INT_MAX) pairs, which no real distance reaches.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>

namespace {

constexpr int THREADS = 128;  // class rows per tile, one per thread
constexpr int QB = 32;        // queries per block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_K = 256;    // top-k buffer ranks (the merge's registers: MAX_K / 32 a lane)
constexpr size_t SMEM_MAX = 232448;  // shared memory one block may opt in to
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool lex_less(int d1, int c1, int d2, int c2) {
  return d1 < d2 || (d1 == d2 && c1 < c2);
}

// Stage QB query rows [QB][W] (zero past B) and return nothing; callers sync.
__device__ __forceinline__ void stage_queries(int* qs, const int* q, int b0,
                                              int B, int W) {
  for (int i = threadIdx.x; i < QB * W; i += THREADS) {
    const int b = b0 + i / W;
    qs[i] = b < B ? q[(size_t)b * W + i % W] : 0;
  }
}

// Stage `rows` prototype rows starting at c0 into ps with row stride W + 1.
__device__ __forceinline__ void stage_protos(int* ps, const int* p, int c0,
                                             int rows, int W) {
  for (int i = threadIdx.x; i < rows * W; i += THREADS) {
    const int r = i / W, w = i % W;
    ps[r * (W + 1) + w] = p[(size_t)(c0 + r) * W + w];
  }
}

__global__ void __launch_bounds__(THREADS)
hamming_topk_banked_kernel(const int* __restrict__ q, const int* __restrict__ p,
                           int* __restrict__ dist, int* __restrict__ idx,
                           int B, int C, int W, int c_real) {
  extern __shared__ int smem[];
  int* qs = smem;            // [QB][W]
  int* ps = smem + QB * W;   // [THREADS][W + 1]
  __shared__ int red_d[THREADS / 32][QB];
  __shared__ int red_c[THREADS / 32][QB];

  const int g = blockIdx.y;
  const int b0 = blockIdx.x * QB;
  const int t = threadIdx.x;
  const int* pg = p + (size_t)g * C * W;
  stage_queries(qs, q + (size_t)g * B * W, b0, B, W);

  int best_d[QB], best_c[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    best_d[j] = INT_MAX;
    best_c[j] = INT_MAX;
  }

  const int c_end = min(C, c_real);
  for (int c0 = 0; c0 < c_end; c0 += THREADS) {
    const int rows = min(THREADS, c_end - c0);
    __syncthreads();  // the previous tile is consumed (and qs is staged)
    stage_protos(ps, pg, c0, rows, W);
    __syncthreads();
    if (t < rows) {
      int acc[QB];
#pragma unroll
      for (int j = 0; j < QB; ++j) acc[j] = 0;
      const int* pr = ps + t * (W + 1);
      for (int w = 0; w < W; ++w) {
        const int pw = pr[w];
#pragma unroll
        for (int j = 0; j < QB; ++j) acc[j] += __popc(qs[j * W + w] ^ pw);
      }
      const int c = c0 + t;
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        if (acc[j] < best_d[j]) {  // strict: the earlier class keeps a tie
          best_d[j] = acc[j];
          best_c[j] = c;
        }
      }
    }
  }

  const int lane = t & 31, warp = t >> 5;
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    int d = best_d[j], c = best_c[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int d2 = __shfl_down_sync(0xffffffffu, d, off);
      const int c2 = __shfl_down_sync(0xffffffffu, c, off);
      if (lex_less(d2, c2, d, c)) {
        d = d2;
        c = c2;
      }
    }
    if (lane == 0) {
      red_d[warp][j] = d;
      red_c[warp][j] = c;
    }
  }
  __syncthreads();
  if (t < QB && b0 + t < B) {
    int d = red_d[0][t], c = red_c[0][t];
#pragma unroll
    for (int k = 1; k < THREADS / 32; ++k) {
      if (lex_less(red_d[k][t], red_c[k][t], d, c)) {
        d = red_d[k][t];
        c = red_c[k][t];
      }
    }
    dist[(size_t)g * B + b0 + t] = d;
    idx[(size_t)g * B + b0 + t] = c;
  }
}

__global__ void __launch_bounds__(THREADS)
hamming_search_kernel(const int* __restrict__ q, const int* __restrict__ p,
                      int* __restrict__ out, int B, int C, int W) {
  extern __shared__ int smem[];
  int* qs = smem;            // [QB][W]
  int* ps = smem + QB * W;   // [THREADS][W + 1]
  const int c0 = blockIdx.x * THREADS;
  const int b0 = blockIdx.y * QB;
  const size_t g = blockIdx.z;  // bank (0 for the unbanked search)
  const int t = threadIdx.x;
  const int rows = min(THREADS, C - c0);
  q += g * B * W;
  p += g * C * W;
  out += g * B * C;
  stage_queries(qs, q, b0, B, W);
  stage_protos(ps, p, c0, rows, W);
  __syncthreads();
  if (t >= rows) return;
  int acc[QB];
#pragma unroll
  for (int j = 0; j < QB; ++j) acc[j] = 0;
  const int* pr = ps + t * (W + 1);
  for (int w = 0; w < W; ++w) {
    const int pw = pr[w];
#pragma unroll
    for (int j = 0; j < QB; ++j) acc[j] += __popc(qs[j * W + w] ^ pw);
  }
#pragma unroll
  for (int j = 0; j < QB; ++j) {
    if (b0 + j < B) out[(size_t)(b0 + j) * C + c0 + t] = acc[j];
  }
}

__global__ void __launch_bounds__(THREADS)
hamming_topk_k_banked_kernel(const int* __restrict__ q, const int* __restrict__ p,
                             int* __restrict__ dist, int* __restrict__ idx,
                             int B, int C, int W, int c_real, int K) {
  extern __shared__ int smem[];
  int* qs = smem;                        // [QB][W]
  int* ps = qs + QB * W;                 // [THREADS][W + 1]
  int* td = ps + THREADS * (W + 1);      // [QB][THREADS] this tile's distances
  int* bd = td + QB * THREADS;           // [QB][K] buffered distances, ascending
  int* bc = bd + QB * K;                 // [QB][K] their columns

  const int g = blockIdx.y;
  const int b0 = blockIdx.x * QB;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int* pg = p + (size_t)g * C * W;
  stage_queries(qs, q + (size_t)g * B * W, b0, B, W);
  for (int i = t; i < QB * K; i += THREADS) {
    bd[i] = INT_MAX;
    bc[i] = INT_MAX;
  }

  const int c_end = min(C, c_real);
  for (int c0 = 0; c0 < c_end; c0 += THREADS) {
    const int rows = min(THREADS, c_end - c0);
    __syncthreads();  // the previous tile is merged (and qs, the buffers set)
    stage_protos(ps, pg, c0, rows, W);
    __syncthreads();
    if (t < rows) {
      int acc[QB];
#pragma unroll
      for (int j = 0; j < QB; ++j) acc[j] = 0;
      const int* pr = ps + t * (W + 1);
      for (int w = 0; w < W; ++w) {
        const int pw = pr[w];
#pragma unroll
        for (int j = 0; j < QB; ++j) acc[j] += __popc(qs[j * W + w] ^ pw);
      }
#pragma unroll
      for (int j = 0; j < QB; ++j) td[j * THREADS + t] = acc[j];
    }
    __syncthreads();
    // merge: warp `warp` owns queries warp, warp + WARPS, ...
    for (int j = warp; j < QB; j += WARPS) {
      int* qd = bd + j * K;
      int* qc = bc + j * K;
      int worst = qd[K - 1];
      for (int s = 0; s < rows; s += 32) {
        const int r = s + lane;
        const int dv = r < rows ? td[j * THREADS + r] : INT_MAX;
        unsigned pass = __ballot_sync(FULL, dv < worst);
        while (pass) {
          const int src = __ffs(pass) - 1;
          pass &= pass - 1;
          const int d = __shfl_sync(FULL, dv, src);
          if (d >= worst) continue;  // the worst entry fell since the ballot
          // rank of the new pair: the entries with distance <= d stay before it
          int pos = 0;
          for (int e0 = 0; e0 < K; e0 += 32) {
            const int e = e0 + lane;
            pos += __popc(__ballot_sync(FULL, e < K && qd[e] <= d));
          }
          // shift the entries at pos.. one place down (the last falls out):
          // read every moved entry, then write
          int md[MAX_K / 32], mc[MAX_K / 32];
#pragma unroll
          for (int u = 0; u < MAX_K / 32; ++u) {
            const int e = u * 32 + lane;
            if (e < K && e > pos) {
              md[u] = qd[e - 1];
              mc[u] = qc[e - 1];
            }
          }
          __syncwarp();
#pragma unroll
          for (int u = 0; u < MAX_K / 32; ++u) {
            const int e = u * 32 + lane;
            if (e < K && e > pos) {
              qd[e] = md[u];
              qc[e] = mc[u];
            } else if (e == pos) {
              qd[e] = d;
              qc[e] = c0 + s + src;
            }
          }
          __syncwarp();
          worst = qd[K - 1];
        }
      }
    }
  }
  __syncthreads();
  for (int i = t; i < QB * K; i += THREADS) {
    const int j = i / K, b = b0 + j;
    if (b < B) {
      const size_t o = ((size_t)g * B + b) * K + i % K;
      dist[o] = bd[i];
      idx[o] = bc[i];
    }
  }
}

size_t smem_bytes(int W) { return (size_t)(QB * W + THREADS * (W + 1)) * sizeof(int); }

size_t topk_smem_bytes(int W, int K) {
  return smem_bytes(W) + (size_t)(QB * THREADS + 2 * QB * K) * sizeof(int);
}

// Opt in to `bytes` of dynamic shared memory on every launch. The 48 KB
// default covers static and dynamic shared memory together, and the top-1
// kernel holds 1 KB of static reduction buffers, so a test of the dynamic
// size alone would refuse W = 75 and 76; the attribute call is cheap.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" int hamming_topk_banked_launch(const void* q, const void* p, void* dist,
                                          void* idx, int G, int B, int C, int W,
                                          int c_real, void* stream) {
  const size_t smem = smem_bytes(W);
  cudaError_t err = allow_smem(hamming_topk_banked_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + QB - 1) / QB, G);
  hamming_topk_banked_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)q, (const int*)p, (int*)dist, (int*)idx, B, C, W, c_real);
  return (int)cudaGetLastError();
}

extern "C" int hamming_topk_k_banked_launch(const void* q, const void* p, void* dist,
                                            void* idx, int G, int B, int C, int W,
                                            int c_real, int K, void* stream) {
  const size_t smem = topk_smem_bytes(W, K);
  if (K < 1 || K > MAX_K || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(hamming_topk_k_banked_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((B + QB - 1) / QB, G);
  hamming_topk_k_banked_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)q, (const int*)p, (int*)dist, (int*)idx, B, C, W, c_real, K);
  return (int)cudaGetLastError();
}

// G banks of the full search in one launch (G = 1: the unbanked search).
extern "C" int hamming_search_banked_launch(const void* q, const void* p, void* out,
                                            int G, int B, int C, int W, void* stream) {
  const size_t smem = smem_bytes(W);
  cudaError_t err = allow_smem(hamming_search_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C + THREADS - 1) / THREADS, (B + QB - 1) / QB, G);
  hamming_search_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int*)q, (const int*)p, (int*)out, B, C, W);
  return (int)cudaGetLastError();
}
