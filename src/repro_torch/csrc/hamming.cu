// Packed Hamming search kernels for Hopper (sm_90a), plain C interface.
//
// Replaces four TPU kernels of src/repro/kernels/hamming/kernel.py:
//   * hamming_topk_banked_pallas / _topk_banked_kernel -> hamming_topk_banked_kernel
//     per-bank fused top-1 (min distance, first argmin) over XOR+popcount.
//   * hamming_topk_k_banked_pallas / _topk_k_banked_kernel -> hamming_topk_k_kernel
//     (+ topk_merge_kernel) per-bank fused top-k, rank-sorted ascending by
//     (distance, class index).
//   * hamming_pallas / _hamming_kernel -> hamming_search_kernel
//     full distances [B, C] int32.
//   * hamming_banked_pallas / _hamming_banked_kernel -> the same kernel with
//     a bank axis in the grid: per-bank full distances [G, B, C] int32.
//
// What bounds them on the H100. Every kernel does G*B*C*W word products;
// counted as products of the {0,1} expansions that is 2*G*B*C*32W
// operations. The full searches also write G*B*C*4 bytes, which bound them
// once the products run on the tensor cores (the recall oracle's [8, 512,
// 12,800] output is 210 MB, 0.063 ms at 3.35 TB/s). The top-1 (SIMT, below)
// and the top-k read G*(B+C)*W*4 bytes and write 8 bytes per query and rank:
// their products bound them.
//
// The search and the top-k run their products on the tensor cores' 1-bit
// path: mma.sync m16n8k256 .b1 with .and.popc sums popc(q AND p) over 256
// bits in int32, exactly, straight from the packed words, and
//   H = |q| + |p| - 2 popc(q AND p)
// with |q|, |p| the rows' bit counts. The product runs at ~10 POP/s on an
// H100 (benchmarks/torch_hamming_b1_probe.py), five times the int8 wgmma
// peak, and needs no expansion of the bits to bytes: a {0,1}-byte operand for
// wgmma u8 would write 32 KB of shared memory a 128 x 128 k-tile, against ~550
// clocks of products (the probe kept the 1-bit route; PERF.md).
//
// The tile (mma_tile). A block of 8 warps owns (bank, BM queries, 128
// classes); its warps sit 4 x 2 over the tile at BM = 128 (32 x 64 outputs a
// warp) and 2 x 4 at BM = 64 (32 x 32). Rows are staged by 16-byte cp.async
// (4-byte where W % 4 != 0 or a base is unaligned) in chunks of KC = 32 words,
// two chunks in flight, at a row stride of KC + 8 words. A k step is 8 words;
// thread t of a quad loads words 2t and 2t + 1 of a row as one 8-byte read, as
// its A registers (a0, a2) or its B registers (b0, b1): the k positions this
// assigns to the words are a permutation of the 256, the same for A and B, so
// the sum is unchanged, and the stride (== 8 mod 32 words) puts the 16 lanes
// of a half-warp on 32 distinct banks. Each thread also counts the bits of
// the 16-byte chunks it copied (its own cp.async, so no barrier), and the
// eight threads of a row sum their counts by shuffles. Words past W (to the
// next multiple of 8), rows past B and rows past C stage as 0 and add 0.
//
// The search's epilogue writes |q| + |p| - 2 acc into a shared tile (stride
// 136 words: the half-warps' 8-byte writes hit distinct banks) and stores it
// as 16-byte rows. BM = 64 is taken where 128-query tiles would not give
// every SM two blocks (as csrc/assoc_matmul.cu chooses).
//
// Top-k. The TPU kernel merges a [bq, k] buffer of int32 keys dist*c_pad +
// col with each tile by k rounds of min-extraction; that key overflows int32
// once (d+1)*C reaches 2^31. Here each query keeps a sorted buffer of its k
// best (dist, col) pairs in shared memory and pairs are compared, so there is
// no overflow limit. The class axis is split over blocks: block (query tile,
// split s, bank) walks the 128-class tiles [s*T/S, (s+1)*T/S) of the T tiles
// under c_real (S from kernels/hamming/ops.py `plan`, enough blocks to fill
// the card twice). After each tile's products the distances go to shared
// memory (columns past c_real as INT_MAX); then one warp per query loads the
// query's buffer into registers (entry u * 32 + lane in lane `lane`), walks
// the tile's columns in increasing order (a ballot of the columns that beat
// the buffer's worst entry, then one column at a time) and inserts each
// survivor after every buffered entry of equal or smaller distance (a ballot
// for the position, shuffles for the shift), taking the ballot again against
// the new worst entry after each insertion; so only the insertions are
// serial, and they are register operations. Every buffered column is
// smaller than every column of the tile, so that position is the
// lexicographic (dist, col) rank, and a column whose distance only ties the
// worst entry of a full buffer never enters: every rank keeps the
// first-minimum rule across tiles. The buffer starts full of (INT_MAX,
// INT_MAX) pairs, which no real distance reaches. With S = 1 the block
// writes its buffer as the result. Otherwise it writes it to the caller's
// [S, G, B, k] scratch and topk_merge_kernel places every real entry e of
// every split at its rank among all splits: its position in its own list
// plus, for each other list, the number of entries lexicographically below
// it (a binary search). Splits hold disjoint columns, so the pairs are
// distinct and the ranks a permutation; the k smallest land in order. The
// result does not depend on which block ends first.
//
// Top-1 (SIMT). The Pallas grid walks the class axis in order and carries
// the running (min, argmin) in a revisited VMEM tile; here that axis becomes
// a loop inside one block. A block owns one bank and a tile of QB queries,
// staged once in shared memory; it streams the bank's prototypes through
// shared memory one tile of 128 rows at a time (row stride W+1 words, so the
// 32 lanes of a warp read 32 different banks). Each thread owns one class row
// of the tile and keeps, in registers, the running best (dist, col) of each
// of the QB queries; it meets its classes in increasing order and replaces
// only on a strictly smaller distance. At the end a lexicographic
// (dist, col) reduction over the block (warp shuffles, then the warps in
// order) gives the first minimum, exactly the tie rule of kernel.py:93-105.
// Columns at or past c_real are never visited, which equals the reference's
// 2^30 poison whenever c_real >= 1 (the wrapper checks that).

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 128;  // top-1: class rows per tile, one per thread
constexpr int QB = 32;        // top-1: queries per block
constexpr int MAX_K = 256;    // top-k buffer ranks (the merge's registers: MAX_K / 32 a lane)
constexpr unsigned FULL = 0xffffffffu;

// the 1-bit tensor-core tile
constexpr int MMA_THREADS = 256;  // 8 warps
constexpr int BN = 128;           // classes a tile
constexpr int KC = 32;            // words of a row a ring stage (4 k steps of 8 words)
constexpr int LD = KC + 8;        // staged row stride in words (== 8 mod 32)
constexpr int OUT_LD = BN + 8;    // distance tile row stride in words (== 8 mod 32)
constexpr int TOPK_BM = 64;       // queries a top-k block

template <int BM>
struct Tile {
  static constexpr int WARPS_M = BM / 32;          // 4 (BM 128) or 2 (BM 64)
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BN / WARPS_N;          // classes a warp: 64 or 32
  static constexpr int NT = WN / 8;                // n8 tiles a warp
  static constexpr int ROWS = BM + BN;             // staged rows: queries, then classes
  static constexpr int QPT = ROWS * (KC / 4) / MMA_THREADS;  // 16-byte chunks a thread a stage
  static constexpr size_t RING = 2 * (size_t)ROWS * LD * sizeof(int);
  static constexpr size_t TILE = (size_t)BM * OUT_LD * sizeof(int);
  static constexpr size_t BODY = RING > TILE ? RING : TILE;   // the ring, later the distances
  static constexpr size_t SMEM = BODY + ROWS * sizeof(int);   // + the rows' bit counts
};

__device__ __forceinline__ bool lex_less(int d1, int c1, int d2, int c2) {
  return d1 < d2 || (d1 == d2 && c1 < c2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

// d += popc(a AND b) over a 16 x 256 by 256 x 8 bit tile, int32
__device__ __forceinline__ void mma_b1(int* d, uint2 a_lo, uint2 a_hi, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a_lo.x), "r"(a_hi.x), "r"(a_lo.y), "r"(a_hi.y), "r"(b.x), "r"(b.y));
}

// The products of one tile: acc[mi][ni][.] = popc(q AND p) of this warp's
// 32 x WN outputs, in the m16n8 accumulator layout (row 16 mi + lane / 4
// (+ 8 for j >= 2), class 8 ni + 2 (lane % 4) + j % 2 inside the warp's
// block); ring[BODY / 4 ..] (the counts) gets each staged row's bit count:
// queries at [0, BM), classes at [BM, BM + BN). Rows of q from b0 (of B)
// and of p from c0 (of C), W words each. Ends with a barrier: the counts
// are in and the ring may be reused.
template <int BM, bool ALIGNED>
__device__ __forceinline__ void mma_tile(int* smem, const uint32_t* __restrict__ q,
                                         const uint32_t* __restrict__ p, int b0, int B,
                                         int c0, int C, int W,
                                         int (&acc)[2][Tile<BM>::NT][4]) {
  using T = Tile<BM>;
  int* counts = smem + T::BODY / sizeof(int);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp / T::WARPS_N), wn = T::WN * (warp % T::WARPS_N);
  const int nch = max(1, (W + KC - 1) / KC);    // W = 0: one empty chunk, counts 0
  // this thread's 16-byte chunks: row tid / 8 + 32 j, chunk tid % 8
  const int qd = tid & 7;
  int cnt[T::QPT];
#pragma unroll
  for (int j = 0; j < T::QPT; ++j) cnt[j] = 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  // chunk ch's words [k0, k0 + kw), filled with zeros up to a multiple of 8
  auto fill = [&](int ch) -> int {
    const int kw = min(KC, W - ch * KC);
    return ((kw + 7) & ~7) / 4;                   // 16-byte chunks a row to stage
  };
  auto load = [&](int ch) {
    int* st = smem + (ch & 1) * T::ROWS * LD;
    const int k0 = ch * KC, nq = fill(ch);
    if (qd >= nq) return;
#pragma unroll
    for (int j = 0; j < T::QPT; ++j) {
      const int r = (tid >> 3) + 32 * j;
      const bool isq = r < BM;
      const int row = isq ? b0 + r : c0 + r - BM;
      const bool ok = row < (isq ? B : C);
      const uint32_t* src = (isq ? q : p) + (size_t)(ok ? row : 0) * W;
      const int w = k0 + 4 * qd;
      int* dst = st + r * LD + 4 * qd;
      if (ALIGNED) {
        cp_async16(dst, src + (ok && w < W ? w : 0), ok && w < W ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = ok && w + e < W;
          cp_async4(dst + e, src + (in ? w + e : 0), in ? 4 : 0);
        }
      }
    }
  };

  load(0);
  asm volatile("cp.async.commit_group;\n" ::);
  if (nch > 1) load(1);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int ch = 0; ch < nch; ++ch) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // chunk ch landed (own copies)
    const int* st = smem + (ch & 1) * T::ROWS * LD;
    const int nq = fill(ch);
    if (qd < nq) {                                // bit counts of this thread's chunks
#pragma unroll
      for (int j = 0; j < T::QPT; ++j) {
        const uint4 v = *reinterpret_cast<const uint4*>(st + ((tid >> 3) + 32 * j) * LD + 4 * qd);
        cnt[j] += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      }
    }
    __syncthreads();                              // chunk ch visible to every warp
    const int steps = nq / 2;                     // k steps of 8 words
    for (int ks = 0; ks < steps; ++ks) {
      const int k = 8 * ks + 2 * t;
      uint2 a_lo[2], a_hi[2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + 16 * mi + g;
        a_lo[mi] = *reinterpret_cast<const uint2*>(st + r * LD + k);
        a_hi[mi] = *reinterpret_cast<const uint2*>(st + (r + 8) * LD + k);
      }
      uint2 b[T::NT];
#pragma unroll
      for (int ni = 0; ni < T::NT; ++ni) {
        b[ni] = *reinterpret_cast<const uint2*>(st + (BM + wn + 8 * ni + g) * LD + k);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NT; ++ni) mma_b1(acc[mi][ni], a_lo[mi], a_hi[mi], b[ni]);
    }
    __syncthreads();                              // every warp is done with this stage
    if (ch + 2 < nch) load(ch + 2);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // a row's eight chunk counts sit in eight neighbouring lanes
#pragma unroll
  for (int j = 0; j < T::QPT; ++j) {
    int v = cnt[j];
    v += __shfl_xor_sync(FULL, v, 1);
    v += __shfl_xor_sync(FULL, v, 2);
    v += __shfl_xor_sync(FULL, v, 4);
    if (qd == 0) counts[(tid >> 3) + 32 * j] = v;
  }
  __syncthreads();
}

// The tile's distances |q| + |p| - 2 acc into the shared tile [BM][OUT_LD]
// (over the ring); columns at or past `cols` as INT_MAX. Callers sync after.
template <int BM>
__device__ __forceinline__ void distance_tile(int* smem, const int (&acc)[2][Tile<BM>::NT][4],
                                              int cols) {
  using T = Tile<BM>;
  const int* counts = smem + T::BODY / sizeof(int);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = 32 * (warp / T::WARPS_N), wn = T::WN * (warp % T::WARPS_N);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm + 16 * mi + g + 8 * h;
      const int qn = counts[r];
#pragma unroll
      for (int ni = 0; ni < T::NT; ++ni) {
        const int c = wn + 8 * ni + 2 * t;
        int2 v;
        v.x = c < cols ? qn + counts[BM + c] - 2 * acc[mi][ni][2 * h] : INT_MAX;
        v.y = c + 1 < cols ? qn + counts[BM + c + 1] - 2 * acc[mi][ni][2 * h + 1] : INT_MAX;
        *reinterpret_cast<int2*>(smem + r * OUT_LD + c) = v;
      }
    }
  }
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

// One query's merge of a distance tile (td, `rows` columns from class c0)
// into its sorted buffer (bd, bc; K <= 32 KR entries, ascending by (dist,
// col)), by one warp. The buffer lives in registers meanwhile: entry
// u * 32 + lane in lane `lane`, slot u. The tile's columns are taken in
// increasing order; each that beats the worst entry goes in after every
// entry of equal or smaller distance (all of them have smaller columns), and
// after each insertion the ballot of the columns still waiting is taken
// again against the new worst entry, so a column that no longer beats it
// costs nothing more.
template <int KR>
__device__ __forceinline__ void merge_tile(int* bd, int* bc, const int* td, int rows, int c0,
                                           int K) {
  const int lane = threadIdx.x & 31;
  const int last_u = (K - 1) >> 5, last_lane = (K - 1) & 31;
  int d_[KR], c_[KR];
#pragma unroll
  for (int u = 0; u < KR; ++u) {
    const int e = u * 32 + lane;
    d_[u] = e < K ? bd[e] : INT_MAX;
    c_[u] = e < K ? bc[e] : INT_MAX;
  }
  auto worst_entry = [&]() {
    int w = d_[0];
#pragma unroll
    for (int u = 1; u < KR; ++u) w = u == last_u ? d_[u] : w;
    return __shfl_sync(FULL, w, last_lane);
  };
  int worst = worst_entry();
  for (int s0 = 0; s0 < rows; s0 += 32) {
    const int dv = s0 + lane < rows ? td[s0 + lane] : INT_MAX;
    unsigned pass = __ballot_sync(FULL, dv < worst);
    while (pass) {
      const int src = __ffs(pass) - 1;
      pass &= pass - 1;
      const int d = __shfl_sync(FULL, dv, src);
      // its rank: the entries with distance <= d stay before it
      int pos = 0;
#pragma unroll
      for (int u = 0; u < KR; ++u) {
        pos += __popc(__ballot_sync(FULL, u * 32 + lane < K && d_[u] <= d));
      }
      // entry e takes entry e - 1 for e > pos (the last falls out)
      int pd[KR], pc[KR];
#pragma unroll
      for (int u = 0; u < KR; ++u) {
        const int ud = __shfl_up_sync(FULL, d_[u], 1), uc = __shfl_up_sync(FULL, c_[u], 1);
        // lane 0 takes lane 31 of the slot before (slot 0's lane 0 never moves)
        const int wd = __shfl_sync(FULL, d_[u == 0 ? 0 : u - 1], 31);
        const int wc = __shfl_sync(FULL, c_[u == 0 ? 0 : u - 1], 31);
        pd[u] = lane > 0 ? ud : wd;
        pc[u] = lane > 0 ? uc : wc;
      }
#pragma unroll
      for (int u = 0; u < KR; ++u) {
        const int e = u * 32 + lane;
        if (e > pos) {
          d_[u] = pd[u];
          c_[u] = pc[u];
        } else if (e == pos) {
          d_[u] = d;
          c_[u] = c0 + s0 + src;
        }
      }
      worst = worst_entry();
      pass &= __ballot_sync(FULL, dv < worst);
    }
  }
#pragma unroll
  for (int u = 0; u < KR; ++u) {
    const int e = u * 32 + lane;
    if (e < K) {
      bd[e] = d_[u];
      bc[e] = c_[u];
    }
  }
}

// grid (C / BN, B / BM, G): one (bank, query tile, class tile) a block
template <int BM, bool ALIGNED>
__global__ void __launch_bounds__(MMA_THREADS, 2)
hamming_search_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ p,
                      int* __restrict__ out, int B, int C, int W) {
  using T = Tile<BM>;
  extern __shared__ __align__(16) int smem[];
  const int c0 = blockIdx.x * BN, b0 = blockIdx.y * BM;
  const size_t g = blockIdx.z;
  int acc[2][T::NT][4];
  mma_tile<BM, ALIGNED>(smem, q + g * B * W, p + g * C * W, b0, B, c0, C, W, acc);
  distance_tile<BM>(smem, acc, BN);
  __syncthreads();
  const int nb = min(BM, B - b0), nc = min(BN, C - c0);
  int* og = out + (g * B + b0) * C + c0;
  if (C % 4 == 0) {                 // 16-byte rows (og is 16-byte aligned then)
    for (int e = threadIdx.x; e < nb * (BN / 4); e += MMA_THREADS) {
      const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
      if (c < nc) {
        *reinterpret_cast<int4*>(og + (size_t)r * C + c) =
            *reinterpret_cast<const int4*>(smem + r * OUT_LD + c);
      }
    }
  } else {
    for (int e = threadIdx.x; e < nb * BN; e += MMA_THREADS) {
      const int r = e / BN, c = e % BN;
      if (c < nc) og[(size_t)r * C + c] = smem[r * OUT_LD + c];
    }
  }
}

// grid (B / TOPK_BM, S, G): block (query tile, split s, bank) ranks the
// class tiles [s*T/S, (s+1)*T/S) of the T = ceil(c_real / BN) tiles; writes
// [G, B, K] (S = 1) or split s of the [S, G, B, K] scratch.
template <int KR, bool ALIGNED>
__global__ void __launch_bounds__(MMA_THREADS, 2)
hamming_topk_k_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ p,
                      int* __restrict__ dist, int* __restrict__ idx, int B, int C, int W,
                      int c_real, int K) {
  using T = Tile<TOPK_BM>;
  extern __shared__ __align__(16) int smem[];
  int* bd = smem + T::SMEM / sizeof(int);   // [TOPK_BM][K] buffered distances, ascending
  int* bc = bd + TOPK_BM * K;               // [TOPK_BM][K] their columns
  const int b0 = blockIdx.x * TOPK_BM, s = blockIdx.y, S = gridDim.y;
  const size_t g = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  constexpr int WARPS = MMA_THREADS / 32;
  const long long tiles = (c_real + BN - 1) / BN;
  const int t0 = (int)(s * tiles / S), t1 = (int)((s + 1) * tiles / S);
  for (int i = tid; i < TOPK_BM * K; i += MMA_THREADS) {
    bd[i] = INT_MAX;
    bc[i] = INT_MAX;
  }
  int acc[2][T::NT][4];
  for (int tile = t0; tile < t1; ++tile) {
    const int c0 = tile * BN, rows = min(BN, c_real - c0);
    mma_tile<TOPK_BM, ALIGNED>(smem, q + g * B * W, p + g * C * W, b0, B, c0, C, W, acc);
    distance_tile<TOPK_BM>(smem, acc, rows);
    __syncthreads();
    // merge: warp `warp` owns queries warp, warp + WARPS, ...
    for (int j = warp; j < TOPK_BM; j += WARPS) merge_tile<KR>(bd + j * K, bc + j * K,
                                                               smem + j * OUT_LD, rows, c0, K);
    __syncthreads();  // the distance tile is consumed: the ring may refill
  }
  const size_t base = S == 1 ? 0 : (size_t)s * gridDim.z * B * K;
  for (int i = tid; i < TOPK_BM * K; i += MMA_THREADS) {
    const int j = i / K, b = b0 + j;
    if (b < B) {
      const size_t o = base + (g * B + b) * K + i % K;
      dist[o] = bd[i];
      idx[o] = bc[i];
    }
  }
}

// Entry e of split s's sorted list for (g, b) goes to its rank among all S
// lists: its position in its own list plus, in each other list, the entries
// lexicographically below it. Sentinels (INT_MAX, INT_MAX) never land: at
// least K real entries rank below them (c_real >= K).
__global__ void topk_merge_kernel(const int* __restrict__ sd, const int* __restrict__ sc,
                                  int* __restrict__ dist, int* __restrict__ idx, int GB,
                                  int K, int S) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)GB * S * K) return;
  const int r = (int)(e % K), s = (int)(e / K % S);
  const long long gb = e / ((long long)K * S);
  const int d = sd[((long long)s * GB + gb) * K + r];
  const int c = sc[((long long)s * GB + gb) * K + r];
  if (c == INT_MAX) return;
  int rank = r;
  for (int o = 0; o < S && rank < K; ++o) {
    if (o == s) continue;
    const int* od = sd + ((long long)o * GB + gb) * K;
    const int* oc = sc + ((long long)o * GB + gb) * K;
    int lo = 0, hi = K;                      // entries [0, lo) are below (d, c)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (lex_less(od[mid], oc[mid], d, c)) lo = mid + 1;
      else hi = mid;
    }
    rank += lo;
  }
  if (rank < K) {
    dist[gb * K + rank] = d;
    idx[gb * K + rank] = c;
  }
}

size_t smem_bytes(int W) { return (size_t)(QB * W + THREADS * (W + 1)) * sizeof(int); }

// Opt in to `bytes` of dynamic shared memory on every launch. The 48 KB
// default covers static and dynamic shared memory together, and the top-1
// kernel holds 1 KB of static reduction buffers, so a test of the dynamic
// size alone would refuse W = 75 and 76; the attribute call is cheap.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int BM, bool ALIGNED>
int launch_search(const void* q, const void* p, void* out, int G, int B, int C, int W,
                  cudaStream_t stream) {
  const size_t smem = Tile<BM>::SMEM;
  cudaError_t err = allow_smem(hamming_search_kernel<BM, ALIGNED>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + BN - 1) / BN, (B + BM - 1) / BM, G);
  hamming_search_kernel<BM, ALIGNED><<<grid, MMA_THREADS, smem, stream>>>(
      (const uint32_t*)q, (const uint32_t*)p, (int*)out, B, C, W);
  return (int)cudaGetLastError();
}

template <int KR, bool ALIGNED>
int launch_topk(const void* q, const void* p, void* dist, void* idx, int G, int B, int C,
                int W, int c_real, int K, int S, cudaStream_t stream) {
  const size_t smem = Tile<TOPK_BM>::SMEM + 2 * (size_t)TOPK_BM * K * sizeof(int);
  cudaError_t err = allow_smem(hamming_topk_k_kernel<KR, ALIGNED>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + TOPK_BM - 1) / TOPK_BM, S, G);
  hamming_topk_k_kernel<KR, ALIGNED><<<grid, MMA_THREADS, smem, stream>>>(
      (const uint32_t*)q, (const uint32_t*)p, (int*)dist, (int*)idx, B, C, W, c_real, K);
  return (int)cudaGetLastError();
}

// the merge's register slots a lane: K <= 32, 64, 128, MAX_K
template <bool ALIGNED>
int launch_topk_k(const void* q, const void* p, void* dist, void* idx, int G, int B, int C,
                int W, int c_real, int K, int S, cudaStream_t stream) {
  if (K <= 32) return launch_topk<1, ALIGNED>(q, p, dist, idx, G, B, C, W, c_real, K, S, stream);
  if (K <= 64) return launch_topk<2, ALIGNED>(q, p, dist, idx, G, B, C, W, c_real, K, S, stream);
  if (K <= 128) return launch_topk<4, ALIGNED>(q, p, dist, idx, G, B, C, W, c_real, K, S, stream);
  return launch_topk<MAX_K / 32, ALIGNED>(q, p, dist, idx, G, B, C, W, c_real, K, S, stream);
}

bool aligned16(const void* q, const void* p, int W) {
  return W % 4 == 0 && ((uintptr_t)q | (uintptr_t)p) % 16 == 0;
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

// S splits of the class axis (kernels/hamming/ops.py `plan`); with S > 1 the
// split lists go to the scratch sd, sc [S, G, B, K] and are merged into
// dist, idx [G, B, K] by a second kernel on the same stream.
extern "C" int hamming_topk_k_banked_launch(const void* q, const void* p, void* dist,
                                            void* idx, void* sd, void* sc, int G, int B,
                                            int C, int W, int c_real, int K, int S,
                                            void* stream) {
  const long long tiles = (c_real + BN - 1) / BN;
  if (K < 1 || K > MAX_K || K > c_real || c_real > C || S < 1 || S > tiles || S > 65535 ||
      (S > 1 && (sd == nullptr || sc == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  void* d1 = S == 1 ? dist : sd;
  void* i1 = S == 1 ? idx : sc;
  const int err = aligned16(q, p, W)
                      ? launch_topk_k<true>(q, p, d1, i1, G, B, C, W, c_real, K, S, st)
                      : launch_topk_k<false>(q, p, d1, i1, G, B, C, W, c_real, K, S, st);
  if (err != 0 || S == 1) return err;
  const long long n = (long long)G * B * S * K;
  topk_merge_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const int*)sd, (const int*)sc, (int*)dist, (int*)idx, G * B, K, S);
  return (int)cudaGetLastError();
}

// G banks of the full search in one launch (G = 1: the unbanked search).
extern "C" int hamming_search_banked_launch(const void* q, const void* p, void* out,
                                            int G, int B, int C, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool al = aligned16(q, p, W);
  // 128-query tiles only where they still give every SM two blocks
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long big = (long long)G * ((B + 127) / 128) * ((C + BN - 1) / BN);
  if (big >= 2LL * sms) {
    return al ? launch_search<128, true>(q, p, out, G, B, C, W, st)
              : launch_search<128, false>(q, p, out, G, B, C, W, st);
  }
  return al ? launch_search<64, true>(q, p, out, G, B, C, W, st)
            : launch_search<64, false>(q, p, out, G, B, C, W, st);
}
