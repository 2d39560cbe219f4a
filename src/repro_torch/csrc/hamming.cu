// Packed Hamming search kernels for Hopper (sm_90a), plain C interface.
//
// Replaces four TPU kernels of src/repro/kernels/hamming/kernel.py:
//   * hamming_topk_banked_pallas / _topk_banked_kernel -> hamming_top1_kernel
//     (+ top1_merge_kernel) per-bank fused top-1 (min distance, first argmin).
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
// 12,800] output is 210 MB, 0.063 ms at 3.35 TB/s). The top-1 and the top-k
// read G*(B+C)*W*4 bytes and write 8 bytes per query and rank: their
// products bound them at the wide shapes, their bytes at the serve's.
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
// Top-1 (hamming_top1_kernel). The Pallas grid walks the class axis in
// order and carries the running (min, argmin) in a revisited VMEM tile. Here
// block (query tile, split s, bank) walks its class tiles [s*T/S, (s+1)*T/S)
// of the T = ceil(c_real / 128) and writes no distance. Its products run on
// the 1-bit warpgroup product, wgmma.mma_async m64n128k256 .b1 .and.popc
// (BGMMA): both operands straight from shared memory, no fragment loads, at
// ~15.7 POP/s on an H100 where the mma.sync tile above reaches ~10
// (benchmarks/torch_hamming_b1_probe.py); a top-1 on the mma.sync tile was
// bound by its fragment loads and missed its target (PERF.md). The words
// are laid out as csrc/assoc_matmul.cu lays out
// bytes: rows of 128 bytes (32 words, four 256-bit k steps) with their
// 16-byte chunks XOR-swizzled by row, the layout wgmma reads with its
// 128-byte swizzle; a k step past the row's words (W = 16: the last two)
// is not issued. Two warpgroups: at BM = 128 each owns 64 queries x the
// tile's 128 classes, at BM = 64 each 64 queries x 64 classes. The query
// tile stays resident in shared memory for the block's life where two blocks
// still fit an SM (W <= 64 at BM = 128, <= 160 at BM = 64); the class rows
// stream through a ring of k-tile slots by cp.async, all but one slot in
// flight (4 slots; 3 at BM = 128 when each slot also carries the query
// rows' k tile), one barrier a stage. |p| comes from the 16-byte chunks each thread copied,
// counted while the products run; |q| once a block. After a tile's products
// every thread takes, for each of its two rows (wrow + 16 (warp % 4) +
// lane / 4 (+ 8)), v = |p| - 2 acc over its 32 (BM 128) or 16 columns,
// met in increasing order, keeps the least (columns at or past c_real never
// take part, which equals the reference's 2^30 poison since c_real >= 1) and
// replaces its running best only on a strictly smaller v, with the first
// column at it: so it holds the first minimum of its columns. At the end the
// four threads of a quad (the same rows) meet by shuffles and, at BM = 64,
// the two warpgroups through shared memory, each step a lexicographic
// (v, col) min; the distance is |q| + v. The result is the first minimum
// (kernel.py:93-105) whatever the order of lanes, warpgroups or splits. S and
// BM come from kernels/hamming/ops.py `plan_top1` (BM = 128 where 128-query
// tiles, split down to one class tile a block, still give every SM two
// blocks; S counts whole waves, so no split count leaves a second wave of a
// few blocks). With S = 1 the block writes the result; otherwise the
// caller's [S, G, B] scratch, and top1_merge_kernel takes each query's
// lexicographic min over the S complete partials, which does not depend on
// which block ends first.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int MAX_K = 256;    // top-k buffer ranks (the merge's registers: MAX_K / 32 a lane)
constexpr unsigned FULL = 0xffffffffu;

// the 1-bit tensor-core tile
constexpr int MMA_THREADS = 256;  // 8 warps
constexpr int BN = 128;           // classes a tile
constexpr int KC = 32;            // words of a row a ring stage (4 k steps of 8 words)
constexpr int LD = KC + 8;        // staged row stride in words (== 8 mod 32)
constexpr int OUT_LD = BN + 8;    // distance tile row stride in words (== 8 mod 32)
constexpr int TOPK_BM = 64;       // queries a top-k block
// the top-1 on wgmma
constexpr int BK = 128;           // bytes of a row a k tile: 32 words, four 256-bit k steps
// shared memory a block may take so that two fit an SM (228 KB, 1 KB
// reserved a block)
constexpr size_t TWO_BLOCK_SMEM = 113 * 1024;

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

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows: the
// 128-byte swizzle wgmma reads (chunk c ^ (r % 8))
__device__ __forceinline__ int swz(int r, int c) { return r * BK + ((c ^ (r & 7)) << 4); }

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms of 1024 bytes (the stride between atoms),
// as swz() lays them out; a 256-bit (32-byte) k step adds 2 to the address
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= popc(A AND B) over one 256-bit k step, 64 rows x N classes a
// warpgroup, int32; scale_d = 0 starts from 0
__device__ __forceinline__ void wgmma_b1(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

__device__ __forceinline__ void wgmma_b1(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// The top-1's shared memory: a ring of STAGES slots of k-tile rows (class
// rows; with QRES off, the query rows' k tile first), with QRES the query
// tile resident ([W / 32] k tiles of [BM][BK]), the rows' bit counts and the
// reduction's [2][BM] (dist, col).
template <int BM, bool QRES>
struct Top1 {
  static constexpr int WN = BM == 128 ? 128 : 64;          // classes a warpgroup's wgmma covers
  static constexpr int SROWS = QRES ? BN : BM + BN;         // rows a ring slot stages
  static constexpr int STAGES = QRES || BM == 64 ? 4 : 3;   // at most 96 KB of ring
  static constexpr size_t SLOT = (size_t)SROWS * BK;
  static constexpr size_t RING = STAGES * SLOT;
  static size_t smem(int W) {                              // + 1024 for the ring's alignment
    const size_t ktiles = (size_t)max(1, (W + KC - 1) / KC);
    return 1024 + RING + (QRES ? ktiles * BM * BK : 0) + (BM + BN + 4 * BM) * sizeof(int);
  }
};

// grid (B / BM, S, G): block (query tile, split s, bank) finds, for each of
// its BM queries, the first minimum (dist, col) over the class tiles
// [s*T/S, (s+1)*T/S) of the T = ceil(c_real / BN) tiles; writes [G, B]
// (S = 1) or split s of the [S, G, B] scratch.
template <int BM, bool ALIGNED, bool QRES>
__global__ void __launch_bounds__(MMA_THREADS, 2)
hamming_top1_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ p,
                    int* __restrict__ dist, int* __restrict__ idx, int B, int C, int W,
                    int c_real) {
  using T = Top1<BM, QRES>;
  constexpr int STAGES = T::STAGES, WN = T::WN;
  constexpr int CR = QRES ? 0 : BM;             // a slot's first class row
  constexpr int SJ = T::SROWS * 8 / MMA_THREADS;   // chunks a thread stages: rows tid/8 + 32 j
  constexpr int QJ = QRES ? 0 : BM / 32;        // of which query rows (j < QJ)
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qt = ring + T::RING;
  const int nch = max(1, (W + KC - 1) / KC);    // k tiles a row (W = 0: one, empty)
  int* counts = reinterpret_cast<int*>(qt + (QRES ? (size_t)nch * BM * BK : 0));
  int* red_d = counts + BM + BN;                // [2][BM]
  int* red_c = red_d + 2 * BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int b0 = blockIdx.x * BM, split = blockIdx.y, S = gridDim.y;
  const size_t g = blockIdx.z;
  const uint32_t* qg = q + g * B * W;
  const uint32_t* pg = p + g * C * W;
  const long long tiles = (c_real + BN - 1) / BN;
  const int t0 = (int)(split * tiles / S), t1 = (int)((split + 1) * tiles / S);
  const int n = (t1 - t0) * nch;                // stages: (class tile, k tile)
  // warpgroup wg's outputs: 64 queries from wrow x WN classes from wcol
  const int wrow = BM == 128 ? 64 * wg : 0, wcol = BM == 128 ? 0 : 64 * wg;
  const int qd = tid & 7;                       // this thread's 16-byte chunk of a row

  // 16 bytes of row `row` (of `rows`) at word w into dst, zeros past the row
  auto copy16 = [&](unsigned char* dst, const uint32_t* base, int row, int rows, int w) {
    const bool ok = row < rows;
    const uint32_t* src = base + (size_t)(ok ? row : 0) * W;
    if (ALIGNED) {
      cp_async16(dst, src + (ok && w < W ? w : 0), ok && w < W ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = ok && w + e < W;
        cp_async4(dst + 4 * e, src + (in ? w + e : 0), in ? 4 : 0);
      }
    }
  };
  // k tile ch's words [32 ch, 32 ch + kw), zeros to a multiple of 8
  auto fill = [&](int ch) -> int {
    const int kw = min(KC, W - ch * KC);
    return ((kw + 7) & ~7) / 4;                   // 16-byte chunks a row to stage
  };
  auto load = [&](int st) {
    if (st >= n) return;
    unsigned char* slot = ring + (st % STAGES) * T::SLOT;
    const int ch = st % nch, c0 = (t0 + st / nch) * BN;
    if (qd >= fill(ch)) return;
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const int r = (tid >> 3) + 32 * j;
      if (j < QJ) copy16(slot + swz(r, qd), qg, b0 + r, B, ch * KC + 4 * qd);
      else copy16(slot + swz(r, qd), pg, c0 + r - CR, C, ch * KC + 4 * qd);
    }
  };

  if (QRES) {                                   // the query tile, once
    for (int e = tid; e < nch * BM * 8; e += MMA_THREADS) {
      const int kt = e / (BM * 8), r = (e >> 3) % BM, c = e & 7;
      if (c < fill(kt)) copy16(qt + (size_t)kt * BM * BK + swz(r, c), qg, b0 + r, B, kt * KC + 4 * c);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    load(i);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  int acc[WN / 2];                              // W = 0: no product, every count 0
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0;
  int cnt[SJ];
#pragma unroll
  for (int j = 0; j < SJ; ++j) cnt[j] = 0;
  // this thread's running best of its rows wrow + 16 (warp % 4) + lane / 4
  // (+ 8 h) over its columns, met in increasing order, as v = |p| - 2 acc
  // (the distance less |q|, the same for the whole row): a strictly smaller
  // v replaces
  int bv[2] = {INT_MAX, INT_MAX}, bc[2] = {INT_MAX, INT_MAX};

  for (int st = 0; st < n; ++st) {
    const int ch = st % nch;
    const bool first = st < nch;                // the first class tile: count the query rows
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");   // stage st landed
    // this thread's copies of stage st, visible to the tensor cores' (async) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // stage st visible to every warp; every warpgroup's products on stage
    // st - 1 done (each waits for its own below), so its slot may refill
    __syncthreads();
    load(st + STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::);

    const unsigned char* slot = ring + (st % STAGES) * T::SLOT;
    const unsigned char* at = QRES ? qt + (size_t)ch * BM * BK : slot;
    const uint64_t da = sw128_desc(smem_u32(at + wrow * BK));
    const uint64_t db = sw128_desc(smem_u32(slot + (CR + wcol) * BK));
    const int nq = fill(ch);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {      // the k steps holding words of the row
      if (2 * ks < nq) wgmma_b1(acc, da + 2 * ks, db + 2 * ks, ch > 0 || ks > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (qd < nq) {                              // bit counts of this thread's chunks meanwhile
#pragma unroll
      for (int j = 0; j < SJ; ++j) {
        if (j >= QJ || first) {
          const uint4 v = *reinterpret_cast<const uint4*>(slot + swz((tid >> 3) + 32 * j, qd));
          cnt[j] += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
        }
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) asm volatile("" : "+r"(acc[i])::"memory");   // read after the wait
    if (ch < nch - 1) continue;

    // the class tile's products are in: its rows' counts (the eight threads
    // of a row are neighbouring lanes), then its columns into the running bests
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      if (j >= QJ || first) {
        int v = cnt[j];
        v += __shfl_xor_sync(FULL, v, 1);
        v += __shfl_xor_sync(FULL, v, 2);
        v += __shfl_xor_sync(FULL, v, 4);
        if (qd == 0) counts[BM - CR + (tid >> 3) + 32 * j] = v;
        cnt[j] = 0;
      }
    }
    if (QRES && first && tid < BM) {            // the resident query rows, once
      int v = 0;
      for (int kt = 0; kt < nch; ++kt) {
        for (int c = 0; c < fill(kt); ++c) {
          const uint4 x = *reinterpret_cast<const uint4*>(qt + (size_t)kt * BM * BK + swz(tid, c));
          v += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
        }
      }
      counts[tid] = v;
    }
    __syncthreads();                            // the counts are in
    const int c0 = (t0 + st / nch) * BN;
    const bool full = c0 + BN <= c_real;        // no column at or past c_real
    // accumulator j: row .. + 8 (j % 4 >= 2), class wcol + 8 (j / 4) + 2 (lane % 4) + j % 2
    auto v_at = [&](int nt, int h, int j) {
      const int c = wcol + 8 * nt + 2 * (lane & 3) + j;
      const int v = counts[BM + c] - 2 * acc[4 * nt + 2 * h + j];
      return full || c0 + c < c_real ? v : INT_MAX;
    };
    int m[2] = {INT_MAX, INT_MAX};
#pragma unroll
    for (int nt = 0; nt < WN / 8; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        m[0] = min(m[0], v_at(nt, 0, j));
        m[1] = min(m[1], v_at(nt, 1, j));
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m[h] < bv[h]) {                       // rare after the first tiles: its first column
        int col = 0;
#pragma unroll
        for (int nt = WN / 8 - 1; nt >= 0; --nt)
#pragma unroll
          for (int j = 1; j >= 0; --j) {
            col = v_at(nt, h, j) == m[h] ? wcol + 8 * nt + 2 * (lane & 3) + j : col;
          }
        bv[h] = m[h];
        bc[h] = c0 + col;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // the quad's four threads share their rows; then (BM = 64) the two
  // warpgroups over a row's columns, through shared memory; lexicographic
  // (v, col) at each step
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int d = bv[h], c = bc[h];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const int d2 = __shfl_xor_sync(FULL, d, off), c2 = __shfl_xor_sync(FULL, c, off);
      if (lex_less(d2, c2, d, c)) {
        d = d2;
        c = c2;
      }
    }
    if ((lane & 3) == 0) {
      const int r = (BM == 128 ? 0 : wg * BM) + wrow + 16 * (warp & 3) + (lane >> 2) + 8 * h;
      red_d[r] = d;
      red_c[r] = c;
    }
  }
  __syncthreads();
  const int r = tid, b = b0 + r;
  if (r < BM && b < B) {
    int d = red_d[r], c = red_c[r];
    if (BM == 64 && lex_less(red_d[BM + r], red_c[BM + r], d, c)) {
      d = red_d[BM + r];
      c = red_c[BM + r];
    }
    const size_t o = (S == 1 ? 0 : (size_t)split * gridDim.z * B) + g * B + b;
    dist[o] = counts[r] + d;                    // |q| + |p| - 2 acc
    idx[o] = c;
  }
}

// The S split results of each (g, b): their lexicographic (dist, col) min.
// Every split holds at least one real column, and the min of complete
// partials does not depend on which block ended first.
__global__ void top1_merge_kernel(const int* __restrict__ sd, const int* __restrict__ sc,
                                  int* __restrict__ dist, int* __restrict__ idx, int GB,
                                  int S) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= GB) return;
  int d = sd[e], c = sc[e];
  for (int s = 1; s < S; ++s) {
    const int d2 = sd[(size_t)s * GB + e], c2 = sc[(size_t)s * GB + e];
    if (lex_less(d2, c2, d, c)) {
      d = d2;
      c = c2;
    }
  }
  dist[e] = d;
  idx[e] = c;
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

// Opt in to `bytes` of dynamic shared memory (past the 48 KB default) on
// every launch; the attribute call is cheap.
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

template <int BM, bool ALIGNED, bool QRES>
int launch_top1(const void* q, const void* p, void* dist, void* idx, int G, int B, int C,
                int W, int c_real, int S, cudaStream_t stream) {
  const size_t smem = Top1<BM, QRES>::smem(W);
  cudaError_t err = allow_smem(hamming_top1_kernel<BM, ALIGNED, QRES>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((B + BM - 1) / BM, S, G);
  hamming_top1_kernel<BM, ALIGNED, QRES><<<grid, MMA_THREADS, smem, stream>>>(
      (const uint32_t*)q, (const uint32_t*)p, (int*)dist, (int*)idx, B, C, W, c_real);
  return (int)cudaGetLastError();
}

// The query tile resident where two blocks still fit an SM (W <= 64 at
// BM = 128, <= 160 at BM = 64); else streamed with the class rows.
template <int BM, bool ALIGNED>
int launch_top1_at(const void* q, const void* p, void* dist, void* idx, int G, int B, int C,
                   int W, int c_real, int S, cudaStream_t stream) {
  if (Top1<BM, true>::smem(W) <= TWO_BLOCK_SMEM) {
    return launch_top1<BM, ALIGNED, true>(q, p, dist, idx, G, B, C, W, c_real, S, stream);
  }
  return launch_top1<BM, ALIGNED, false>(q, p, dist, idx, G, B, C, W, c_real, S, stream);
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

// The fused top-1 at BM-query tiles (64 or 128) over S splits of the class
// axis (kernels/hamming/ops.py `plan_top1`); with S > 1 the split results go
// to the scratch sd, sc [S, G, B] and are merged into dist, idx [G, B] by a
// second kernel on the same stream.
extern "C" int hamming_topk_banked_launch(const void* q, const void* p, void* dist,
                                          void* idx, void* sd, void* sc, int G, int B,
                                          int C, int W, int c_real, int BM, int S,
                                          void* stream) {
  const long long tiles = (c_real + BN - 1) / BN;
  if (c_real < 1 || c_real > C || (BM != 64 && BM != 128) || S < 1 || S > tiles ||
      S > 65535 || (S > 1 && (sd == nullptr || sc == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  void* d1 = S == 1 ? dist : sd;
  void* i1 = S == 1 ? idx : sc;
  const bool al = aligned16(q, p, W);
  const int err =
      BM == 128 ? (al ? launch_top1_at<128, true>(q, p, d1, i1, G, B, C, W, c_real, S, st)
                      : launch_top1_at<128, false>(q, p, d1, i1, G, B, C, W, c_real, S, st))
                : (al ? launch_top1_at<64, true>(q, p, d1, i1, G, B, C, W, c_real, S, st)
                      : launch_top1_at<64, false>(q, p, d1, i1, G, B, C, W, c_real, S, st));
  if (err != 0 || S == 1) return err;
  const int gb = G * B;
  top1_merge_kernel<<<(gb + 255) / 256, 256, 0, st>>>((const int*)sd, (const int*)sc,
                                                      (int*)dist, (int*)idx, gb, S);
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
