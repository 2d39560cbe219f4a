// Sparse-query vs packed-prototype Hamming kernels for Hopper (sm_90a),
// plain C interface.
//
// Replaces two TPU kernels of src/repro/kernels/sparse/kernel.py:
//   * sparse_search_pallas / _search_kernel -> sparse_kernel<QPW, false>
//     full distances [B, C] int32.
//   * sparse_topk_banked_pallas / _topk_banked_kernel -> sparse_kernel<QPW, true>
//     per-bank fused top-1 (min distance, first argmin).
// Both compute dist = |q| + popcount(p) - 2 * |q AND p|, the overlap by
// gathering the word that holds each query index and testing its bit.
//
// Precondition (the interface's, src/repro/kernels/sparse/kernel.py:125):
// every query is an index list SORTED ascending, its entries in [0, 32*W),
// padded at the end with SENTINEL (INT32_MAX). The walk below relies on it:
// it stops at a list's first SENTINEL and visits no slot past it.
//
// What bounds them on the H100: the bytes they must move are the index
// lists, the prototype rows and the outputs, 4*(B*k + C*W) (+ outputs); at
// d = 2^20 the prototypes dominate (128 KB a row). The work is one
// (query, live index, class) triple per gather, 1.7e9 at the serve shape
// (G = 64, B = 256, C = 100, ~1048 live of k = 2048), far more than the
// bytes: the kernels are bound by integer issue (~4 operations a triple)
// and by the latency of each index's shuffle and shared-memory read.
//
// Design. A block owns (bank g, a tile of QB = 16*QPW queries, a tile of up
// to CT = 128 classes) and walks the bit positions in segments of wseg
// words (kernels/sparse/ops.py `plan` sets the tiles). Each segment of the
// class tile's rows ends up in shared memory WORD-MAJOR, T[w][c] at
// w*stride + c, so that one 16-byte load gives a lane word w of four
// neighbouring classes: lane l owns classes 4l..4l+3 and keeps their overlap
// counters in registers, and each query index is read once per block and
// tested against every class of the tile (not once per class). The loads of
// a warp cover one contiguous row of T: no bank conflict.
//   Rows lie class-major in device memory, so a segment first LANDS
// row-major in a ring of STAGES buffers by 16-byte cp.async (LDGSTS; 4-byte
// copies where W % 4 != 0), issued STAGES segments ahead, and is then
// transposed into T by the block: a thread reads 16 bytes of its class's
// row (the landing stride wseg + 4 puts the rows of a quarter-warp in
// distinct banks) and writes 4 words of a column (a warp writes 32
// neighbouring classes of one word row). A TMA box cannot transpose 32-bit
// elements, and copying word-major straight from device memory needs
// 4-byte copies, slower on the H100 (PERF.md). T is single: the
// barrier after a segment lands also orders every warp's gathers of the
// previous segment before the next transpose.
//   |p| is counted in the transpose, from the words as they pass (every
// word of the class tile goes through it), so there is no pre-pass.
//   Each warp owns QPW queries. The lists are sorted, so a query's indices
// inside a segment are the next run of its list: the warp holds a window of
// 32 slots (one a lane), takes the run below the segment's end bit with one
// ballot, and broadcasts each index by shuffle; a cursor moves through the
// list once over the whole walk, and the first SENTINEL ends it: no
// SENTINEL slot is tested, and no window past the one that holds the first
// SENTINEL is loaded. |q| is the number of indices the walk consumed.
//   sparse_search may split the walk over W among `splits` blocks (the
// trials' single bank of 2000 queries gives too few query tiles to fill the
// card): each block finds its first slot by a warp-wide search of the
// sorted list (which may probe slots past the first SENTINEL, as the 32-slot
// windows may load them; neither is ever tested), and adds its partial
// |q| + |p| - 2*overlap to the (zeroed) output with integer atomics, exact
// in any order.
//
// Top-1 ordering. sparse_topk_banked's block walks its bank's class tiles in
// increasing order (C > 128 takes several), reduces each tile over classes
// by (dist, col) lexicographically -- the first minimum -- and carries the
// best with a strict <, so the earlier class keeps a tie (kernel.py:89-113)
// and no merge across blocks is needed. Columns at or past c_real are never
// visited (the reference poisons them; the same result while c_real >= 1,
// which the wrapper checks). Empty queries (all SENTINEL) get dist = |p|.

#include <cuda_runtime.h>
#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CT = 128;              // classes per tile: 4 a lane
constexpr int STAGES = 2;            // segments landing at once
constexpr int SENTINEL = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;     // 227 KB, a block's dynamic shared memory
constexpr int MAX_GRID_YZ = 65535;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

// Row stride (words) of the landing buffer for segments of wseg words (a
// multiple of 8): wseg + 4, so that stride / 4 is odd and the 16-byte reads
// of 8 neighbouring rows by a quarter-warp fall in distinct banks.
__host__ __device__ __forceinline__ int landing_stride(int wseg) { return wseg + 4; }

// Land words [w0, w0 + ws) of classes [0, ct) of `rows` (row length W) in
// the ring buffer at shared address `dst`, row-major (c * ls + w): 16-byte
// cp.async along each row where `vec` (W % 4 == 0 and an aligned base), else
// 4-byte copies. Each thread steps through the (class, chunk) items by
// THREADS with no division in the loop.
__device__ __forceinline__ void land_segment(uint32_t dst, const int* __restrict__ rows,
                                             int W, int w0, int ws, int ct, int ls,
                                             bool vec) {
  const int shift = vec ? 2 : 0;                  // words an item: 4 or 1
  const int n = vec ? ws >> 2 : ws;               // items a row
  const int dc = THREADS / n, di = THREADS - dc * n;
  int c = threadIdx.x / n, i = threadIdx.x - c * n;
  while (c < ct) {
    const uint32_t d = dst + 4u * static_cast<uint32_t>(c * ls + (i << shift));
    const int* src = rows + static_cast<size_t>(c) * W + w0 + (i << shift);
    if (vec) cp_async16(d, src); else cp_async4(d, src);
    c += dc;
    i += di;
    if (i >= n) {
      i -= n;
      ++c;
    }
  }
}

// First slot of the sorted list `qrow` (K slots) whose value is >= S: a
// warp-wide search, 32 probes a round (3 rounds at K = 2048).
__device__ __forceinline__ int lower_bound_warp(const int* __restrict__ qrow, int K,
                                                int S) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = K;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int p = lo + lane * step;
    const int v = p < hi ? __ldg(qrow + p) : INT_MAX;
    const int n = __popc(__ballot_sync(FULL, v < S));
    if (n == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + n * step);
      lo = lo + (n - 1) * step + 1;
    }
  }
  return lo;
}

// Test word v of four classes at bit sh, into their overlap counters.
__device__ __forceinline__ void test_bit(const int4 v, int sh, int (&acc)[4]) {
  acc[0] += (v.x >> sh) & 1;
  acc[1] += (v.y >> sh) & 1;
  acc[2] += (v.z >> sh) & 1;
  acc[3] += (v.w >> sh) & 1;
}

// Test slots [k, n) of a warp's window (slot i in lane i's `xs`) against the
// staged segment of words [w0, ...): `row` is this lane's column of the
// word-major buffer. Each lane first packs its own slot's word offset in the
// buffer and bit (offset << 5 | bit), so that an index costs one shuffle;
// then four slots at a time, so that four shared-memory reads are in flight,
// and the rest one by one.
__device__ __forceinline__ void gather_run(const int* row, int stride, int w0, int xs, int k,
                                           int n, bool active, int (&acc)[4]) {
  const unsigned pk =
      ((static_cast<unsigned>((xs >> 5) - w0) * static_cast<unsigned>(stride)) << 5) |
      static_cast<unsigned>(xs & 31);
  for (; k + 4 <= n; k += 4) {
    unsigned o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = __shfl_sync(FULL, pk, k + u);
    if (active) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = *reinterpret_cast<const int4*>(row + (o[u] >> 5));
#pragma unroll
      for (int u = 0; u < 4; ++u) test_bit(v[u], o[u] & 31, acc);
    }
  }
  for (; k < n; ++k) {
    const unsigned o = __shfl_sync(FULL, pk, k);
    if (active) test_bit(*reinterpret_cast<const int4*>(row + (o >> 5)), o & 31, acc);
  }
}

// (d, c) < (od, oc) lexicographically: the first minimum wins.
__device__ __forceinline__ void take_min(int& d, int& c, int od, int oc) {
  if (od < d || (od == d && oc < c)) {
    d = od;
    c = oc;
  }
}

// One block: (bank g, QB = WARPS * QPW queries, class tiles [t_begin, t_end),
// segments [s_begin, s_end)). TOPK: out/idx are the [G, B] min and argmin;
// else out is [B, C] (added to with atomics when splits > 1).
template <int QPW, bool TOPK>
__global__ void __launch_bounds__(THREADS, 1)
sparse_kernel(const int* __restrict__ q, const int* __restrict__ p, int* __restrict__ out,
              int* __restrict__ idx, int B, int C, int W, int K, int c_end, int wseg,
              int stride, int splits) {
  extern __shared__ int4 smem4[];
  const int ct_max = min(CT, c_end);
  const int ls = landing_stride(wseg);
  int* ring = reinterpret_cast<int*>(smem4);                 // [STAGES][ct_max][ls]
  int* st = ring + STAGES * ct_max * ls;                     // [wseg][stride]
  __shared__ int pop_s[CT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.x * (WARPS * QPW) + warp * QPW;   // this warp's first query
  const int g = TOPK ? blockIdx.y : 0;
  const int nseg = (W + wseg - 1) / wseg;
  const int s_begin = TOPK ? 0 : static_cast<int>(static_cast<long long>(blockIdx.z) * nseg / splits);
  const int s_end = TOPK ? nseg : static_cast<int>(static_cast<long long>(blockIdx.z + 1) * nseg / splits);
  const int t_begin = TOPK ? 0 : blockIdx.y;
  const int t_end = TOPK ? (c_end + CT - 1) / CT : blockIdx.y + 1;
  const int ns = s_end - s_begin;
  const int S0 = s_begin * wseg * 32;          // the first bit of this block's walk
  const uint32_t ring_u32 = smem_u32(ring);
  const uint32_t stage_bytes = 4u * static_cast<uint32_t>(ct_max * ls);
  const bool vec = (W & 3) == 0 && (reinterpret_cast<size_t>(p) & 15) == 0;
  const int tc = threadIdx.x & (CT - 1);          // the class this thread transposes
  const int* qg = q + static_cast<size_t>(g) * B * K;
  const int* pg = p + static_cast<size_t>(g) * C * W;

  if (threadIdx.x < CT) pop_s[threadIdx.x] = 0;
  int best_d[QPW], best_c[QPW];
#pragma unroll
  for (int j = 0; j < QPW; ++j) best_d[j] = best_c[j] = INT_MAX;
  __syncthreads();

  for (int t = t_begin; t < t_end; ++t) {
    const int c0 = t * CT;
    const int ct = min(CT, c_end - c0);
    const int* rows = pg + static_cast<size_t>(c0) * W;
    const bool active = 4 * lane < ct;           // lane owns classes 4*lane .. +3
    int xs[QPW], pos[QPW], base[QPW], cnt[QPW], acc[QPW][4];
    int pp = 0;                                  // |p| of class tc, so far
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      cnt[j] = pos[j] = 0;
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      base[j] = K;
      xs[j] = SENTINEL;
      if (b0 + j < B) {                          // warp-uniform
        const int* qrow = qg + static_cast<size_t>(b0 + j) * K;
        base[j] = S0 > 0 ? lower_bound_warp(qrow, K, S0) : 0;
        if (base[j] + lane < K) xs[j] = __ldg(qrow + base[j] + lane);
      }
    }

    for (int i = 0; i < STAGES; ++i) {
      if (i < ns) {
        const int w0 = (s_begin + i) * wseg;
        land_segment(ring_u32 + i * stage_bytes, rows, W, w0, min(wseg, W - w0), ct, ls, vec);
      }
      cp_commit();
    }
    for (int i = 0; i < ns; ++i) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
      __syncthreads();   // segment i has landed for every thread; st's last reader is done
      const int w0 = (s_begin + i) * wseg;
      const int ws = min(wseg, W - w0);
      const int E = (w0 + ws) * 32;              // the segment's end bit
      if (tc < ct) {                             // transpose to word-major; count |p|
        const int* lrow = ring + (i % STAGES) * ct_max * ls + tc * ls;
        for (int k = 4 * (threadIdx.x >> 7); k < ws; k += 4 * (THREADS / CT)) {
          const int4 v = *reinterpret_cast<const int4*>(lrow + k);
          int* tw = st + k * stride + tc;
          tw[0] = v.x;
          tw[stride] = v.y;
          tw[2 * stride] = v.z;
          tw[3 * stride] = v.w;
          if (vec) {                             // ws % 4 == 0: every word is in the row
            pp += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
          } else {
            pp += __popc(v.x) + __popc(k + 1 < ws ? v.y : 0) + __popc(k + 2 < ws ? v.z : 0) +
                  __popc(k + 3 < ws ? v.w : 0);
          }
        }
      }
      __syncthreads();                           // st is complete; the ring stage is free
      if (i + STAGES < ns) {
        const int w1 = (s_begin + i + STAGES) * wseg;
        land_segment(ring_u32 + (i % STAGES) * stage_bytes, rows, W, w1, min(wseg, W - w1),
                     ct, ls, vec);
      }
      cp_commit();
      const int* row = st + 4 * lane;            // this lane's column of the buffer
      int run[QPW];                              // window slots below E, per query
#pragma unroll
      for (int j = 0; j < QPW; ++j) run[j] = __popc(__ballot_sync(FULL, xs[j] < E));
#pragma unroll
      for (int j = 0; j < QPW; ++j) {
        while (true) {                           // the run of query j's list below E
          gather_run(row, stride, w0, xs[j], pos[j], run[j], active, acc[j]);
          cnt[j] += run[j] - pos[j];
          if (run[j] < 32) {
            pos[j] = run[j];
            break;
          }
          base[j] += 32;                         // the window is used up: the next 32 slots
          pos[j] = 0;
          xs[j] = SENTINEL;
          if (base[j] + lane < K)
            xs[j] = __ldg(qg + static_cast<size_t>(b0 + j) * K + base[j] + lane);
          run[j] = __popc(__ballot_sync(FULL, xs[j] < E));
        }
      }
    }

    if (tc < ct) atomicAdd(&pop_s[tc], pp);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const int b = b0 + j;
      if (b >= B) continue;                      // warp-uniform
      if constexpr (TOPK) {
        int bd = INT_MAX, bc = INT_MAX;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = 4 * lane + k;
          if (c < ct) take_min(bd, bc, cnt[j] + pop_s[c] - 2 * acc[j][k], c0 + c);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const int od = __shfl_xor_sync(FULL, bd, off), oc = __shfl_xor_sync(FULL, bc, off);
          take_min(bd, bc, od, oc);
        }
        take_min(best_d[j], best_c[j], bd, bc);  // tiles in increasing order
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = 4 * lane + k;
          if (c < ct) {
            int* o = out + static_cast<size_t>(b) * C + c0 + c;
            const int d = cnt[j] + pop_s[c] - 2 * acc[j][k];
            if (splits > 1) atomicAdd(o, d); else *o = d;
          }
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < CT) pop_s[threadIdx.x] = 0;
    __syncthreads();
  }

  if constexpr (TOPK) {
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < QPW; ++j) {
        if (b0 + j < B) {
          out[static_cast<size_t>(g) * B + b0 + j] = best_d[j];
          idx[static_cast<size_t>(g) * B + b0 + j] = best_c[j];
        }
      }
    }
  }
}

template <int QPW, bool TOPK>
cudaError_t launch_one(dim3 grid, size_t smem, cudaStream_t s, const int* q, const int* p,
                       int* out, int* idx, int B, int C, int W, int K, int c_end, int wseg,
                       int stride, int splits) {
  auto kernel = sparse_kernel<QPW, TOPK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, s>>>(q, p, out, idx, B, C, W, K, c_end, wseg, stride, splits);
  return cudaGetLastError();
}

// Check the plan (from kernels/sparse/ops.py `plan`) and launch the instance
// of its QPW; the ring's bytes, or 0 where the plan is refused.
template <bool TOPK>
int launch(int qpw, int G, int B, int C, int W, int K, int c_end, int wseg, int stride,
           int splits, const void* q, const void* p, void* out, void* idx, void* stream) {
  const int ct = c_end < CT ? c_end : CT;
  const int nseg = wseg > 0 ? (W + wseg - 1) / wseg : 0;
  const size_t smem =
      (static_cast<size_t>(STAGES) * ct * landing_stride(wseg) + static_cast<size_t>(wseg) * stride) *
      sizeof(int);
  const int tiles = (c_end + CT - 1) / CT;
  if (W <= 0 || W >= (1 << 26) || c_end <= 0 || wseg <= 0 || wseg % 8 != 0 || stride < ct ||
      stride % 4 != 0 || splits < 1 || splits > nseg || (TOPK && splits != 1) ||
      smem + CT * sizeof(int) > SMEM_MAX || G > MAX_GRID_YZ || splits > MAX_GRID_YZ ||
      (!TOPK && tiles > MAX_GRID_YZ))
    return cudaErrorInvalidValue;
  const int qb = WARPS * qpw;
  const dim3 grid((B + qb - 1) / qb, TOPK ? G : tiles, TOPK ? 1 : splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qi = static_cast<const int*>(q);
  const int* pi = static_cast<const int*>(p);
  int* o = static_cast<int*>(out);
  int* x = static_cast<int*>(idx);
  switch (qpw) {
    case 1: return launch_one<1, TOPK>(grid, smem, s, qi, pi, o, x, B, C, W, K, c_end, wseg, stride, splits);
    case 2: return launch_one<2, TOPK>(grid, smem, s, qi, pi, o, x, B, C, W, K, c_end, wseg, stride, splits);
    case 4: return launch_one<4, TOPK>(grid, smem, s, qi, pi, o, x, B, C, W, K, c_end, wseg, stride, splits);
    case 8: return launch_one<8, TOPK>(grid, smem, s, qi, pi, o, x, B, C, W, K, c_end, wseg, stride, splits);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// out [B, C]: written, or added to (from zero) when splits > 1.
extern "C" int sparse_search_launch(const void* q, const void* p, void* out, int B, int C,
                                    int W, int K, int qpw, int wseg, int stride, int splits,
                                    void* stream) {
  return launch<false>(qpw, 1, B, C, W, K, C, wseg, stride, splits, q, p, out, nullptr,
                       stream);
}

extern "C" int sparse_topk_banked_launch(const void* q, const void* p, void* dist, void* idx,
                                         int G, int B, int C, int W, int K, int c_real,
                                         int qpw, int wseg, int stride, void* stream) {
  return launch<true>(qpw, G, B, C, W, K, c_real < C ? c_real : C, wseg, stride, 1, q, p,
                      dist, idx, stream);
}
