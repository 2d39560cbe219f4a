// Bipolar associative matmul for Hopper (sm_90a), plain C interface.
//
// Replaces assoc_matmul_pallas / _assoc_kernel of
// src/repro/kernels/assoc_matmul/kernel.py: dots[g, b, c] =
// sum_k (2 q[g,b,k] - 1) (2 p[g,c,k] - 1) of uint8 inputs ({0,1} on every
// caller's path; exact for any byte while 4 * 255^2 * K fits int32, K <= 8256),
// written as f32 (rounded once from the exact int32). The bank axis g is
// the vmap the JAX serve wraps around the kernel (one bank per IMC core, or
// per (core, permuted bank)); G = 1 is the plain [B, K] x [C, K] product.
//
// What bounds it on the H100: it moves G*(B+C)*K bytes in and G*B*C*4 bytes
// out and does 2*G*B*C*K operations. At the serve's shapes (B = 256, C = 100,
// K = 512 a bank) the bytes bound it (the f32 output is the largest stream);
// at tall shapes (B = 4096, C = 1600, K = 2048) the operations do, against
// the int8 tensor-core peak (1,979 TOP/s).
//
// Design. The raw {0,1} bytes go from device memory to the tensor cores
// unchanged, and the bipolar algebra moves to the epilogue:
//   dot = 4 (q.p) - 2|q| - 2|p| + K,
// with q.p the u8 x u8 product accumulated in int32 by wgmma
// (wgmma.mma_async m64nNk32 .s32.u8.u8, both operands K-major from shared
// memory, as [B, K] and [C, K] lie in device memory) and |q|, |p| the sums
// of the byte values (the counts of ones for {0,1} bytes), taken by each
// block from the tiles it stages while the products run. Bytes past K, rows
// past B and rows past C stage as 0 and add 0 to every term, so the mask of
// kernel.py:26-29 costs nothing and the result is exact: int32 throughout,
// for {0,1} bytes |dot| <= K < 2^24 (the wrapper checks K), written as f32.
//
// A block owns (bank g, BM queries, 128 classes): one class tile covers the
// serve's C = 100. Its two warpgroups each run one wgmma a 32-byte k step: at
// BM = 128 each owns 64 queries x 128 classes, at BM = 64 each 64 queries x
// 64 classes. BM = 64 is taken where 128-query tiles would not give every SM
// two blocks (the serve's G = 64, B = 256 then runs 256 blocks). k runs in
// 128-byte tiles through a ring of shared memory (4 stages at BM = 64, 3 at
// BM = 128; 96 KB, two blocks an SM) filled by 16-byte cp.async with zero
// fill past K and past the rows; the whole ring is in flight before the first
// product, so the serve's K = 512 waits on device memory once. Rows are 128
// bytes with their 16-byte chunks XOR-swizzled by row, the layout wgmma reads
// with its 128-byte swizzle (the ring is aligned to 1024 bytes). When K % 16
// or a base address rules out 16-byte cp.async (a ragged K), the same ring
// is filled from 16-byte-aligned vector loads shifted into place with funnel
// shifts (a load never leaves the 16-byte chunks that hold its row's bytes).
// The epilogue stages the dots in shared memory and writes the f32 rows
// coalesced, float4 where C allows.

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int BN = 128;        // classes per block
constexpr int BK = 128;        // bytes of k per tile
constexpr int THREADS = 256;   // two warpgroups
constexpr int CHUNKS = BK / 16;

template <int BM> struct Cfg {
  static constexpr int STAGES = BM == 64 ? 4 : 3;   // 96 KB of ring: two blocks an SM
  static constexpr int WN = BM == 128 ? 128 : 64;   // classes a warpgroup's wgmma covers
  static constexpr int STAGE_BYTES = (BM + BN) * BK;
  static constexpr int OUT_LD = BN + 4;             // f32 epilogue tile row stride
  static constexpr size_t RING = (size_t)STAGES * STAGE_BYTES;
  static constexpr size_t TILE = (size_t)BM * OUT_LD * sizeof(float);
  static constexpr size_t SMEM =           // + the 1024-byte alignment of the ring
      (RING > TILE ? RING : TILE) + (BM + BN) * sizeof(int) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Sum of the 16 byte values of v (not a count of set bits: |q| and |p| are
// sums of byte values, so the identity holds for any byte): per-byte
// absolute differences against 0, summed (no IDP4A).
__device__ __forceinline__ int byte_sum(uint4 v) {
  return static_cast<int>(__vsadu4(v.x, 0u) + __vsadu4(v.y, 0u) + __vsadu4(v.z, 0u) +
                          __vsadu4(v.w, 0u));
}

// byte offset of 16-byte chunk c of row r inside a tile of 128-byte rows:
// the 128-byte swizzle wgmma reads (chunk c ^ (r % 8))
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 128 bytes, 8-row atoms of 1024 bytes (the stride between atoms),
// as swz() lays them out; a 32-byte k step adds 2 to the address field
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_n64(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

__device__ __forceinline__ void wgmma_n128(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 "
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
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// Bytes [k, k + 16) of a row of K bytes, those at or past K as 0, from
// 16-byte-aligned loads that only touch chunks holding bytes of the row.
__device__ __forceinline__ uint4 load16_unaligned(const unsigned char* row, int k, int K) {
  const int n = min(16, K - k);
  if (n <= 0) return make_uint4(0u, 0u, 0u, 0u);
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + k);
  const uintptr_t a0 = a & ~uintptr_t(15);
  const int s = (int)(a - a0);
  const uint4 lo = *reinterpret_cast<const uint4*>(a0);
  const uint4 hi = (a0 + 16 < a + n) ? *reinterpret_cast<const uint4*>(a0 + 16)
                                     : make_uint4(0u, 0u, 0u, 0u);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = s >> 2, sh = (s & 3) * 8;
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    x[i] = q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
  }
  uint32_t out[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t v = __funnelshift_r(x[j], x[j + 1], sh);
    const int keep = min(4, max(0, n - 4 * j));             // valid bytes of this word
    out[j] = keep >= 4 ? v : v & ((1u << (8 * keep)) - 1u);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

template <int BM, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
assoc_matmul_kernel(const unsigned char* __restrict__ q, const unsigned char* __restrict__ p,
                    float* __restrict__ out, int B, int C, int K) {
  using G = Cfg<BM>;
  constexpr int STAGES = G::STAGES, WN = G::WN;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int* qsum = reinterpret_cast<int*>(smem + (G::RING > G::TILE ? G::RING : G::TILE));
  int* psum = qsum + BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp / 4;
  const int g = blockIdx.z, b0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  const unsigned char* qg = q + (size_t)g * B * K;
  const unsigned char* pg = p + (size_t)g * C * K;
  const int nk = (K + BK - 1) / BK;
  // warpgroup wg's output tile: 64 rows x WN classes
  const int wrow = BM == 128 ? 64 * wg : 0, wcol = BM == 128 ? 0 : 64 * wg;

  // this thread stages chunk tid % 8 of rows tid / 8 + 32 i of both tiles
  constexpr int AI = BM * CHUNKS / THREADS, BI = BN * CHUNKS / THREADS;
  const int lrow = tid / CHUNKS, lch = tid % CHUNKS;
  int qpart[AI], ppart[BI];
#pragma unroll
  for (int i = 0; i < AI; ++i) qpart[i] = 0;
#pragma unroll
  for (int i = 0; i < BI; ++i) ppart[i] = 0;

  auto load_tile = [&](int kt, int stage) {
    unsigned char* sa = smem + stage * G::STAGE_BYTES;
    unsigned char* sb = sa + BM * BK;
    const int k = kt * BK + lch * 16;
#pragma unroll
    for (int i = 0; i < AI; ++i) {
      const int r = lrow + i * (THREADS / CHUNKS);
      const bool ok = b0 + r < B;
      const unsigned char* src = qg + (size_t)(ok ? b0 + r : 0) * K;
      if (ALIGNED) {
        cp_async16(smem_u32(sa + swz(r, lch)), src + (k < K ? k : 0), ok && k < K ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(sa + swz(r, lch)) =
            ok ? load16_unaligned(src, k, K) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int i = 0; i < BI; ++i) {
      const int r = lrow + i * (THREADS / CHUNKS);
      const bool ok = c0 + r < C;
      const unsigned char* src = pg + (size_t)(ok ? c0 + r : 0) * K;
      if (ALIGNED) {
        cp_async16(smem_u32(sb + swz(r, lch)), src + (k < K ? k : 0), ok && k < K ? 16 : 0);
      } else {
        *reinterpret_cast<uint4*>(sb + swz(r, lch)) =
            ok ? load16_unaligned(src, k, K) : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  int acc[WN / 2];
#pragma unroll
  for (int i = 0; i < WN / 2; ++i) acc[i] = 0;

#pragma unroll
  for (int s = 0; s < STAGES; ++s) {          // the ring's worth of k in flight at once
    if (s < nk) load_tile(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));   // tile kt landed
    // this thread's writes of tile kt, visible to the tensor cores' (async) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    const unsigned char* sa = smem + (kt % STAGES) * G::STAGE_BYTES;
    const unsigned char* sb = sa + BM * BK;
    const uint64_t da = sw128_desc(smem_u32(sa + wrow * BK));
    const uint64_t db = sw128_desc(smem_u32(sb + wcol * BK));
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {       // 32 bytes of k: +2 in 16-byte units
      if constexpr (WN == 128) {
        wgmma_n128(acc, da + 2 * ks, db + 2 * ks);
      } else {
        wgmma_n64(acc, da + 2 * ks, db + 2 * ks);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the byte sums |q|, |p|, from the chunks this thread staged, while the products run
#pragma unroll
    for (int i = 0; i < AI; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(sa + swz(lrow + i * (THREADS / CHUNKS), lch));
      qpart[i] += byte_sum(v);
    }
#pragma unroll
    for (int i = 0; i < BI; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(sb + swz(lrow + i * (THREADS / CHUNKS), lch));
      ppart[i] += byte_sum(v);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (kt + STAGES < nk) {       // refill the stage once every warp is done with it
      __syncthreads();
      load_tile(kt + STAGES, kt % STAGES);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // row counts: the eight threads of a row are neighbouring lanes
#pragma unroll
  for (int i = 0; i < AI; ++i) {
    int v = qpart[i];
#pragma unroll
    for (int x = 1; x < CHUNKS; x <<= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, x);
    if (lch == 0) qsum[lrow + i * (THREADS / CHUNKS)] = v;
  }
#pragma unroll
  for (int i = 0; i < BI; ++i) {
    int v = ppart[i];
#pragma unroll
    for (int x = 1; x < CHUNKS; x <<= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, x);
    if (lch == 0) psum[lrow + i * (THREADS / CHUNKS)] = v;
  }
  __syncthreads();                // the ring is free and the counts are in

  // accumulator j of a thread: row wrow + 16 (warp % 4) + lane / 4 (+ 8 for
  // j % 4 >= 2), class wcol + 8 (j / 4) + 2 (lane % 4) + j % 2
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < WN / 8; ++nt) {
    const int c = wcol + nt * 8 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wrow + 16 * (warp & 3) + (lane >> 2) + 8 * h;
      const int base = K - 2 * qsum[r];
      float2 v;
      v.x = (float)(4 * acc[4 * nt + 2 * h] + base - 2 * psum[c]);
      v.y = (float)(4 * acc[4 * nt + 2 * h + 1] + base - 2 * psum[c + 1]);
      *reinterpret_cast<float2*>(tile + r * G::OUT_LD + c) = v;
    }
  }
  __syncthreads();
  const int nb = min(BM, B - b0), nc = min(BN, C - c0);
  float* og = out + ((size_t)g * B + b0) * C + c0;
  if (C % 4 == 0) {               // rows of float4 (og is 16-byte aligned then)
    for (int e = tid; e < nb * (BN / 4); e += THREADS) {
      const int r = e / (BN / 4), c = 4 * (e % (BN / 4));
      if (c < nc) {
        *reinterpret_cast<float4*>(og + (size_t)r * C + c) =
            *reinterpret_cast<const float4*>(tile + r * G::OUT_LD + c);
      }
    }
  } else {
    for (int e = tid; e < nb * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      if (c < nc) og[(size_t)r * C + c] = tile[r * G::OUT_LD + c];
    }
  }
}

template <int BM, bool ALIGNED>
int launch(const void* q, const void* p, void* out, int G, int B, int C, int K,
           cudaStream_t stream) {
  const size_t smem = Cfg<BM>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(assoc_matmul_kernel<BM, ALIGNED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + BN - 1) / BN, (B + BM - 1) / BM, G);
  assoc_matmul_kernel<BM, ALIGNED><<<grid, THREADS, smem, stream>>>(
      (const unsigned char*)q, (const unsigned char*)p, (float*)out, B, C, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int assoc_matmul_launch(const void* q, const void* p, void* out, int G, int B,
                                   int C, int K, void* stream) {
  if (G <= 0 || B <= 0 || C <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = K % 16 == 0 && ((uintptr_t)q | (uintptr_t)p) % 16 == 0;
  // 128-query tiles only where they still give every SM two blocks
  const long long big = (long long)G * ((B + 127) / 128) * ((C + BN - 1) / BN);
  if (big >= 2 * 132) {
    return aligned ? launch<128, true>(q, p, out, G, B, C, K, s)
                   : launch<128, false>(q, p, out, G, B, C, K, s);
  }
  return aligned ? launch<64, true>(q, p, out, G, B, C, K, s)
                 : launch<64, false>(q, p, out, G, B, C, K, s);
}
