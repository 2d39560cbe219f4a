// Fused attention forward (causal / sliding-window GQA, online softmax) for
// Hopper (sm_90a), plain C interface.
//
// Replaces flash_fwd_pallas / _fa_kernel of
// src/repro/kernels/flash_attention/kernel.py, which computes what the
// model's blockwise scan (`_flash_fwd_impl`, src/repro/models/layers.py)
// computes: q [B, Sq, H, D] against k, v [B, Skv, KH, D], query head h reading
// kv head h / (H / KH) (no expanded KV in memory); scores q.k / sqrt(D) in
// f32, masked to NEG_INF = -1e30 where k_pos > q_pos (causal) or
// q_pos - k_pos >= window (window > 0), q_pos = q_offset + row; m, l and the
// accumulator carried in f32 across kv tiles; P cast to the input type for
// the P.V product, as the reference casts it; out = acc / max(l, 1e-30) in
// the input type. Unlike the Pallas wrapper it takes any Sq and Skv: keys
// past Skv score -inf inside the tile, so they add nothing even to a row
// that sees no key (which, as in the reference, gets the mean of V over all
// Skv keys: a block holding such a row visits every kv tile).
//
// Given an `lse` pointer (the training forward; null on every serve path,
// which then writes nothing more) it also writes each row's log-sum-exp
// [B, H, Sq] in f32, in natural-log units of the scaled scores as the
// reference's `m + log(max(l, 1e-30))`: the backward kernel
// (flash_attention_bwd.cu) recomputes P = exp(s - lse) from it. A row that
// sees no key keeps m = NEG_INF, and -1e30 + log(l) rounds back to -1e30.
//
// What bounds it on the H100: operations. At the prefill shape (B = 8,
// S = 1024, H = 32, KH = 4, D = 64, causal, bf16) it moves 75.5 MB (0.0225 ms
// at 3.35 TB/s) and does 34.4 GFLOP over the causal pairs (0.0347 ms at the
// bf16 tensor-core peak of 989 TFLOP/s).
//
// The dtype chooses the design, fixed for each:
//
// bf16: both products on the tensor cores with wgmma (flash_fwd_mma_kernel).
// A block of two warpgroups owns (b * H + h, 128 query rows), a warpgroup 64
// rows, a warp 16 of them. S = Q.K^T is wgmma m64nBKk16 with Q and the K tile
// read from shared memory (both K-major, as they lie in device memory); the
// online softmax runs on S's accumulator fragments in registers (a row's max
// is two shuffles within its quad, the scale folded into the exponent, l kept
// per thread and summed once at the end, O rescaled only when a row max
// moved); P is rounded to bf16 in registers and fed straight back as the
// register A operand of the P.V wgmma (m64nDk16, the S accumulator layout of
// two n8 tiles is the A layout of one k16 step), with the V tile read from
// shared memory as a transposed (MN-major) B. K and V stay bf16 in shared
// memory: 64-key tiles (32 at D = 256) in a two-stage cp.async ring, one
// __syncthreads a tile, in the canonical 128/64/32-byte swizzled layouts
// wgmma reads (D >= 64 in 64-column blocks). Tiles that no row of the block
// can see are not visited, a warpgroup skips tiles none of its rows can see,
// and only tiles that cross a mask edge evaluate the mask per element: for a
// row with a visible key this changes only the order of the sums (a masked
// tile's p are wiped exactly by alpha = exp(-1e30 - m) = 0). The output is
// staged in shared memory and written in 16-byte rows. Query tiles run
// heaviest first. D <= 64 is held to 128 registers: two blocks an SM.
//
// f32: the SIMT kernel (flash_fwd_simt_kernel), f32 FMAs on the CUDA cores
// (67 TFLOP/s at best). It beats SDPA in f32 on this card, and TF32 tensor
// cores would round the inputs to 10 bits, which the f32 model's identity
// with its plain twin does not survive. A block of 256 threads owns 64 query
// rows, four threads a row splitting D by float4 chunks; each kv tile is
// staged into shared memory by the whole block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

#include "flash_mma.cuh"

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;                 // query rows a warpgroup owns
constexpr int MMA_BQ = 2 * WG_ROWS;         // query rows per block (two warpgroups)
constexpr int MMA_THREADS = 256;

template <int D> struct Mma {
  static constexpr int BK = D >= 256 ? 32 : 64;     // keys per kv tile
  static constexpr int CH = D / 8;                  // 16-byte chunks a row
  static constexpr size_t Q_BYTES = (size_t)MMA_BQ * D * 2;
  static constexpr size_t KV_BYTES = (size_t)BK * D * 2;        // one K or V tile
  // Q, K and V in two stages, and the 1024-byte alignment of the swizzle atoms
  static constexpr size_t SMEM = Q_BYTES + 4 * KV_BYTES + 1024;
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS, D <= 64 ? 2 : 1)   // two blocks an SM
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int H, int KH, int causal,
                     int window, int q_offset, float scale_log2, float scale) {
  using M = Mma<D>;
  constexpr int BK = M::BK, CH = M::CH;
  constexpr int NT = BK / 8;       // n8 tiles of keys in S
  constexpr int DT = D / 8;        // n8 tiles of the output
  constexpr int KS = D / 16;       // k16 steps of Q.K^T
  constexpr int PS = BK / 16;      // k16 steps of P.V
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;
  unsigned char* skv = smem + M::Q_BYTES;   // stage s: K at 2s, V at 2s + 1 (KV_BYTES each)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;   // heaviest query tile first
  const int nrows = min(MMA_BQ, Sq - i0);
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KH * D;
  const bf16* qbase = q + ((size_t)b * Sq + i0) * q_row + (size_t)h * D;
  const bf16* kbase = k + (size_t)b * Skv * kv_row + (size_t)kh * D;
  const bf16* vbase = v + (size_t)b * Skv * kv_row + (size_t)kh * D;

  int k_beg, k_end;
  kv_range(q_offset + i0, q_offset + i0 + nrows - 1, Skv, causal, window, BK, k_beg, k_end);
  const int ntiles = k_end > k_beg ? (k_end - k_beg + BK - 1) / BK : 0;

  auto load_kv = [&](int t, int stage) {
    const int k0 = k_beg + t * BK;
    unsigned char* sk = skv + (size_t)(2 * stage) * M::KV_BYTES;
    unsigned char* sv = sk + M::KV_BYTES;
    for (int e = tid; e < BK * CH; e += MMA_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool ok = k0 + r < Skv;
      const size_t off = (ok ? (size_t)(k0 + r) * kv_row : 0) + (size_t)c * 8;
      cp_async16(sk + tile_off<D>(r, c, BK), kbase + off, ok ? 16 : 0);
      cp_async16(sv + tile_off<D>(r, c, BK), vbase + off, ok ? 16 : 0);
    }
  };

  for (int e = tid; e < MMA_BQ * CH; e += MMA_THREADS) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < nrows;
    cp_async16(sq + tile_off<D>(r, c, MMA_BQ),
               qbase + (ok ? (size_t)r * q_row : 0) + (size_t)c * 8, ok ? 16 : 0);
  }
  if (ntiles > 0) load_kv(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);

  // this warpgroup's rows: block rows 64 wg ..; a warp's 16 rows are
  // 16 warp .. 16 warp + 15, a thread's lane / 4 and lane / 4 + 8 of them
  const int wgr0 = wg * WG_ROWS;
  const int wglive = min(WG_ROWS, nrows - wgr0);      // <= 0: no live row
  const int qg_lo = q_offset + i0 + wgr0, qg_hi = qg_lo + max(wglive, 1) - 1;
  const bool wg_empty = wglive > 0 && (sees_no_key(qg_lo, Skv, causal, window) ||
                                       sees_no_key(qg_hi, Skv, causal, window));
  const int qw_lo = q_offset + i0 + 16 * warp, qw_hi = qw_lo + 15;
  const int qp0 = qw_lo + (lane >> 2), qp1 = qp0 + 8;
  const uint32_t sq_addr = smem_u32(sq);

  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this thread's share

  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    // this thread's copies, visible to the tensor cores' (async proxy) reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();              // tile t landed; stage (t + 1) & 1 is consumed
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const int k0 = k_beg + t * BK;
    bool skip = wglive <= 0;
    if (!skip && !wg_empty) {                         // the tile hidden from every row
      skip = (causal && k0 > qg_hi) || (window > 0 && qg_lo - (k0 + BK - 1) >= window);
    }
    if (skip) continue;           // uniform over the warpgroup
    const uint32_t sk_addr = smem_u32(skv + (size_t)(2 * (t & 1)) * M::KV_BYTES);
    const uint32_t sv_addr = sk_addr + (uint32_t)M::KV_BYTES;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss<BK>(&s[0][0], kmajor_desc<D>(sq_addr, MMA_BQ, wgr0, kk),
                   kmajor_desc<D>(sk_addr, BK, 0, kk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // the mask, on raw scores, only on tiles crossing an edge; m stays raw and
    // the scale (into the log2 domain) is applied in the exponent
    const bool inside = k0 + BK <= Skv && (!causal || k0 + BK - 1 <= qw_lo) &&
                        (window <= 0 || qw_hi - k0 < window);
    if (!inside) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (kp >= Skv) {
            s[j][e] = -INFINITY;
          } else if ((causal && kp > qp) || (window > 0 && qp - kp >= window)) {
            s[j][e] = NEG_INF;
          }
        }
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 2));
    // __fmul_rn: never contracted into an FMA, so x * scale - ms is exactly 0
    // where x == mx (a row that sees no key so far gets exp2(0) = 1)
    const float ms0 = __fmul_rn(mx0, scale_log2), ms1 = __fmul_rn(mx1, scale_log2);
    const float al0 = exp2f(__fmul_rn(m0, scale_log2) - ms0);
    const float al1 = exp2f(__fmul_rn(m1, scale_log2) - ms1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
    if (inside) {                 // every score finite: one FFMA an exponent
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2f(fmaf(s[j][0], scale_log2, -ms0));
        s[j][1] = exp2f(fmaf(s[j][1], scale_log2, -ms0));
        s[j][2] = exp2f(fmaf(s[j][2], scale_log2, -ms1));
        s[j][3] = exp2f(fmaf(s[j][3], scale_log2, -ms1));
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = exp2f(__fmul_rn(s[j][0], scale_log2) - ms0);
        s[j][1] = exp2f(__fmul_rn(s[j][1], scale_log2) - ms0);
        s[j][2] = exp2f(__fmul_rn(s[j][2], scale_log2) - ms1);
        s[j][3] = exp2f(__fmul_rn(s[j][3], scale_log2) - ms1);
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    if (__any_sync(0xFFFFFFFFu, al0 != 1.f || al1 != 1.f)) {   // a row max moved
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        o[j][0] *= al0; o[j][1] *= al0; o[j][2] *= al1; o[j][3] *= al1;
      }
    }
    // P in bf16 as the A operand of P.V: two n8 tiles of S make one k16 step
    uint32_t pa[PS][4];
#pragma unroll
    for (int ks = 0; ks < PS; ++ks) {
      pa[ks][0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[ks][1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[ks][2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[ks][3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
    }
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < PS; ++ks) {
      wgmma_rs<D>(&o[0][0], pa[ks], mnmajor_desc<D>(sv_addr, BK, ks));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const int wlive = min(16, nrows - 16 * warp);
  if (wlive <= 0) return;
  l0 += __shfl_xor_sync(0xFFFFFFFFu, l0, 1);
  l0 += __shfl_xor_sync(0xFFFFFFFFu, l0, 2);
  l1 += __shfl_xor_sync(0xFFFFFFFFu, l1, 1);
  l1 += __shfl_xor_sync(0xFFFFFFFFu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // the warp's 16 rows of Q in shared memory are its own: stage the output there
  const int r0 = 16 * warp + (lane >> 2);
  if (lse != nullptr && (lane & 3) == 0) {
    // m is a raw score (the scale lives in the exponent): back to the scaled
    // scores' natural log; NEG_INF stays NEG_INF, as the reference's m does
    float* lrow = lse + ((size_t)b * H + h) * Sq + i0;
    if ((lane >> 2) < wlive) {
      lrow[r0] = (m0 == NEG_INF ? NEG_INF : m0 * scale) + logf(fmaxf(l0, 1e-30f));
    }
    if ((lane >> 2) + 8 < wlive) {
      lrow[r0 + 8] = (m1 == NEG_INF ? NEG_INF : m1 * scale) + logf(fmaxf(l1, 1e-30f));
    }
  }
  const int cb = 4 * (lane & 3);                      // byte offset inside a chunk
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(sq + tile_off<D>(r0, j, MMA_BQ) + cb) =
        pack_bf16(o[j][0] * inv0, o[j][1] * inv0);
    *reinterpret_cast<uint32_t*>(sq + tile_off<D>(r0 + 8, j, MMA_BQ) + cb) =
        pack_bf16(o[j][2] * inv1, o[j][3] * inv1);
  }
  __syncwarp();
  bf16* obase = out + ((size_t)b * Sq + i0) * q_row + (size_t)h * D;
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = e % CH;
    if (r < wlive) {
      *reinterpret_cast<uint4*>(obase + (size_t)(16 * warp + r) * q_row + c * 8) =
          *reinterpret_cast<const uint4*>(sq + tile_off<D>(16 * warp + r, c, MMA_BQ));
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int BQ = 64;          // query rows per block
constexpr int LANES = 4;        // threads per query row

template <int D> struct Tile {
  static constexpr int BK = D >= 256 ? 32 : 64;     // keys per kv tile
  static constexpr int NC = D / 16;                 // float4 chunks a lane owns
  static constexpr size_t SMEM = 2 * (size_t)BK * D * sizeof(float);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Skv, int H, int KH, int causal,
                      int window, int q_offset, float scale) {
  constexpr int BK = Tile<D>::BK;
  constexpr int NC = Tile<D>::NC;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);      // [BK][D]
  float* vs = ks + BK * D;                          // [BK][D]

  const int tid = threadIdx.x;
  const int r = tid / LANES, lane = tid % LANES;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest query tile first
  const int i = i0 + r;
  const bool live = i < Sq;
  const int q_pos = q_offset + i;

  float4 qr[NC], acc[NC];
  const float* qrow = q + ((size_t)b * Sq + (live ? i : 0)) * H * D + (size_t)h * D;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    qr[j] = live ? load4(qrow + 4 * (j * LANES + lane)) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF, l = 0.f;

  int k_beg, k_end;
  kv_range(q_offset + i0, q_offset + min(i0 + BQ, Sq) - 1, Skv, causal, window, BK, k_beg,
           k_end);

  const size_t kv_row = (size_t)KH * D;             // stride between positions
  const float* kbase = k + (size_t)b * Skv * kv_row + (size_t)kh * D;
  const float* vbase = v + (size_t)b * Skv * kv_row + (size_t)kh * D;

  for (int k0 = k_beg; k0 < k_end; k0 += BK) {
    __syncthreads();                                // the last tile is consumed
    for (int e = tid; e < BK * D / 4; e += THREADS) {
      const int row = e / (D / 4), c = e % (D / 4);
      const int kp = k0 + row;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (kp < Skv) {
        kx = load4(kbase + (size_t)kp * kv_row + 4 * c);
        vx = load4(vbase + (size_t)kp * kv_row + 4 * c);
      }
      store4(ks + row * D + 4 * c, kx);
      store4(vs + row * D + 4 * c, vx);
    }
    __syncthreads();

    float s[BK];
    float m_new = m;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4* krow = reinterpret_cast<const float4*>(ks + kk * D);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 kx = krow[j * LANES + lane];
        part = fmaf(qr[j].x, kx.x, part);
        part = fmaf(qr[j].y, kx.y, part);
        part = fmaf(qr[j].z, kx.z, part);
        part = fmaf(qr[j].w, kx.w, part);
      }
      part += __shfl_xor_sync(0xFFFFFFFFu, part, 1);
      part += __shfl_xor_sync(0xFFFFFFFFu, part, 2);
      const int kp = k0 + kk;
      const bool ok = (!causal || kp <= q_pos) && (window <= 0 || q_pos - kp < window);
      s[kk] = kp >= Skv ? -INFINITY : ok ? part * scale : NEG_INF;
      m_new = fmaxf(m_new, s[kk]);
    }
    const float alpha = expf(m - m_new);
    float tile_sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      s[kk] = expf(s[kk] - m_new);
      tile_sum += s[kk];
    }
    l = l * alpha + tile_sum;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      acc[j].x *= alpha; acc[j].y *= alpha; acc[j].z *= alpha; acc[j].w *= alpha;
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4* vrow = reinterpret_cast<const float4*>(vs + kk * D);
      const float p = s[kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 vx = vrow[j * LANES + lane];
        acc[j].x = fmaf(p, vx.x, acc[j].x);
        acc[j].y = fmaf(p, vx.y, acc[j].y);
        acc[j].z = fmaf(p, vx.z, acc[j].z);
        acc[j].w = fmaf(p, vx.w, acc[j].w);
      }
    }
    m = m_new;
  }

  if (!live) return;
  if (lse != nullptr && lane == 0) {
    lse[((size_t)b * H + h) * Sq + i] = m + logf(fmaxf(l, 1e-30f));
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* orow = out + ((size_t)b * Sq + i) * H * D + (size_t)h * D;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    store4(orow + 4 * (j * LANES + lane),
           make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv, acc[j].w * inv));
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
                int Skv, int H, int KH, int causal, int window, int q_offset, cudaStream_t stream) {
  const size_t smem = Mma<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + MMA_BQ - 1) / MMA_BQ);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, lse, Sq, Skv, H, KH, causal,
      window, q_offset, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
               int Skv, int H, int KH, int causal, int window, int q_offset, cudaStream_t stream) {
  const size_t smem = Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_simt_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_simt_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, Sq, Skv, H, KH,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
           int Skv, int H, int KH, int causal, int window, int q_offset, int is_bf16,
           cudaStream_t s) {
  return is_bf16
             ? launch_bf16<D>(q, k, v, out, lse, B, Sq, Skv, H, KH, causal, window, q_offset, s)
             : launch_f32<D>(q, k, v, out, lse, B, Sq, Skv, H, KH, causal, window, q_offset, s);
}

}  // namespace

// lse: [B, H, Sq] f32, or null to write none (the serve paths)
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* out, void* lse, int B, int Sq, int Skv, int H,
                                          int KH, int D, int causal, int window, int q_offset,
                                          int bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH || Skv < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  switch (D) {
    case 16: return launch<16>(q, k, v, out, l, B, Sq, Skv, H, KH, causal, window, q_offset, bf16, s);
    case 32: return launch<32>(q, k, v, out, l, B, Sq, Skv, H, KH, causal, window, q_offset, bf16, s);
    case 64: return launch<64>(q, k, v, out, l, B, Sq, Skv, H, KH, causal, window, q_offset, bf16, s);
    case 128: return launch<128>(q, k, v, out, l, B, Sq, Skv, H, KH, causal, window, q_offset, bf16, s);
    case 256: return launch<256>(q, k, v, out, l, B, Sq, Skv, H, KH, causal, window, q_offset, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
