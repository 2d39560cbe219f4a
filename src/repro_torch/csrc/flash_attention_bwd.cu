// Fused attention backward (causal / sliding-window GQA) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the FlashAttention-2 custom VJP of the model's attention,
// `_flash_vjp_bwd` (src/repro/models/layers.py, registered on `_flash` by
// `_flash.defvjp`). That is not a Pallas kernel: it is a blockwise lax.scan
// that XLA fuses into loops keeping only block-sized temporaries. Given
// q, dO, O [B, Sq, H, D], k, v [B, Skv, KH, D] and the forward's log-sum-exp
// lse [B, H, Sq] (f32, natural log of the scaled scores), it computes what
// the reference computes, in the same arithmetic:
//   delta = rowsum(dO * O) in f32;
//   s = q.k / sqrt(D) in f32, NEG_INF = -1e30 where the mask hides the key
//       (k_pos > q_pos when causal; q_pos - k_pos >= window when window > 0;
//       q_pos = q_offset + row);
//   P = exp(s - lse), dP = dO.v, dS = P * (dP - delta) / sqrt(D), all f32;
//   dV = P^T dO, dK = dS^T q (the G query heads of a kv head summed onto
//       it), dQ = dS k; each cast once to the inputs' type (bf16 or f32).
// A row that sees no key has lse = -1e30 (m + log l rounds back to m in
// f32), so P = exp(-1e30 + 1e30) = 1 on every key, as in the reference,
// whose forward gives such a row the mean of V.
//
// What bounds it on the H100: operations. At the training shape (B = 8,
// S = 1024, 32 heads over 4, D = 64, causal) the function needs dQ, dK, dV
// and the recomputed S and dP over the 134 M visible (query, key) pairs:
// 10 * pairs * D = 86 GFLOP (0.087 ms at the bf16 tensor-core peak), against
// 4 * pairs * D for the forward, while it moves 67 MB (0.020 ms at 3.35 TB/s).
//
// Two passes, as in FlashAttention-2, and no atomics, so the gradients are
// the same bits from run to run: a dK/dV pass owns a tile of keys and loops
// over the G query heads of its kv head and the query tiles that can see the
// tile, a dQ pass owns a tile of query rows and loops over the key tiles
// they can see. Each recomputes S, P, dP and dS for its (query tile, key
// tile) pairs: 14 * D flops a visible pair across both passes instead of 10,
// the price of owning each output. delta comes from a small first kernel,
// one warp a row. The dtype chooses the design, fixed for each:
//
// bf16: every product on the tensor cores with wgmma, one warpgroup a block
// (flash_bwd_dkdv_mma_kernel, flash_bwd_dq_mma_kernel), with the forward's
// swizzled tiles, descriptors and wrappers (flash_mma.cuh). S and dP are
// SS products of the bf16 inputs with f32 accumulation, so they round
// nothing the f32 arithmetic does not. P and dS, the register A operands of
// the three gradient products, are each split into two bf16 terms, hi =
// bf16(x) and lo = bf16(x - hi) (16 significant bits), and each gradient
// product is issued for both terms into one f32 accumulator: rounding P and
// dS to bf16 alone (the reference's FLASH_P_BF16) puts the gradients up to
// 2.2x as far from the exact ones as the f32 arithmetic does
// (benchmarks/torch_flash_bwd_rounding.py), and the split keeps them where
// the f32 arithmetic puts them, for twice the gradient products' work (the
// plain twin's `p_bf16=2`).
//   dK/dV pass: one block per (b, kv head, 64 keys; and half of D at D =
//   256). The K and V tile stays in shared memory; Q and dO tiles of BQ
//   rows, with their lse and delta, stream through a two-stage cp.async
//   ring. The products run transposed, keys as the accumulator's rows:
//   S^T = K.Q^T and dP^T = V.dO^T (SS, K-major), then P^T and dS^T in
//   registers feed dV += P^T.dO and dK += dS^T.Q (RS, dO and Q read as
//   MN-major B). dK and dV stay in f32 registers until the end.
//   dQ pass: one block per (b, head, 64 query rows), heaviest first. The Q
//   and dO tile stays in shared memory, K and V tiles of BK keys stream
//   through the ring; S = Q.K^T and dP = dO.V^T (SS), dS in registers,
//   dQ += dS.K (RS, K as MN-major B). dQ stays in f32 registers.
//   Registers are what sizes the tiles (a thread holds 32 of a 64 x 64 f32
//   tile): the dK/dV pass holds dK and dV (D / 2 each a thread), S^T and
//   dP^T (BQ / 2 each) and the split P^T or dS^T (BQ / 2); the dQ pass dQ
//   (D / 2), S and dP (BK / 2 each) and the split dS (BK / 2).
//     D <= 64: BQ = BK = 64 (at D = 64: 64 + 64 + 32 and 32 + 64 + 32);
//     D = 128: BQ = 32 (128 + 32 + 16), BK = 64 (64 + 64 + 32);
//     D = 256: dK and dV in two halves of 128 columns, a block each, with
//     S^T and dP^T recomputed for each (128 + 32 + 16), BQ = 32; BK = 32
//     (128 + 32 + 16).
//   At D <= 64 the dK/dV pass is held to three blocks an SM (168
//   registers). Each block issues a product, waits for it, then works on
//   its registers: the tensor cores stay busy only while another block's
//   products are in flight (software pipelining across iterations made
//   ptxas serialize the wgmmas instead; benchmarks/torch_flash_bwd_ablation.py
//   prints where the time goes).
//   Query tiles that no key of the tile can see are not visited (and key
//   tiles no row can see), and only tiles that cross a mask edge or the
//   ragged end evaluate the mask per element. Outputs are staged in shared
//   memory and written in 16-byte rows.
//
// f32: the SIMT kernels (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel), every
// product in f32 on the CUDA cores (67 TFLOP/s at best): TF32 would round
// the inputs to 10 bits, which the f32 model's identity with its plain twin
// does not survive. A block is a 16 x 16 grid of threads; each owns a
// strided micro-tile (rows ty + 16 i, columns tx + 16 j) of S and of its
// accumulators, so a warp's shared-memory reads are broadcasts or hit
// distinct banks (rows padded to D + 1 and BK + 1 floats).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 256;        // a 16 x 16 grid of threads

#include "flash_mma.cuh"

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

template <int D> struct Cfg {
  static constexpr int BK = D >= 256 ? 32 : 64;    // keys per tile
  static constexpr int BQ = D >= 256 ? 32 : 64;    // query rows per tile
  static constexpr int LD = D + 1;                 // padded row of a [rows][D] tile
  static constexpr int LP = BK + 1;                // padded row of a [BQ][BK] tile
  static constexpr int MQ = BQ / 16;               // query rows a thread owns
  static constexpr int NK = BK / 16;               // keys a thread owns
  static constexpr int ND = D / 16;                // head-dim columns a thread owns
  static constexpr size_t TILES = (size_t)(2 * BK + 2 * BQ) * LD;   // K, V, Q, dO
  static constexpr size_t DKDV_SMEM = (TILES + 2 * (size_t)BQ * LP + 2 * BQ) * sizeof(float);
  static constexpr size_t DQ_SMEM = (TILES + (size_t)BQ * LP + 2 * BQ) * sizeof(float);
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// rows [0, rows) of a tile whose row r starts at src + r * stride, into
// shared memory as f32 rows of LD floats; rows at or past `valid` are zero
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, size_t stride,
                                          int rows, int valid) {
  for (int e = threadIdx.x; e < rows * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r < valid ? to_f(src[(size_t)r * stride + c]) : 0.f;
  }
}

// lse and delta of rows i0 .. i0 + BQ - 1 of head (b, h); zero past `valid`
template <int BQ>
__device__ __forceinline__ void load_rows(float* slse, float* sdl, const float* __restrict__ lse,
                                          const float* __restrict__ delta, size_t base,
                                          int valid) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    slse[r] = r < valid ? lse[base + r] : 0.f;
    sdl[r] = r < valid ? delta[base + r] : 0.f;
  }
}

// P and dS of the thread's micro-tile of one (query tile, key tile) pair:
// query rows ty + 16 i (position q0 + row, `nq` live), keys tx + 16 j
// (position k0 + key, `nk` live). Dead rows and keys get P = dS = 0.
template <int D>
__device__ __forceinline__ void probs(const float* sq, const float* sdo, const float* sk,
                                      const float* sv, const float* slse, const float* sdl,
                                      int q0, int nq, int k0, int nk, int causal, int window,
                                      float scale, float (&p)[Cfg<D>::MQ][Cfg<D>::NK],
                                      float (&ds)[Cfg<D>::MQ][Cfg<D>::NK]) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, MQ = C::MQ, NK = C::NK;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[MQ][NK], dp[MQ][NK];
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
#pragma unroll
    for (int j = 0; j < NK; ++j) s[i][j] = dp[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[MQ], g[MQ], kk[NK], vv[NK];
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
      a[i] = sq[(ty + 16 * i) * LD + d];
      g[i] = sdo[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      kk[j] = sk[(tx + 16 * j) * LD + d];
      vv[j] = sv[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int c = tx + 16 * j;
      const int kp = k0 + c;
      float pv = 0.f, dv = 0.f;
      if (r < nq && c < nk) {
        const bool ok = (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
        const float sc = ok ? s[i][j] * scale : NEG_INF;
        pv = expf(sc - slse[r]);
        dv = pv * (dp[i][j] - sdl[r]) * scale;
      }
      p[i][j] = pv;
      ds[i][j] = dv;
    }
  }
}

// the dot of 16 bytes of a and b in f32
__device__ __forceinline__ float dot16(uint4 a, uint4 b, float s, float) {
  const float* x = reinterpret_cast<const float*>(&a);
  const float* y = reinterpret_cast<const float*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) s = fmaf(x[i], y[i], s);
  return s;
}
__device__ __forceinline__ float dot16(uint4 a, uint4 b, float s, bf16) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    s = fmaf(u.y, w.y, fmaf(u.x, w.x, s));
  }
  return s;
}

// delta[b, h, i] = sum_d dO[b, i, h, :] * O[b, i, h, :] in f32: TPR threads a
// row (D / 8 in bf16, D / 4 in f32, at most a warp), 16 bytes a load
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H) {
  constexpr int VEC = 16 / sizeof(T), CHUNKS = D / VEC;
  constexpr int TPR = CHUNKS < 32 ? CHUNKS : 32;
  const size_t t = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const int row = (int)(t / TPR), part = (int)(t % TPR);
  float s = 0.f;
  if (row < rows) {
    const uint4* o = reinterpret_cast<const uint4*>(out + (size_t)row * D);
    const uint4* g = reinterpret_cast<const uint4*>(dout + (size_t)row * D);
    for (int c = part; c < CHUNKS; c += TPR) s = dot16(g[c], o[c], s, T());
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
  if (part == 0 && row < rows) {                    // row = (b * Sq + i) * H + h
    const int h = row % H, bi = row / H;
    const int i = bi % Sq, b = bi / Sq;
    delta[((size_t)b * H + h) * Sq + i] = s;
  }
}

// pass 1: dK and dV of one (b, kv head, key tile)
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      int Sq, int Skv, int H, int KH, int causal, int window, int q_offset,
                      float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, LD = C::LD, LP = C::LP, MQ = C::MQ, NK = C::NK,
                ND = C::ND;
  extern __shared__ float smem[];
  float* sk = smem;                    // [BK][LD]
  float* sv = sk + BK * LD;            // [BK][LD]
  float* sq = sv + BK * LD;            // [BQ][LD]
  float* sdo = sq + BQ * LD;           // [BQ][LD]
  float* sp = sdo + BQ * LD;           // [BQ][LP]
  float* sds = sp + BQ * LP;           // [BQ][LP]
  float* slse = sds + BQ * LP;         // [BQ]
  float* sdl = slse + BQ;              // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / KH, kh = blockIdx.x % KH;
  const int k0 = blockIdx.y * BK;      // early keys (the heaviest tiles) first
  const int nk = min(BK, Skv - k0);
  const int G = H / KH;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KH * D;
  const size_t kv_off = ((size_t)b * Skv + k0) * kv_row + (size_t)kh * D;
  load_tile<D>(sk, k + kv_off, kv_row, BK, nk);
  load_tile<D>(sv, v + kv_off, kv_row, BK, nk);

  float acc_k[NK][ND], acc_v[NK][ND];
#pragma unroll
  for (int i = 0; i < NK; ++i) {
#pragma unroll
    for (int j = 0; j < ND; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;
  }

  const int nqt = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int t = 0; t < nqt; ++t) {
      const int i0 = t * BQ;
      const int nq = min(BQ, Sq - i0);
      const int qlo = q_offset + i0, qhi = qlo + nq - 1;
      // rows that see no key lie at the ends of the positions, so the first
      // and last row find them; they take P = 1 on every key
      bool visit = sees_no_key(qlo, Skv, causal, window) || sees_no_key(qhi, Skv, causal, window);
      if (!visit) {
        visit = (!causal || qhi >= k0) && (window <= 0 || qlo - (k0 + nk - 1) < window);
      }
      if (!visit) continue;                         // uniform over the block
      __syncthreads();                              // the last pair's tiles are consumed
      const size_t q_off = ((size_t)b * Sq + i0) * q_row + (size_t)h * D;
      load_tile<D>(sq, q + q_off, q_row, BQ, nq);
      load_tile<D>(sdo, dout + q_off, q_row, BQ, nq);
      load_rows<BQ>(slse, sdl, lse, delta, ((size_t)b * H + h) * Sq + i0, nq);
      __syncthreads();

      float p[MQ][NK], ds[MQ][NK];
      probs<D>(sq, sdo, sk, sv, slse, sdl, qlo, nq, k0, nk, causal, window, scale, p, ds);
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          sp[(ty + 16 * i) * LP + tx + 16 * j] = p[i][j];
          sds[(ty + 16 * i) * LP + tx + 16 * j] = ds[i][j];
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q: keys ty + 16 i, columns tx + 16 j
      for (int r = 0; r < nq; ++r) {
        float pr[NK], dr[NK], o[ND], qv[ND];
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          pr[i] = sp[r * LP + ty + 16 * i];
          dr[i] = sds[r * LP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o[j] = sdo[r * LD + tx + 16 * j];
          qv[j] = sq[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < NK; ++i) {
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            acc_v[i][j] = fmaf(pr[i], o[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(dr[i], qv[j], acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int kr = ty + 16 * i;
    if (kr < nk) {
      const size_t off = kv_off + (size_t)kr * kv_row;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        store(dk + off + tx + 16 * j, acc_k[i][j]);
        store(dv + off + tx + 16 * j, acc_v[i][j]);
      }
    }
  }
}

// pass 2: dQ of one (b, head, query tile)
template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Skv, int H,
                    int KH, int causal, int window, int q_offset, float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, LD = C::LD, LP = C::LP, MQ = C::MQ, NK = C::NK,
                ND = C::ND;
  extern __shared__ float smem[];
  float* sk = smem;                    // [BK][LD]
  float* sv = sk + BK * LD;            // [BK][LD]
  float* sq = sv + BK * LD;            // [BQ][LD]
  float* sdo = sq + BQ * LD;           // [BQ][LD]
  float* sds = sdo + BQ * LD;          // [BQ][LP]
  float* slse = sds + BQ * LP;         // [BQ]
  float* sdl = slse + BQ;              // [BQ]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest query tile first
  const int nq = min(BQ, Sq - i0);
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KH * D;
  const size_t q_off = ((size_t)b * Sq + i0) * q_row + (size_t)h * D;
  load_tile<D>(sq, q + q_off, q_row, BQ, nq);
  load_tile<D>(sdo, dout + q_off, q_row, BQ, nq);
  load_rows<BQ>(slse, sdl, lse, delta, ((size_t)b * H + h) * Sq + i0, nq);

  // the keys these rows can see; every key when one of them sees none
  const int qlo = q_offset + i0, qhi = qlo + nq - 1;
  int beg = 0, end = Skv;
  if (!sees_no_key(qlo, Skv, causal, window) && !sees_no_key(qhi, Skv, causal, window)) {
    end = causal ? min(Skv, qhi + 1) : Skv;
    beg = window > 0 ? max(0, qlo - window + 1) / BK * BK : 0;
  }

  float acc[MQ][ND];
#pragma unroll
  for (int i = 0; i < MQ; ++i) {
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;
  }
  const size_t kv_base = (size_t)b * Skv * kv_row + (size_t)kh * D;
  for (int k0 = beg; k0 < end; k0 += BK) {
    const int nk = min(BK, Skv - k0);
    __syncthreads();                                // the last tile is consumed
    load_tile<D>(sk, k + kv_base + (size_t)k0 * kv_row, kv_row, BK, nk);
    load_tile<D>(sv, v + kv_base + (size_t)k0 * kv_row, kv_row, BK, nk);
    __syncthreads();

    float p[MQ][NK], ds[MQ][NK];
    probs<D>(sq, sdo, sk, sv, slse, sdl, qlo, nq, k0, nk, causal, window, scale, p, ds);
#pragma unroll
    for (int i = 0; i < MQ; ++i) {
#pragma unroll
      for (int j = 0; j < NK; ++j) sds[(ty + 16 * i) * LP + tx + 16 * j] = ds[i][j];
    }
    __syncthreads();

    // dQ += dS K: query rows ty + 16 i, columns tx + 16 j
    for (int c = 0; c < nk; ++c) {
      float dr[MQ], kv[ND];
#pragma unroll
      for (int i = 0; i < MQ; ++i) dr[i] = sds[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < ND; ++j) kv[j] = sk[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < MQ; ++i) {
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = fmaf(dr[i], kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < MQ; ++i) {
    const int r = ty + 16 * i;
    if (r < nq) {
#pragma unroll
      for (int j = 0; j < ND; ++j) store(dq + q_off + (size_t)r * q_row + tx + 16 * j, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int WG = 64;               // accumulator rows of a warpgroup (keys or query rows)
constexpr int WG_THREADS = 128;      // one warpgroup a block

template <int D> struct Bwd {
  // dK/dV pass: 64 keys a block, query tiles of BQ rows, DH columns of dK/dV
  static constexpr int BQ = D >= 128 ? 32 : 64;
  static constexpr int DH = D >= 256 ? 128 : D;
  static constexpr int HALVES = D / DH;
  static constexpr size_t KV_BYTES = (size_t)WG * D * 2;       // the K or V tile
  static constexpr size_t QD_BYTES = (size_t)BQ * D * 2;       // a Q or dO tile
  // K, V; Q and dO in two stages; their lse and delta rows; the 1024-byte
  // alignment of the swizzle atoms
  static constexpr size_t DKDV_SMEM = 2 * KV_BYTES + 4 * QD_BYTES + 4 * BQ * 4 + 1024;
  // dQ pass: 64 query rows a block, key tiles of BK
  static constexpr int BK = D >= 256 ? 32 : 64;
  static constexpr size_t Q_BYTES = (size_t)WG * D * 2;        // the Q or dO tile
  static constexpr size_t K_BYTES = (size_t)BK * D * 2;        // a K or V tile
  static constexpr size_t DQ_SMEM = 2 * Q_BYTES + 4 * K_BYTES + 1024;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// (a, b) as two bf16 pairs: hi = bf16(x) and lo = bf16(x - hi) (x - hi is
// exact in f32)
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// An m64 x (8 NT) accumulator as the split register A operand of NT / 2 k16
// steps: two n8 tiles make one step, as in the forward's P.V
template <int NT>
__device__ __forceinline__ void split_a(const float (&x)[NT][4], uint32_t (&hi)[NT / 2][4],
                                        uint32_t (&lo)[NT / 2][4]) {
#pragma unroll
  for (int ks = 0; ks < NT / 2; ++ks) {
    split_bf16(x[2 * ks][0], x[2 * ks][1], hi[ks][0], lo[ks][0]);
    split_bf16(x[2 * ks][2], x[2 * ks][3], hi[ks][1], lo[ks][1]);
    split_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1], hi[ks][2], lo[ks][2]);
    split_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3], hi[ks][3], lo[ks][3]);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// this thread's copies landed and are visible to the tensor cores' reads
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [0, rows) of a bf16 tile whose row r starts at src + r * stride into
// its swizzled shared-memory layout; rows at or past `valid` are zero
template <int D>
__device__ __forceinline__ void load_tile_async(unsigned char* dst, const bf16* src,
                                                size_t stride, int rows, int valid) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < rows * CH; e += WG_THREADS) {
    const int r = e / CH, c = e % CH;
    const bool ok = r < valid;
    cp_async16(dst + tile_off<D>(r, c, rows), src + (ok ? (size_t)r * stride : 0) + (size_t)c * 8,
               ok ? 16 : 0);
  }
}

// An m64 accumulator of `DT` n8 tiles (columns c0 .. c0 + 8 DT - 1 of a
// D-column row) into a swizzled 64-row tile `st` (this warp's 16 rows), then
// out to rows dst + r * stride (those below `valid`), 16 bytes a copy.
template <int D, int DT>
__device__ __forceinline__ void store_rows(unsigned char* st, const float (&acc)[DT][4], int c0,
                                           bf16* dst, size_t stride, int valid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = 16 * warp + (lane >> 2);
  const int cb = 4 * (lane & 3);                    // byte offset inside a chunk
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(st + tile_off<D>(r0, c0 / 8 + j, WG) + cb) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(st + tile_off<D>(r0 + 8, c0 / 8 + j, WG) + cb) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  for (int e = lane; e < 16 * DT; e += 32) {
    const int r = 16 * warp + e / DT, c = c0 / 8 + e % DT;
    if (r < valid) {
      *reinterpret_cast<uint4*>(dst + (size_t)r * stride + c * 8) =
          *reinterpret_cast<const uint4*>(st + tile_off<D>(r, c, WG));
    }
  }
}

// pass 1: dK and dV of one (b, kv head, 64 keys, DH columns)
template <int D>
__global__ void __launch_bounds__(WG_THREADS, D <= 64 ? 3 : 1)   // three blocks an SM
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int H,
                          int KH, int causal, int window, int q_offset, float scale_log2,
                          float scale) {
  using C = Bwd<D>;
  constexpr int BQ = C::BQ, DH = C::DH;
  constexpr int NT = BQ / 8;       // n8 tiles of queries in S^T
  constexpr int KS = D / 16;       // k16 steps of S^T and dP^T
  constexpr int PS = BQ / 16;      // k16 steps of dV and dK
  constexpr int DT = DH / 8;       // n8 tiles of dK and dV
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align1024(smem_raw);
  unsigned char* sv = sk + C::KV_BYTES;
  unsigned char* sqd = sv + C::KV_BYTES;     // stage s: Q at 2s, dO at 2s + 1 (QD_BYTES each)
  float* srows = reinterpret_cast<float*>(sqd + 4 * C::QD_BYTES);  // stage s: lse, delta

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = blockIdx.x % C::HALVES, bkh = blockIdx.x / C::HALVES;
  const int b = bkh / KH, kh = bkh % KH;
  const int k0 = blockIdx.y * WG;      // early keys (the heaviest tiles) first
  const int nk = min(WG, Skv - k0);
  const int G = H / KH, nqt = (Sq + BQ - 1) / BQ, total = G * nqt;
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KH * D;
  const size_t kv_off = ((size_t)b * Skv + k0) * kv_row + (size_t)kh * D;
  load_tile_async<D>(sk, k + kv_off, kv_row, WG, nk);
  load_tile_async<D>(sv, v + kv_off, kv_row, WG, nk);

  // query tile t is visited when a row of it sees a key of the tile, or sees
  // no key at all (such rows lie at the ends of the positions, so the first
  // and last row find them; they take P = 1 on every key)
  auto visit = [&](int t) {
    const int qlo = q_offset + t * BQ, qhi = q_offset + min(Sq, t * BQ + BQ) - 1;
    if (sees_no_key(qlo, Skv, causal, window) || sees_no_key(qhi, Skv, causal, window)) {
      return true;
    }
    return (!causal || qhi >= k0) && (window <= 0 || qlo - (k0 + nk - 1) < window);
  };
  // iteration it: query head kh * G + it / nqt, query tile it % nqt
  auto next = [&](int it) {
    while (it < total && !visit(it % nqt)) ++it;
    return it;
  };
  auto load_q = [&](int it, int stage) {
    const int h = kh * G + it / nqt, i0 = (it % nqt) * BQ, nq = min(BQ, Sq - i0);
    const size_t off = ((size_t)b * Sq + i0) * q_row + (size_t)h * D;
    unsigned char* st = sqd + (size_t)(2 * stage) * C::QD_BYTES;
    load_tile_async<D>(st, q + off, q_row, BQ, nq);
    load_tile_async<D>(st + C::QD_BYTES, dout + off, q_row, BQ, nq);
    const size_t row = ((size_t)b * H + h) * Sq + i0;
    float* sr = srows + 2 * BQ * stage;
    for (int r = tid; r < BQ; r += WG_THREADS) {
      cp_async4(sr + r, lse + row + (r < nq ? r : 0), r < nq ? 4 : 0);
      cp_async4(sr + BQ + r, delta + row + (r < nq ? r : 0), r < nq ? 4 : 0);
    }
  };

  int it = next(0);
  if (it < total) load_q(it, 0);
  cp_async_commit();

  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  }
  const uint32_t sk_addr = smem_u32(sk), sv_addr = smem_u32(sv);
  // this thread's keys (accumulator rows): kr and kr + 8
  const int kr = 16 * warp + (lane >> 2);
  const float neg_l2 = __fmul_rn(NEG_INF, LOG2E);
  // the columns of this block's half of D in an MN-major Q or dO tile
  const uint32_t col_off = (uint32_t)half * (DH / 64) * BQ * 128;

  for (int n = 0; it < total; ++n) {
    cp_async_wait();
    __syncthreads();              // stage n & 1 landed; stage (n + 1) & 1 is consumed
    const int nx = next(it + 1);
    if (nx < total) load_q(nx, (n + 1) & 1);
    cp_async_commit();
    const int i0 = (it % nqt) * BQ, nq = min(BQ, Sq - i0);
    const int qlo = q_offset + i0, qhi = qlo + nq - 1;
    it = nx;
    const uint32_t sq_addr = smem_u32(sqd + (size_t)(2 * (n & 1)) * C::QD_BYTES);
    const uint32_t sdo_addr = sq_addr + (uint32_t)C::QD_BYTES;
    const float* slse = srows + 2 * BQ * (n & 1);
    const float* sdl = slse + BQ;

    float st[NT][4], dpt[NT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss<BQ>(&st[0][0], kmajor_desc<D>(sk_addr, WG, 0, kk),
                   kmajor_desc<D>(sq_addr, BQ, 0, kk), kk == 0);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss<BQ>(&dpt[0][0], kmajor_desc<D>(sv_addr, WG, 0, kk),
                   kmajor_desc<D>(sdo_addr, BQ, 0, kk), kk == 0);
    }
    wgmma_commit();
    wgmma_wait();

    // P^T = exp(s - lse) (the scale and log2 e folded into one FMA); the
    // mask, keys past Skv and queries past Sq only on tiles crossing them
    const bool inside = k0 + WG <= Skv && i0 + BQ <= Sq && (!causal || k0 + WG - 1 <= qlo) &&
                        (window <= 0 || qhi - k0 < window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float l0 = __fmul_rn(slse[c], LOG2E), l1 = __fmul_rn(slse[c + 1], LOG2E);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = (e & 1) ? l1 : l0;
        float p = exp2f(fmaf(st[j][e], scale_log2, -l));
        if (!inside) {
          const int kp = k0 + kr + 8 * (e >> 1), col = c + (e & 1), qp = q_offset + i0 + col;
          if (kp >= Skv || col >= nq) {
            p = 0.f;
          } else if ((causal && kp > qp) || (window > 0 && qp - kp >= window)) {
            p = exp2f(neg_l2 - l);          // 1 on a row that sees no key, else 0
          }
        }
        st[j][e] = p;
      }
    }
    uint32_t ah[PS][4], al[PS][4];
    split_a<NT>(st, ah, al);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < PS; ++ks) {
      const uint64_t db = mnmajor_desc<D>(sdo_addr + col_off, BQ, ks);
      wgmma_rs<DH>(&acc_v[0][0], ah[ks], db);
      wgmma_rs<DH>(&acc_v[0][0], al[ks], db);
    }
    wgmma_commit();

    // dS^T = P^T (dP^T - delta) / sqrt(D), from the f32 P
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float d0 = sdl[c], d1 = sdl[c + 1];
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = st[j][e] * (dpt[j][e] - ((e & 1) ? d1 : d0)) * scale;
    }
    uint32_t dh[PS][4], dl[PS][4];
    split_a<NT>(dpt, dh, dl);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < PS; ++ks) {
      const uint64_t db = mnmajor_desc<D>(sq_addr + col_off, BQ, ks);
      wgmma_rs<DH>(&acc_k[0][0], dh[ks], db);
      wgmma_rs<DH>(&acc_k[0][0], dl[ks], db);
    }
    wgmma_commit();
    wgmma_wait();
  }
  cp_async_wait();
  __syncthreads();                // every copy into the K and V tiles landed

  // the K and V tiles are consumed: stage dK and dV there
  store_rows<D, DT>(sk, acc_k, half * DH, dk + kv_off, kv_row, nk);
  store_rows<D, DT>(sv, acc_v, half * DH, dv + kv_off, kv_row, nk);
}

// pass 2: dQ of one (b, head, 64 query rows)
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Sq, int Skv, int H, int KH, int causal,
                        int window, int q_offset, float scale_log2, float scale) {
  using C = Bwd<D>;
  constexpr int BK = C::BK;
  constexpr int NT = BK / 8;       // n8 tiles of keys in S
  constexpr int KS = D / 16;       // k16 steps of S and dP
  constexpr int PS = BK / 16;      // k16 steps of dQ
  constexpr int DT = D / 8;        // n8 tiles of dQ
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align1024(smem_raw);
  unsigned char* sdo = sq + C::Q_BYTES;
  unsigned char* skv = sdo + C::Q_BYTES;     // stage s: K at 2s, V at 2s + 1 (K_BYTES each)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kh = h / (H / KH);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * WG;     // heaviest query tile first
  const int nrows = min(WG, Sq - i0);
  const size_t q_row = (size_t)H * D, kv_row = (size_t)KH * D;
  const size_t q_off = ((size_t)b * Sq + i0) * q_row + (size_t)h * D;
  const bf16* kbase = k + (size_t)b * Skv * kv_row + (size_t)kh * D;
  const bf16* vbase = v + (size_t)b * Skv * kv_row + (size_t)kh * D;
  load_tile_async<D>(sq, q + q_off, q_row, WG, nrows);
  load_tile_async<D>(sdo, dout + q_off, q_row, WG, nrows);

  int k_beg, k_end;
  kv_range(q_offset + i0, q_offset + i0 + nrows - 1, Skv, causal, window, BK, k_beg, k_end);
  const int ntiles = k_end > k_beg ? (k_end - k_beg + BK - 1) / BK : 0;
  auto load_kv = [&](int t, int stage) {
    const int kt = k_beg + t * BK;
    unsigned char* st = skv + (size_t)(2 * stage) * C::K_BYTES;
    load_tile_async<D>(st, kbase + (size_t)kt * kv_row, kv_row, BK, Skv - kt);
    load_tile_async<D>(st + C::K_BYTES, vbase + (size_t)kt * kv_row, kv_row, BK, Skv - kt);
  };
  if (ntiles > 0) load_kv(0, 0);
  cp_async_commit();

  // this thread's rows r0 and r0 + 8 (positions qp0, qp1): lse and delta
  const int r0 = 16 * warp + (lane >> 2);
  const int qp0 = q_offset + i0 + r0, qp1 = qp0 + 8;
  const size_t row = ((size_t)b * H + h) * Sq + i0;
  const float l0 = r0 < nrows ? __fmul_rn(lse[row + r0], LOG2E) : 0.f;
  const float l1 = r0 + 8 < nrows ? __fmul_rn(lse[row + r0 + 8], LOG2E) : 0.f;
  const float d0 = r0 < nrows ? delta[row + r0] : 0.f;
  const float d1 = r0 + 8 < nrows ? delta[row + r0 + 8] : 0.f;
  const float neg_l2 = __fmul_rn(NEG_INF, LOG2E);
  const int qw_lo = q_offset + i0 + 16 * warp, qw_hi = qw_lo + 15;
  const uint32_t sq_addr = smem_u32(sq), sdo_addr = smem_u32(sdo);

  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait();
    __syncthreads();              // tile t landed; stage (t + 1) & 1 is consumed
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    const int kt = k_beg + t * BK;
    const uint32_t sk_addr = smem_u32(skv + (size_t)(2 * (t & 1)) * C::K_BYTES);
    const uint32_t sv_addr = sk_addr + (uint32_t)C::K_BYTES;

    float s[NT][4], dp[NT][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss<BK>(&s[0][0], kmajor_desc<D>(sq_addr, WG, 0, kk),
                   kmajor_desc<D>(sk_addr, BK, 0, kk), kk == 0);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss<BK>(&dp[0][0], kmajor_desc<D>(sdo_addr, WG, 0, kk),
                   kmajor_desc<D>(sv_addr, BK, 0, kk), kk == 0);
    }
    wgmma_commit();
    wgmma_wait();

    // P = exp(s - lse), then dS = P (dP - delta) / sqrt(D) in place of dP;
    // the mask and keys past Skv only on tiles crossing them (per warp)
    const bool inside = kt + BK <= Skv && (!causal || kt + BK - 1 <= qw_lo) &&
                        (window <= 0 || qw_hi - kt < window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l = e < 2 ? l0 : l1;
        float p = exp2f(fmaf(s[j][e], scale_log2, -l));
        if (!inside) {
          const int kp = kt + 8 * j + 2 * (lane & 3) + (e & 1);
          const int qp = e < 2 ? qp0 : qp1;
          if (kp >= Skv) {
            p = 0.f;
          } else if ((causal && kp > qp) || (window > 0 && qp - kp >= window)) {
            p = exp2f(neg_l2 - l);          // 1 on a row that sees no key, else 0
          }
        }
        dp[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1)) * scale;
      }
    }
    uint32_t ah[PS][4], al[PS][4];
    split_a<NT>(dp, ah, al);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < PS; ++ks) {
      const uint64_t db = mnmajor_desc<D>(sk_addr, BK, ks);
      wgmma_rs<D>(&acc[0][0], ah[ks], db);
      wgmma_rs<D>(&acc[0][0], al[ks], db);
    }
    wgmma_commit();
    wgmma_wait();
  }
  cp_async_wait();
  __syncthreads();                // every copy into the Q tile landed

  // the Q tile is consumed: stage dQ there
  store_rows<D, DT>(sq, acc, 0, dq + q_off, q_row, nrows);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                const float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
                int H, int KH, int causal, int window, int q_offset, cudaStream_t stream) {
  using C = Bwd<D>;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaError_t err;
  if (Skv > 0) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::DKDV_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_mma_kernel<D><<<dim3(B * KH * C::HALVES, (Skv + WG - 1) / WG), WG_THREADS,
                                   C::DKDV_SMEM, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
        delta, (bf16*)dk, (bf16*)dv, Sq, Skv, H, KH, causal, window, q_offset, scale * LOG2E,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_mma_kernel<D><<<dim3(B * H, (Sq + WG - 1) / WG), WG_THREADS, C::DQ_SMEM,
                               stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      delta, (bf16*)dq, Sq, Skv, H, KH, causal, window, q_offset, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv, int H,
               int KH, int causal, int window, int q_offset, cudaStream_t stream) {
  using C = Cfg<D>;
  const float scale = (float)(1.0 / sqrt((double)D));
  cudaError_t err;
  if (Skv > 0) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::DKDV_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_kernel<D, float><<<dim3(B * KH, (Skv + C::BK - 1) / C::BK), THREADS,
                                      C::DKDV_SMEM, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
        (const float*)lse, delta, (float*)dk, (float*)dv, Sq, Skv, H, KH, causal, window,
        q_offset, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, float><<<dim3(B * H, (Sq + C::BQ - 1) / C::BQ), THREADS, C::DQ_SMEM,
                                  stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      delta, (float*)dq, Sq, Skv, H, KH, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const void* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
             int H, int KH, int causal, int window, int q_offset, int is_bf16, cudaStream_t s) {
  const int rows = B * Sq * H;
  auto grid = [rows](int tpr) { return (unsigned)(((size_t)rows * tpr + THREADS - 1) / THREADS); };
  if (is_bf16) {
    flash_bwd_delta_kernel<D, bf16><<<grid(D / 8 < 32 ? D / 8 : 32), THREADS, 0, s>>>(
        (const bf16*)out, (const bf16*)dout, delta, rows, Sq, H);
  } else {
    flash_bwd_delta_kernel<D, float><<<grid(D / 4 < 32 ? D / 4 : 32), THREADS, 0, s>>>(
        (const float*)out, (const float*)dout, delta, rows, Sq, H);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return is_bf16 ? launch_bf16<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KH,
                                  causal, window, q_offset, s)
                 : launch_f32<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KH,
                                 causal, window, q_offset, s);
}

}  // namespace

// q, out, dout, dq [B, Sq, H, D]; k, v, dk, dv [B, Skv, KH, D]; lse and the
// scratch delta [B, H, Sq] f32. All contiguous, in one type (bf16 or f32).
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* out, const void* dout, const void* lse,
                                          void* delta, void* dq, void* dk, void* dv, int B,
                                          int Sq, int Skv, int H, int KH, int D, int causal,
                                          int window, int q_offset, int bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH || Skv < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  float* dl = (float*)delta;
  switch (D) {
    case 16: return launch_d<16>(q, k, v, out, dout, lse, dl, dq, dk, dv, B, Sq, Skv, H, KH, causal, window, q_offset, bf16, s);
    case 32: return launch_d<32>(q, k, v, out, dout, lse, dl, dq, dk, dv, B, Sq, Skv, H, KH, causal, window, q_offset, bf16, s);
    case 64: return launch_d<64>(q, k, v, out, dout, lse, dl, dq, dk, dv, B, Sq, Skv, H, KH, causal, window, q_offset, bf16, s);
    case 128: return launch_d<128>(q, k, v, out, dout, lse, dl, dq, dk, dv, B, Sq, Skv, H, KH, causal, window, q_offset, bf16, s);
    case 256: return launch_d<256>(q, k, v, out, dout, lse, dl, dq, dk, dv, B, Sq, Skv, H, KH, causal, window, q_offset, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
