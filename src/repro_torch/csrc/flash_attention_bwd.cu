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
// Design, simple and right first: every product in f32 on the CUDA cores
// (67 TFLOP/s at best), so the bf16 kernel rounds nothing but its outputs,
// as the reference's f32 products do (the tensor-core redesign, P and dS in
// bf16 for wgmma, is later work). Two passes, as in FlashAttention-2, and
// no atomics, so the gradients are the same bits from run to run:
//   1. flash_bwd_dkdv_kernel: one block per (b, kv head, 64-key tile; 32 at
//      D = 256) holds the K and V tile in shared memory and loops over the
//      G query heads of its kv head and the query tiles that can see the
//      tile, recomputing S, P, dP and dS per (query tile, key tile) and
//      accumulating dK and dV in registers: 14 * D flops a visible pair
//      across both passes instead of 10, the price of owning each output.
//   2. flash_bwd_dq_kernel: one block per (b, head, query tile), heaviest
//      first, loops over the key tiles its rows can see and accumulates dQ.
// A block is a 16 x 16 grid of threads; each owns a strided micro-tile
// (rows ty + 16 i, columns tx + 16 j) of S and of its accumulators, so a
// warp's shared-memory reads are broadcasts or hit distinct banks (rows
// padded to D + 1 and BK + 1 floats). delta comes from a small first kernel,
// one warp a row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;
constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;        // a 16 x 16 grid of threads

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
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// a row at position qp sees no key at all (as in flash_attention.cu)
__device__ __forceinline__ bool sees_no_key(int qp, int Skv, int causal, int window) {
  const int lo = window > 0 ? max(0, qp - window + 1) : 0;
  const int hi = causal ? min(Skv, qp + 1) : Skv;
  return hi <= lo;
}

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

// delta[b, h, i] = sum_d dO[b, i, h, :] * O[b, i, h, :] in f32, one warp a row
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H, int D) {
  const int row = (int)(((size_t)blockIdx.x * THREADS + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;                          // uniform over the warp
  const T* o = out + (size_t)row * D;               // row = (b * Sq + i) * H + h
  const T* g = dout + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s = fmaf(to_f(g[c]), to_f(o[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xFFFFFFFFu, s, off);
  if (lane == 0) {
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

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const void* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
           int H, int KH, int causal, int window, int q_offset, cudaStream_t stream) {
  using C = Cfg<D>;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<T><<<(unsigned)(((size_t)rows * 32 + THREADS - 1) / THREADS), THREADS,
                              0, stream>>>((const T*)out, (const T*)dout, delta, rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Skv > 0) {
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::DKDV_SMEM);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkdv_kernel<D, T><<<dim3(B * KH, (Skv + C::BK - 1) / C::BK), THREADS, C::DKDV_SMEM,
                                  stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse, delta, (T*)dk,
        (T*)dv, Sq, Skv, H, KH, causal, window, q_offset, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D, T><<<dim3(B * H, (Sq + C::BQ - 1) / C::BQ), THREADS, C::DQ_SMEM,
                              stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse, delta, (T*)dq,
      Sq, Skv, H, KH, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const void* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Skv,
             int H, int KH, int causal, int window, int q_offset, int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch<D, bf16>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KH,
                                   causal, window, q_offset, s)
                 : launch<D, float>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H,
                                    KH, causal, window, q_offset, s);
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
