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
// past Skv are masked inside the tile and their rows of K and V are zero.
//
// What bounds it on the H100: operations. At the prefill shape (B = 8,
// S = 1024, H = 32, KH = 4, D = 64, causal, bf16) it moves 75.5 MB (0.0225 ms
// at 3.35 TB/s) and does 34.4 GFLOP (0.0347 ms at the bf16 tensor-core peak).
// This first version runs both products as f32 FMAs outside the tensor cores
// (67 TFLOP/s at best), so it cannot come near that bound; mma/wgmma tiles fed
// by TMA are the next step.
//
// Design. One block of 256 threads owns (b * H + h, a tile of 64 query rows);
// four neighbouring threads own one row and split D between them by float4
// chunks (lane l owns chunks l, l + 4, ...), so a warp's read of a K or V row
// in shared memory is four distinct float4s broadcast to eight rows: no bank
// conflicts. Each kv tile (64 keys; 32 at D = 256) is staged into shared
// memory as f32 by the whole block. A thread keeps its q chunks, its
// accumulator chunks and the tile's scores in registers; the four lanes of a
// row add their partial dots with two shuffles and then hold the same scores,
// so the tile's max, the exps and the row sum need no further exchange. Tiles
// that lie wholly above the diagonal or wholly outside the window for every
// row of the block are skipped: for a row with at least one visible key this
// changes only the order of the sums (a masked tile's p = 1 terms are wiped
// exactly by alpha = exp(-1e30 - m) = 0). A row with no visible key at all,
// which the model never forms, gets the mean of V over the tiles its block
// visits where the reference takes it over every key. Query tiles run
// heaviest first (the last causal tiles have the most keys).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <cstddef>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;          // query rows per block
constexpr int LANES = 4;        // threads per query row
constexpr float NEG_INF = -1e30f;

template <int D> struct Tile {
  static constexpr int BK = D >= 256 ? 32 : 64;     // keys per kv tile
  static constexpr int NC = D / 16;                 // float4 chunks a lane owns
  static constexpr size_t SMEM = 2 * (size_t)BK * D * sizeof(float);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float bf16_bits(unsigned int lo16) {
  return __uint_as_float(lo16 << 16);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(bf16_bits(raw.x & 0xFFFFu), bf16_bits(raw.x >> 16),
                     bf16_bits(raw.y & 0xFFFFu), bf16_bits(raw.y >> 16));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned int*>(&a);
  raw.y = *reinterpret_cast<unsigned int*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// P as the P.V product sees it: rounded to the input type.
__device__ __forceinline__ float as_input(float p, const float*) { return p; }
__device__ __forceinline__ float as_input(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv, int H,
                 int KH, int causal, int window, int q_offset, float scale) {
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
  const T* qrow = q + ((size_t)b * Sq + (live ? i : 0)) * H * D + (size_t)h * D;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    qr[j] = live ? load4(qrow + 4 * (j * LANES + lane)) : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF, l = 0.f;

  // kv tiles any row of this block can see
  const int q_lo = q_offset + i0;
  const int q_hi = q_offset + min(i0 + BQ, Sq) - 1;
  const int k_end = causal ? max(0, min(Skv, q_hi + 1)) : Skv;
  const int k_beg = window > 0 ? max(0, q_lo - window + 1) / BK * BK : 0;

  const size_t kv_row = (size_t)KH * D;             // stride between positions
  const T* kbase = k + (size_t)b * Skv * kv_row + (size_t)kh * D;
  const T* vbase = v + (size_t)b * Skv * kv_row + (size_t)kh * D;

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
      const bool ok = kp < Skv && (!causal || kp <= q_pos) &&
                      (window <= 0 || q_pos - kp < window);
      s[kk] = ok ? part * scale : NEG_INF;
      m_new = fmaxf(m_new, s[kk]);
    }
    const float alpha = expf(m - m_new);
    float tile_sum = 0.f;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float p = expf(s[kk] - m_new);
      tile_sum += p;
      s[kk] = as_input(p, q);
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
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + ((size_t)b * Sq + i) * H * D + (size_t)h * D;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    store4(orow + 4 * (j * LANES + lane),
           make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv, acc[j].w * inv));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
           int H, int KH, int causal, int window, int q_offset, cudaStream_t stream) {
  const size_t smem = Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, H, KH, causal, window,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int Sq,
             int Skv, int H, int KH, int D, int causal, int window, int q_offset,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Skv, H, KH, causal, window, q_offset, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KH, causal, window, q_offset, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KH, causal, window, q_offset, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KH, causal, window, q_offset, s);
    case 256: return launch<T, 256>(q, k, v, out, B, Sq, Skv, H, KH, causal, window, q_offset, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                                          void* out, int B, int Sq, int Skv, int H, int KH,
                                          int D, int causal, int window, int q_offset,
                                          int bf16, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || KH <= 0 || H % KH || Skv < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_d<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KH, D, causal, window,
                                        q_offset, s)
              : launch_d<float>(q, k, v, out, B, Sq, Skv, H, KH, D, causal, window,
                                q_offset, s);
}
