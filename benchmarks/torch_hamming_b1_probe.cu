// Rates of the 1-bit tensor-core products on Hopper (sm_90a), the products
// the port's packed Hamming kernels run (src/repro_torch/csrc/hamming.cu):
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc (the search and
// the top-k) and wgmma.mma_async m64n128k256 .s32.b1.b1.and.popc (the top-1).
// NVIDIA publishes no 1-bit peak for the H100; chip_smoke.py bounds the
// Hamming kernels by the higher of the two rates. Built and driven by
// benchmarks/torch_hamming_b1_probe.py; not part of the port's kernel library.
//
// b1_peak_kernel: every warp runs 8 independent b1 products on registers in a
// loop, the instruction's rate without memory traffic.
// b1_wgmma_kernel: one warpgroup a block runs four m64n128k256 products (a
// 1024-bit k tile) a loop on fixed tiles in shared memory, in the 128-byte
// swizzle the top-1 reads.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ void mma_b1(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void b1_peak_kernel(int* out, int iters, uint32_t seed) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + 1) + i;
  b[0] = seed ^ threadIdx.x;
  b[1] = ~seed + threadIdx.x;
  int d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_b1(d[j], a, b);
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_b1(int (&d)[64], uint64_t da, uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

__global__ void __launch_bounds__(128) b1_wgmma_kernel(int* out, int iters, uint32_t seed) {
  __shared__ __align__(1024) uint32_t sa[64 * 32];    // 64 rows x 1024 bits
  __shared__ __align__(1024) uint32_t sb[128 * 32];   // 128 rows x 1024 bits
  for (int e = threadIdx.x; e < 64 * 32; e += 128) sa[e] = seed * (e + 1);
  for (int e = threadIdx.x; e < 128 * 32; e += 128) sb[e] = ~seed ^ (e * 2654435761u);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  int d[64] = {};
  const uint64_t da = sw128_desc(smem_u32(sa)), db = sw128_desc(smem_u32(sb));
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_b1(d, da + 2 * ks, db + 2 * ks);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 64; ++j) s += d[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int b1_wgmma_launch(void* out, int blocks, int iters, void* stream) {
  b1_wgmma_kernel<<<blocks, 128, 0, (cudaStream_t)stream>>>((int*)out, iters, 12345u);
  return (int)cudaGetLastError();
}

extern "C" int b1_peak_launch(void* out, int blocks, int threads, int iters, void* stream) {
  b1_peak_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((int*)out, iters, 12345u);
  return (int)cudaGetLastError();
}
