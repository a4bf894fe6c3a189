// The float32-accurate tensor-core product shared by corr_alt.cu (K5) and
// gma.cu (K6, K7): operands split into TF32 big and small parts, three
// wgmma.m64n64k8 TF32 products summed with the small terms first, copies by
// cp.async into wgmma's K-major core-matrix layout.
//
// Layout of a staged slab of R rows x K fp32 (K a multiple of 4): wgmma's
// K-major core matrices without swizzle. A core matrix is 8 rows x 4 fp32
// (16 bytes) stored as 128 contiguous bytes; the K/4 core matrices of 8 rows
// follow each other along K (the leading byte offset, 128), the groups of 8
// rows at K/4 * 128 bytes (the stride byte offset). Copying 16-byte piece i
// of a slab, row (i / (2K)) * 8 + (i & 7) and column (i >> 3) % (K/4), to
// float offset 4i fills it in that layout, eight lanes to one core matrix.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32, to nearest on the bits (the tensor core would drop the
// low 13 bits, rounding toward zero)
__device__ __forceinline__ unsigned tf32_round(unsigned x) {
  return (x + 0x1000u) & 0xffffe000u;
}
// x as a TF32 big part and the rest, the rest rounded to TF32 too
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& big,
                                           unsigned& rest) {
  big = tf32_round(x);
  rest = tf32_round(
      __float_as_uint(__uint_as_float(x) - __uint_as_float(big)));
}
__device__ __forceinline__ void split_tf32(uint4 x, uint4& big, uint4& rest) {
  split_tf32(x.x, big.x, rest.x);
  split_tf32(x.y, big.y, rest.y);
  split_tf32(x.z, big.z, rest.z);
  split_tf32(x.w, big.w, rest.w);
}

// four 8x4 fp32 matrices (8 rows of 16 bytes each, one row address per lane)
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// float offset of (row, 16-byte column k4) in a slab of rows of K fp32
template <int K>
__device__ __forceinline__ int core_offset(int row, int k4) {
  return ((row >> 3) * (K / 4) + k4) * 32 + (row & 7) * 4;
}

// wgmma's shared-memory matrix descriptor of a slab of rows of K fp32:
// start address, leading and stride byte offsets (each >> 4), no swizzle
template <int K>
__device__ __forceinline__ unsigned long long core_desc(const float* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return (unsigned long long)((a & 0x3FFFF) >> 4) |
         ((unsigned long long)(128 >> 4) << 16) |
         ((unsigned long long)((K / 4) * 128 >> 4) << 32);
}

// D (64 x 64, fp32, 32 registers a thread) = A (64 x 8) * B (64 x 8)^T in
// TF32 (+ D if ``accumulate``), issued by the four warps of a warpgroup: A
// from registers (each warp its 16 rows, laid out as mma.m16n8k8's A), B
// from shared memory. Thread (warp w, lane 4g + t) holds D's row
// 16w + g + 8 * ((i >> 1) & 1) and column 8 * (i >> 2) + 2t + (i & 1) in
// d[i].
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const unsigned (&a)[4],
                                           unsigned long long b,
                                           bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"((int)accumulate));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// orders this thread's shared-memory stores before wgmma's reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The error-compensated product of one k8 step: D += A * B^T to float32
// accuracy, A given as its TF32 big and small parts in registers, B as its
// big and small planes in shared memory (descriptors), the small terms
// first. The tensor cores round their sums toward zero, so a caller chains
// only a few steps in one accumulator and adds the chains up in fp32.
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[32],
                                             const unsigned (&a_big)[4],
                                             const unsigned (&a_small)[4],
                                             unsigned long long b_big,
                                             unsigned long long b_small,
                                             bool accumulate) {
  wgmma_fence();
  wgmma_tf32(d, a_small, b_big, accumulate);
  wgmma_tf32(d, a_big, b_small, true);
  wgmma_tf32(d, a_big, b_big, true);
  wgmma_commit();
}

// Lets a block have ``smem`` bytes (the largest shared-memory carveout).
template <typename F>
static cudaError_t set_smem(F* kernel, long long smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

}  // namespace
