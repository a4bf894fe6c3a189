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

// ---- warp-specialised pipelines (gma.cu's K7) -------------------------------

// D (64 x 128, fp32, 64 registers a thread) = A (64 x 8) * B (128 x 8)^T in
// TF32 (+ D if ``accumulate``): wgmma_tf32 at N = 128, D's fragment laid out
// the same way (columns 8 * (i >> 2) + 2t + (i & 1), i < 64).
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const unsigned (&a)[4],
                                                unsigned long long b,
                                                bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"((int)accumulate));
}

// wgmma_tf32x3 at N = 128: one k8 step's three products, small terms first,
// committed as one group
__device__ __forceinline__ void wgmma_tf32x3_n128(float (&d)[64],
                                                  const unsigned (&a_big)[4],
                                                  const unsigned (&a_small)[4],
                                                  unsigned long long b_big,
                                                  unsigned long long b_small,
                                                  bool accumulate) {
  wgmma_fence();
  wgmma_tf32_n128(d, a_small, b_big, accumulate);
  wgmma_tf32_n128(d, a_big, b_small, true);
  wgmma_tf32_n128(d, a_big, b_big, true);
  wgmma_commit();
}

// Registers a thread of this warpgroup may hold from here on: a producer
// gives some back (dec), a consumer takes them (inc); all four warps of the
// warpgroup execute it.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// mbarriers in shared memory: ``count`` arrivals (and, for a bulk copy's
// barrier, its bytes) complete a phase; a waiter names the phase's parity.
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// makes the initialised barriers visible to the async proxy (bulk copies)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival that also expects ``bytes`` of bulk copies into the phase
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// L2 policies for bulk copies: data read once (evict first) and data every
// block reads again (evict last)
__device__ __forceinline__ unsigned long long l2_evict_first() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}
__device__ __forceinline__ unsigned long long l2_evict_last() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// A box of a 3-d tensor map (``map``, a __grid_constant__ CUtensorMap) at
// coordinates (c0 innermost, c1, c2) into shared memory at ``dst``, its bytes
// counted on ``bar``; elements outside the tensor read as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            unsigned long long* bar, int c0,
                                            int c1, int c2,
                                            unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(smem_u32(bar)),
      "r"(c0), "r"(c1), "r"(c2), "l"(policy)
      : "memory");
}

// Byte offset of 16-byte column k4 of ``row`` in a tile of 128-byte rows
// written by a bulk tensor copy with 128-byte swizzle (its base 1024-byte
// aligned): the column's index XORed with the row's within 8.
__device__ __forceinline__ int swizzle128_offset(int row, int k4) {
  return row * 128 + ((k4 ^ (row & 7)) << 4);
}

// wgmma's descriptor of a K-major tile without swizzle whose core matrices
// lie ``lbo`` bytes apart along K and whose groups of 8 rows ``sbo`` bytes
// apart (core_desc's with any spacing)
__device__ __forceinline__ unsigned long long kmajor_desc(const float* p,
                                                          unsigned lbo,
                                                          unsigned sbo) {
  return (unsigned long long)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((unsigned long long)(lbo >> 4) << 16) |
         ((unsigned long long)(sbo >> 4) << 32);
}

// The K-major transpose-split of a 4 x 4 block held in registers: x[r] is
// row r (a key) of four consecutive columns (channels); column q goes, as
// TF32 big and small parts, to the 16 bytes at float offset off[q] of the
// big and small planes.
__device__ __forceinline__ void split_tf32_4x4(const float4 (&x)[4],
                                               float* big, float* small,
                                               const int (&off)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint4 hi, lo;
    split_tf32(make_uint4(__float_as_uint((&x[0].x)[q]),
                          __float_as_uint((&x[1].x)[q]),
                          __float_as_uint((&x[2].x)[q]),
                          __float_as_uint((&x[3].x)[q])),
               hi, lo);
    *reinterpret_cast<uint4*>(big + off[q]) = hi;
    *reinterpret_cast<uint4*>(small + off[q]) = lo;
  }
}

}  // namespace
