// Tensor-core building blocks shared by the bf16 kernels
// (flash_attention.cu, int8_matmul.cu, decode_sm90.cuh): 16- and 4-byte
// asynchronous copies from device memory into shared memory
// (``cp.async``, zero-filling rows past an edge), ``ldmatrix`` fragment
// loads, the ``mma.sync.m16n8k16`` bf16 product with float32
// accumulation, the XOR swizzle that keeps both conflict-free, the
// exact int8 -> bf16 conversion of weight codes, and Hopper's warpgroup
// product (``wgmma``, A from registers, B through a shared-memory
// descriptor; int8_matmul.cu's prefill tile and moe_grouped.cu) with its
// fences.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"): lane
// = 4 * g + t. A (16 x 16, row-major): a0 (row g, cols 2t, 2t+1), a1 (row
// g + 8), a2 (cols + 8), a3 (both). B (16 x 8, "col"): b0 (rows 2t, 2t+1,
// col g), b1 (rows + 8). C (16 x 8): c0, c1 (row g, cols 2t, 2t+1); c2,
// c3 (row g + 8). In each 32-bit register the lower index sits in the low
// half.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from ``src`` to shared ``dst``; ``valid`` false writes zeros
// and reads nothing (``src`` must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes, likewise (through L1: ``.cg`` takes only 16-byte copies).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 bf16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two 8 x 8 bf16 matrices; lanes 0-15 give the row addresses (lanes 16-31
// must still hold shared addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// The same, each matrix transposed on the way (B from a row-major [k][n]
// tile).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b on the tensor cores: bf16 x bf16 -> float32. Not volatile:
// a pure function of its registers, which the compiler may schedule.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared-memory index, in 16-byte chunks, of chunk c of row r of a tile
// with CPR chunks per row. The chunk is XORed with bits of the row so that
// the 8 rows one ldmatrix matrix (or one cp.async quarter warp) touches
// fall in 8 distinct 16-byte bank groups.
template <int CPR>
__device__ __forceinline__ int swizzle(int r, int c) {
  static_assert(CPR == 4 || CPR % 8 == 0, "rows of 64 B or 128 B * n");
  if constexpr (CPR == 4)
    return r * CPR + (c ^ ((r >> 1) & 3));
  else
    return r * CPR + (c ^ (r & 7));
}

// Two bf16 from two floats, x in the low half (the lower index).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 p = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&p);
}

// The bf16 pair (code j of ``lo``, code j of ``hi``), ``lo``'s in the low
// half, of words of int8 codes each already biased by 0x80 (XOR), so code
// q is the byte u = q + 128. Exact: u becomes the low byte of the float
// 2^23 + u, one subtraction leaves the integer q, and a float32 integer
// of magnitude <= 128 keeps all its bits in its top 16 (bf16) bits.
__device__ __forceinline__ uint32_t codes_to_bf16x2(uint32_t lo,
                                                    uint32_t hi, int j) {
  const uint32_t sel = 0x7440u | (uint32_t)j;  // byte j under 0x4B0000
  const float fa =
      __uint_as_float(__byte_perm(lo, 0x4B000000u, sel)) - 8388736.0f;
  const float fb =
      __uint_as_float(__byte_perm(hi, 0x4B000000u, sel)) - 8388736.0f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}

// -- warpgroup products (sm_90a) --------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving a register across an asynchronous
// product that reads or writes it.
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
// cp.async writes (generic proxy) made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A K-major tile of rows of 64 bf16 (128 B) in the 128-byte swizzle
// (``swizzle<8>``): 8-row groups 1024 B apart; ``addr`` is the
// 1024-aligned tile plus the k-step's 32-byte offset.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128) += a (64 x 16, bf16 in registers) b (16 x 128, bf16 in
// shared memory through ``desc``), float32 accumulators.
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a,
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64) += a (64 x 16, bf16 in registers) b (16 x 64, bf16 in shared
// memory through ``desc``), float32 accumulators.
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a,
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
