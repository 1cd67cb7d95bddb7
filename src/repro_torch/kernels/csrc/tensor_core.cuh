// Tensor-core building blocks shared by the bf16 kernels
// (flash_attention.cu, int8_matmul.cu, decode_sm90.cuh): 16- and 4-byte
// asynchronous copies from device memory into shared memory
// (``cp.async``, zero-filling rows past an edge), ``ldmatrix`` fragment
// loads, the ``mma.sync.m16n8k16`` bf16 product with float32
// accumulation, the XOR swizzle that keeps both conflict-free, and the
// exact int8 -> bf16 conversion of weight codes.
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
