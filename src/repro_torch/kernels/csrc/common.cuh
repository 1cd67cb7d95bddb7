// Shared helpers for the port's hand-written Hopper kernels: element-type
// conversion (float32 and bfloat16 inputs, float32 arithmetic) and
// block-wide reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define REPRO_NEG (-1e30f)

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// Round a float32 to T and back: the reference's ``probs.astype(q.dtype)``.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// Code e of a 16-byte vector of int8 codes, as a float (exact); e is a
// constant once the caller's loop is unrolled.
__device__ __forceinline__ float int8_code(const uint4& v, int e) {
  const uint32_t word = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
  return (float)(int8_t)(uint8_t)(word >> (8 * (e & 3)));
}

// A tile of ROWS rows of D elements of T, copied from device memory to
// float32 shared memory by a block of THREADS threads in 16-byte loads.
// ``load`` issues every load of the tile into registers before any is
// used, so the tile costs about one memory latency instead of one per
// element; the caller stores the registers with ``store`` after the
// previous tile's compute, which lets the loads of the next tile fly
// during that compute. Rows must start 16-byte aligned (the wrappers
// check the base pointer and the strides).
template <typename T, int ROWS, int D, int THREADS>
struct TileLoader {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = D / VEC;
  static constexpr int TOTAL = ROWS * PER_ROW;
  static constexpr int N = (TOTAL + THREADS - 1) / THREADS;
  uint4 buf[N];

  // row_ptr(j) -> address of row j, or nullptr for a row past the edge
  // (loaded as zeros).
  template <typename RowPtr>
  __device__ __forceinline__ void load(RowPtr row_ptr) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < TOTAL) {
        const T* p = row_ptr(idx / PER_ROW);
        if (p != nullptr)
          buf[i] = __ldg(reinterpret_cast<const uint4*>(
              p + (idx % PER_ROW) * VEC));
      }
    }
  }

  // row j lands at dst[j * pitch, j * pitch + D)
  __device__ __forceinline__ void store(float* dst, int pitch) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < TOTAL) {
        const int j = idx / PER_ROW, d0 = (idx % PER_ROW) * VEC;
        const T* v = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[j * pitch + d0 + e] = to_f32<T>(v[e]);
      }
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions; every thread of the block must call them, and
// every thread gets the result. ``red`` holds at least 33 entries.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    float x = lane < nw ? red[lane] : 0.0f;
    x = warp_sum(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    float x = lane < nw ? red[lane] : -INFINITY;
    x = warp_max(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_sum_int(int v, int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum_int(v);
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    int x = lane < nw ? red[lane] : 0;
    x = warp_sum_int(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const int r = red[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_min_int(int v, int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    int x = lane < nw ? red[lane] : 0x7fffffff;
    for (int o = 16; o > 0; o >>= 1)
      x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const int r = red[32];
  __syncthreads();
  return r;
}

// (value, index) argmax, lowest index on ties.
__device__ __forceinline__ void argmax_pair(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ int block_argmax(float v, int i, float* redv,
                                            int* redi) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    argmax_pair(v, i, v2, i2);
  }
  if (lane == 0) {
    redv[w] = v;
    redi[w] = i;
  }
  __syncthreads();
  if (w == 0) {
    float x = lane < nw ? redv[lane] : -INFINITY;
    int j = lane < nw ? redi[lane] : 0x7fffffff;
    for (int o = 16; o > 0; o >>= 1) {
      const float x2 = __shfl_xor_sync(0xffffffffu, x, o);
      const int j2 = __shfl_xor_sync(0xffffffffu, j, o);
      argmax_pair(x, j, x2, j2);
    }
    if (lane == 0) redi[32] = j;
  }
  __syncthreads();
  const int r = redi[32];
  __syncthreads();
  return r;
}
