// Weight-only int8 matmul for Hopper (sm_90a), the port of the Pallas TPU
// kernel ``repro/kernels/int8_matmul.py::int8_matmul`` (TPU kernel 5):
//   y (M, N) = (float(x) @ float(w_q)) * scale, cast once to x's type,
// x (M, K) float32 or bfloat16 row-major, w_q (K, N) int8 row-major (the
// JAX orientation), scale (N,) float32, applied per output column after
// the dot (``layers.linear``'s dict path).
//
// What bounds it: at decode (M = 8 slots) the int8 weight read, K*N bytes
// against 2*M*K*N FLOPs, so device-memory bandwidth; at prefill (M = a
// bucket of 16..1024) the FLOPs. The weight is read as int8, once per
// M tile, and converted in registers: no dequantized copy of a weight is
// ever written to device memory, since halving that read is the point.
// Few output tiles (decode: N/128 column blocks) cannot keep 132 SMs'
// loads in flight, so the wrapper splits K over ``splits`` blocks per
// tile; each writes a float32 partial and a second launch sums the
// partials in split order (deterministic), scales and casts.
//
// bfloat16 x runs on tensor cores: ``mma.sync.m16n8k16`` bf16 x bf16 ->
// f32. An int8 code (|q| <= 127) is exact in bfloat16, and the product of
// two bfloat16 values is exact in float32, so the tensor cores form the
// twin's products exactly; only the order of the sum differs. The weight
// tile is stored in shared memory as bf16 pairs (k, k+1) of one column,
// one 32-bit word each, which is the mma's B fragment. float32 x is not
// exact in bf16 (nor in TF32): it takes a float32 FMA path.
#include "common.cuh"

namespace {

constexpr int BN = 128;         // output columns per block
constexpr int BK = 32;          // contraction depth per tile
constexpr int THREADS = 128;    // four warps
constexpr int WPITCH = BN + 8;  // words per pair row of the bf16 weight tile
constexpr int XPITCH = BK + 8;  // elements per row of the bf16 x tile
constexpr int FXPITCH = BK + 4;  // floats per row of the f32 x tile
constexpr int FWPITCH = BN + 4;  // floats per row of the f32 weight tile

// The weight tile's global loads: thread tid owns rows k and k + 1
// (k = k0 + 2 * (tid / 8)) of 16 columns (16 * (tid % 8)): two 16-byte
// loads, zeros past the edge. N is a multiple of 16 (the wrapper checks),
// so a 16-column chunk is wholly inside or outside.
struct WTile {
  uint4 lo, hi;
  __device__ __forceinline__ void load(const int8_t* w, int N, int k0,
                                       int k_end, int n0) {
    const int k = k0 + 2 * (threadIdx.x >> 3);
    const int n = n0 + 16 * (threadIdx.x & 7);
    lo = hi = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) {
      if (k < k_end)
        lo = __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * N + n));
      if (k + 1 < k_end)
        hi = __ldg(
            reinterpret_cast<const uint4*>(w + (size_t)(k + 1) * N + n));
    }
  }
};

// The x tile's global loads: BM rows of BK elements of T in 16-byte
// vectors, zeros past the edge (K is a multiple of 16, so a vector is
// wholly inside or outside).
template <typename T, int BM>
struct XTile {
  static constexpr int VEC = 16 / sizeof(T);
  static constexpr int PER_ROW = BK / VEC;
  static constexpr int TOTAL = BM * PER_ROW;
  static constexpr int N = (TOTAL + THREADS - 1) / THREADS;
  uint4 buf[N];
  __device__ __forceinline__ void load(const T* x, int M, int K, int m0,
                                       int k0, int k_end) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int m = m0 + idx / PER_ROW, k = k0 + (idx % PER_ROW) * VEC;
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < TOTAL && m < M && k < k_end)
        buf[i] =
            __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + k));
    }
  }
  __device__ __forceinline__ void store(T* xs, int pitch) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      if (idx < TOTAL)
        *reinterpret_cast<uint4*>(xs + (idx / PER_ROW) * pitch +
                                  (idx % PER_ROW) * VEC) = buf[i];
    }
  }
};

// One output element: straight to y (scaled, cast) without a K split, or
// to the split's float32 partial.
template <typename T>
__device__ __forceinline__ void emit(T* y, float* partial,
                                     const float* scale, int M, int N, int m,
                                     int n, float acc, bool split) {
  if (m >= M || n >= N) return;
  if (split)
    partial[((size_t)blockIdx.z * M + m) * N + n] = acc;
  else
    y[(size_t)m * N + n] = from_f32<T>(acc * __ldg(scale + n));
}

// Codes e of rows k (lo) and k + 1 (hi) as one bf16 pair, k in the low
// half (the mma's B fragment order); exact, since |code| <= 127.
__device__ __forceinline__ uint32_t bf16_pair(const uint4& lo,
                                              const uint4& hi, int e) {
  __nv_bfloat162 p =
      __floats2bfloat162_rn(int8_code(lo, e), int8_code(hi, e));
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bfloat16 x on tensor cores. BM = 16 (decode: 4 warps side by side, 16 x
// 32 each) or 64 (prefill: 2 x 2 warps of 32 x 64).
template <int BM>
__global__ void __launch_bounds__(THREADS)
int8_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ partial,
                    int M, int K, int N, int kchunk) {
  constexpr int WARPS_N = BM == 16 ? 4 : 2;
  constexpr int WM = BM == 16 ? 16 : 32, WN = BN / WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  __shared__ __align__(16) uint32_t ws[(BK / 2) * WPITCH];
  __shared__ __align__(16) __nv_bfloat16 xs[BM * XPITCH];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WARPS_N) * WM, wn0 = (warp % WARPS_N) * WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  WTile wt;
  XTile<__nv_bfloat16, BM> xt;
  wt.load(w, N, k_begin, k_end, n0);
  xt.load(x, M, K, m0, k_begin, k_end);
  const int kp = tid >> 3, cc = tid & 7;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    {
      // 16 (k, k+1) words of 16 columns in 4 stores of 16 bytes; store j
      // writes quad (j + cc / 2) % 4, so a quarter warp's stores hit
      // distinct banks
      uint4 quad[4];
#pragma unroll
      for (int qd = 0; qd < 4; ++qd) {
        quad[qd].x = bf16_pair(wt.lo, wt.hi, 4 * qd + 0);
        quad[qd].y = bf16_pair(wt.lo, wt.hi, 4 * qd + 1);
        quad[qd].z = bf16_pair(wt.lo, wt.hi, 4 * qd + 2);
        quad[qd].w = bf16_pair(wt.lo, wt.hi, 4 * qd + 3);
      }
      uint32_t* dst = ws + kp * WPITCH + 16 * cc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qd = (j + (cc >> 1)) & 3;
        const uint4 v = qd == 0 ? quad[0]
                        : qd == 1 ? quad[1]
                        : qd == 2 ? quad[2]
                                  : quad[3];
        *reinterpret_cast<uint4*>(dst + 4 * qd) = v;
      }
      xt.store(xs, XPITCH);
    }
    __syncthreads();
    if (k0 + BK < k_end) {
      wt.load(w, N, k0 + BK, k_end, n0);
      xt.load(x, M, K, m0, k0 + BK, k_end);
    }
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* xr =
            xs + (wm0 + 16 * i + g) * XPITCH + 16 * ks + 2 * t;
        a[i][0] = *reinterpret_cast<const uint32_t*>(xr);
        a[i][1] = *reinterpret_cast<const uint32_t*>(xr + 8 * XPITCH);
        a[i][2] = *reinterpret_cast<const uint32_t*>(xr + 8);
        a[i][3] = *reinterpret_cast<const uint32_t*>(xr + 8 * XPITCH + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t* wr = ws + (8 * ks + t) * WPITCH + wn0 + 8 * j + g;
        b[j][0] = wr[0];
        b[j][1] = wr[4 * WPITCH];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int m = m0 + wm0 + 16 * i + g, n = n0 + wn0 + 8 * j + 2 * t;
      emit(y, partial, scale, M, N, m, n, acc[i][j][0], split);
      emit(y, partial, scale, M, N, m, n + 1, acc[i][j][1], split);
      emit(y, partial, scale, M, N, m + 8, n, acc[i][j][2], split);
      emit(y, partial, scale, M, N, m + 8, n + 1, acc[i][j][3], split);
    }
}

// float32 x on CUDA cores: 16 x 128 outputs per block, 4 x 4 per thread
// (rows ty + 4i, columns tx + 32j), float32 FMAs from shared memory.
__global__ void __launch_bounds__(THREADS)
int8_mm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ y,
                   float* __restrict__ partial, int M, int K, int N,
                   int kchunk) {
  constexpr int BM = 16;
  __shared__ __align__(16) float ws[BK * FWPITCH];
  __shared__ __align__(16) float xs[BM * FXPITCH];

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  WTile wt;
  XTile<float, BM> xt;
  wt.load(w, N, k_begin, k_end, n0);
  xt.load(x, M, K, m0, k_begin, k_end);
  const int kp = tid >> 3, cc = tid & 7;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();
    {
      float* r0 = ws + (2 * kp) * FWPITCH + 16 * cc;
      float* r1 = r0 + FWPITCH;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float4*>(r0 + 4 * j) = make_float4(
            int8_code(wt.lo, 4 * j), int8_code(wt.lo, 4 * j + 1),
            int8_code(wt.lo, 4 * j + 2), int8_code(wt.lo, 4 * j + 3));
        *reinterpret_cast<float4*>(r1 + 4 * j) = make_float4(
            int8_code(wt.hi, 4 * j), int8_code(wt.hi, 4 * j + 1),
            int8_code(wt.hi, 4 * j + 2), int8_code(wt.hi, 4 * j + 3));
      }
      xt.store(xs, FXPITCH);
    }
    __syncthreads();
    if (k0 + BK < k_end) {
      wt.load(w, N, k0 + BK, k_end, n0);
      xt.load(x, M, K, m0, k0 + BK, k_end);
    }
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[(ty + 4 * i) * FXPITCH + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[k * FWPITCH + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      emit(y, partial, scale, M, N, m0 + ty + 4 * i, n0 + tx + 32 * j,
           acc[i][j], split);
}

// y = T(sum over splits of partial * scale), the splits in order.
template <typename T>
__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ partial,
               const float* __restrict__ scale, T* __restrict__ y, int M,
               int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.0f;
    for (int z = 0; z < splits; ++z) sum += partial[z * total + i];
    y[i] = from_f32<T>(sum * __ldg(scale + i % N));
  }
}

template <typename T>
int finish(const float* partial, const float* scale, T* y, int M, int N,
           int splits, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t total = (size_t)M * N;
  const int blocks = (int)min((total + 255) / 256, (size_t)4 * 132);
  combine_kernel<T><<<blocks, 256, 0, stream>>>(partial, scale, y, M, N,
                                                splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K), w (K, N) int8, scale (N,) float32, y (M, N) like x; partial
// (splits, M, N) float32 scratch when splits > 1. Split z covers K rows
// [z * kchunk, min(K, (z + 1) * kchunk)); kchunk is a multiple of 32.
// bm: 16 or 64 rows per block (bf16); 16 (f32).
extern "C" int int8_matmul_bf16(const void* x, const void* w,
                                const void* scale, void* y, void* partial,
                                int M, int K, int N, int bm, int splits,
                                int kchunk, void* stream) {
  if (K % 16 || N % 16 || kchunk % BK || splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((N + BN - 1) / BN, (M + bm - 1) / bm, splits);
  const auto* xp = (const __nv_bfloat16*)x;
  auto* yp = (__nv_bfloat16*)y;
  if (bm == 16)
    int8_mm_bf16_kernel<16><<<grid, THREADS, 0, st>>>(
        xp, (const int8_t*)w, (const float*)scale, yp, (float*)partial, M,
        K, N, kchunk);
  else if (bm == 64)
    int8_mm_bf16_kernel<64><<<grid, THREADS, 0, st>>>(
        xp, (const int8_t*)w, (const float*)scale, yp, (float*)partial, M,
        K, N, kchunk);
  else
    return (int)cudaErrorInvalidValue;
  return finish((const float*)partial, (const float*)scale, yp, M, N,
                splits, st);
}

extern "C" int int8_matmul_f32(const void* x, const void* w,
                               const void* scale, void* y, void* partial,
                               int M, int K, int N, int bm, int splits,
                               int kchunk, void* stream) {
  if (K % 16 || N % 16 || kchunk % BK || splits < 1 || bm != 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((N + BN - 1) / BN, (M + bm - 1) / bm, splits);
  int8_mm_f32_kernel<<<grid, THREADS, 0, st>>>(
      (const float*)x, (const int8_t*)w, (const float*)scale, (float*)y,
      (float*)partial, M, K, N, kchunk);
  return finish((const float*)partial, (const float*)scale, (float*)y, M,
                N, splits, st);
}
