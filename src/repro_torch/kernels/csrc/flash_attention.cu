// Prefill attention for Hopper (sm_90a), the port of the Pallas TPU kernel
// ``repro/kernels/flash_attention.py::flash_attention`` (TPU kernel 1).
//
// Computes softmax(Q K^T d^-1/2) V, causal or not, for q (B, S, H, D) and
// k/v (B, S, KVH, D) in their model layout, optionally over a local
// window (``window`` > 0: query s sees keys t > s - window, as the
// reference's ``layers.dense_attention``; the local-attention blocks of
// hybrid archs, window 2048 at head_dim 256), or bidirectional (``causal``
// 0: an encoder's attention, hubert-xlarge at head_dim 80); q head h reads
// kv head h / G inside the kernel (no repeated K/V is ever materialized, unlike the
// reference wrapper's jnp.repeat). S may be any length: the engine's
// buckets (16, 32, 64, ...) are smaller than one tile and the ragged edge
// is masked here; a bucket's end padding is hidden by causality alone.
// Tiles wholly past the causal edge or wholly behind the window are
// skipped, so a block reads at most window + one tile of keys.
//
// What bounds it: at the engine's prompt lengths (16..2560) a layer's
// attention is 0.1 to 52 GFLOP against a few MB of q/k/v/o, so the bound
// is the tensor cores' rate (989 TFLOP/s bf16), not the bytes.
//
// bfloat16 (``flash_attention_bf16``): one pass over K/V with an online
// softmax, as the Pallas kernel runs it. A block is WARPS warps of 16
// query rows of one head; for each tile of 64 keys, S = Q K^T and
// O += P V run on the tensor cores (``mma.sync.m16n8k16`` bf16 -> f32),
// with fragments from ``ldmatrix`` (``.trans`` for V) on XOR-swizzled bf16
// tiles; the running max and sum and the O accumulator stay float32 in
// registers; P = exp(s - m) is rounded to bf16 as the A operand (no other
// rounding: between the Pallas kernel, which rounds nothing, and the
// twin, which rounds the normalized p), and O is divided by the sum once
// at the end. K/V tiles stream through a ring of STAGES shared-memory
// stages filled by 16-byte ``cp.async`` copies (rows past S zero-filled),
// so the next tiles' copies fly while the current one computes, with one
// barrier per tile. Only tiles on the causal edge, the window's edge or
// S's edge are masked; the heaviest causal row tiles are first in the
// grid. WARPS and STAGES are fixed per head_dim (``flash_attention_bf16``
// below): at head_dim 256 8 warps and 2 stages, 2 * 256 * (128 + 2 * 64 *
// 2) = 196,608 B of the 232,448 a block may have; at head_dim 128 and
// below 4 warps and 3 stages (two or more blocks per SM). head_dim 80
// (hubert-xlarge, 10 chunks of 16 bytes a row) pads each shared-memory row
// to 16 chunks (256 B), so the XOR swizzle of 8 chunks holds; the padding
// chunks are never written nor read (the k-steps of Q K^T and the column
// tiles of O cover the 10 real chunks only), and the shared memory is
// head_dim 128's.
//
// float32 (``flash_attention_f32``) keeps the first FMA kernel: two passes,
// float32 FMAs from shared memory. Float32 inputs are not exact in bf16
// or TF32 tensor-core products, and two gates need float32 arithmetic: the
// 2e-5 tolerance against the plain version, and ``chip_smoke.py`` phase 3,
// where float32 engine streams on the card must equal the CPU's token for
// token. Its numerics follow the twin ``layers.dense_attention``: pass 1
// finds each row's max and sum over all keys, pass 2 forms the NORMALIZED
// probability, rounds it to the input type and accumulates P V. Each lane
// owns columns lane + 32 e of O; at head_dim 80 the third (e = 2) exists
// for lanes 0-15 only.
#include "common.cuh"
#include "tensor_core.cuh"

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// float32: FMAs from float32 shared tiles, 32 query rows per block
// ---------------------------------------------------------------------------
namespace f32path {

constexpr int BQ = 32;       // query rows per block
constexpr int BK = 32;       // keys per tile (one per lane)
constexpr int WARPS = 8;     // 4 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;

using T = float;

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KVH, float scale, int causal, int window) {
  constexpr int E = (D + 31) / 32;  // output columns per lane (or fewer)
  extern __shared__ float smem[];
  float* qs = smem;                  // [BQ][D]
  float* ks = qs + BQ * D;           // [BK][D + 1]
  float* vs = ks + BK * (D + 1);     // [BK][D]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c = h / (H / KVH);

  for (int idx = tid; idx < BQ * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    qs[idx] = s < S ? to_f32<T>(q[((size_t)(b * S + s) * H + h) * D + d])
                    : 0.0f;
  }

  // causal: no key past the block's last query row is ever needed;
  // window: none at or before the block's first row's window start
  const int q_last = min(q0 + BQ, S) - 1;
  const int n_keys = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }

  // key t of this (batch, kv head), or past the edge
  auto keys_from = [&](const T* src, int k0) {
    return [=](int j) -> const T* {
      const int t = k0 + j;
      return t < S ? src + ((size_t)(b * S + t) * KVH + c) * D : nullptr;
    };
  };
  TileLoader<T, BK, D, THREADS> ktile, vtile;

  auto scores = [&](float (&sc)[ROWS_PER_WARP]) {
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) sc[i] = 0.0f;
    const float* kr = ks + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i)
        sc[i] += qs[(w * ROWS_PER_WARP + i) * D + d] * kd;
    }
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) sc[i] *= scale;
  };

  // ---- pass 1: row max and softmax denominator over every key ----
  ktile.load(keys_from(k, k_begin));
  for (int k0 = k_begin; k0 < n_keys; k0 += BK) {
    __syncthreads();
    ktile.store(ks, D + 1);
    __syncthreads();
    if (k0 + BK < n_keys) ktile.load(keys_from(k, k0 + BK));
    float sc[ROWS_PER_WARP];
    scores(sc);
    const int t = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int s = q0 + w * ROWS_PER_WARP + i;
      const bool ok = t < S && (!causal || t <= s) &&
                      (window <= 0 || t > s - window);
      const float x = ok ? sc[i] : -INFINITY;
      const float mt = warp_max(x);
      const float mn = fmaxf(m[i], mt);
      const float e = ok ? expf(x - mn) : 0.0f;
      const float es = warp_sum(e);
      l[i] = (m[i] == -INFINITY ? 0.0f : l[i] * expf(m[i] - mn)) + es;
      m[i] = mn;
    }
  }
  // the twin's denominator is sum(exp(s - m_final)); rescaling above keeps
  // it equal up to rounding

  // ---- pass 2: normalized probabilities, rounded to T, times V ----
  float acc[ROWS_PER_WARP][E];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.0f;

  ktile.load(keys_from(k, k_begin));
  vtile.load(keys_from(v, k_begin));
  for (int k0 = k_begin; k0 < n_keys; k0 += BK) {
    __syncthreads();
    ktile.store(ks, D + 1);
    vtile.store(vs, D);
    __syncthreads();
    if (k0 + BK < n_keys) {
      ktile.load(keys_from(k, k0 + BK));
      vtile.load(keys_from(v, k0 + BK));
    }
    float sc[ROWS_PER_WARP];
    scores(sc);
    const int t = k0 + lane;
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int s = q0 + w * ROWS_PER_WARP + i;
      const bool ok = t < S && (!causal || t <= s) &&
                      (window <= 0 || t > s - window);
      const float p = ok ? round_to<T>(expf(sc[i] - m[i]) / l[i]) : 0.0f;
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (D % 32 == 0 || lane + 32 * e < D)
            acc[i][e] += pj * vs[j * D + lane + 32 * e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int s = q0 + w * ROWS_PER_WARP + i;
    if (s >= S) continue;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (D % 32 == 0 || lane + 32 * e < D)
        o[((size_t)(b * S + s) * H + h) * D + lane + 32 * e] =
            from_f32<T>(acc[i][e]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KVH, float scale, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<D><<<grid, THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, S, H,
      KVH, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace f32path

// ---------------------------------------------------------------------------
// bfloat16: one pass on the tensor cores
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int BKV = 64;  // keys per K/V tile

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D, int WARPS, int STAGES>
__global__ void __launch_bounds__(WARPS * 32)
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            int S, int H, int KVH, float scale_log2,
                            int causal, int window) {
  constexpr int BQ = 16 * WARPS;   // query rows per block
  constexpr int THREADS = WARPS * 32;
  static_assert(D % 16 == 0, "whole k-steps of Q K^T, O tile pairs");
  constexpr int CPR = D / 8;       // 16-byte chunks of a row
  // chunks of a shared-memory row: the swizzle takes 4 or a multiple of 8
  constexpr int PITCH = CPR == 4 ? 4 : (CPR + 7) / 8 * 8;
  constexpr int DT = D / 8;          // 8-column tiles of O
  constexpr int KT = BKV / 8;        // 8-key tiles of S
  constexpr int TILE = BKV * PITCH;  // chunks of one K or V tile
  extern __shared__ uint4 ring_smem[];
  uint4* qs = ring_smem;          // [BQ][PITCH], swizzled
  uint4* ring = qs + BQ * PITCH;  // STAGES x (K tile, V tile)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // heaviest first
  const int c = h / (H / KVH);
  const size_t qstride = (size_t)H * D, kvstride = (size_t)KVH * D;
  const bf16* qb = q + (size_t)b * S * qstride + (size_t)h * D;
  const bf16* kb = k + (size_t)b * S * kvstride + (size_t)c * D;
  const bf16* vb = v + (size_t)b * S * kvstride + (size_t)c * D;

  // causal: no key past the block's last row; window: none at or before
  // the first row's window start
  const int q_last = min(q0 + BQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BKV * BKV : 0;
  const int n_tiles = (k_end - k_begin + BKV - 1) / BKV;

  // ROWS rows from row r0 of ``src`` (rows past S as zeros) into ``dst``
  auto copy_rows = [&](uint4* dst, const bf16* src, size_t stride, int r0,
                       auto rows_c) {
    constexpr int ROWS = decltype(rows_c)::value;
#pragma unroll
    for (int i = 0; i < (ROWS * CPR + THREADS - 1) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      if (ROWS * CPR % THREADS == 0 || idx < ROWS * CPR) {
        const int r = idx / CPR, ch = idx % CPR, s = r0 + r;
        const bool ok = s < S;
        cp_async16(dst + swizzle<PITCH>(r, ch),
                   src + (size_t)(ok ? s : 0) * stride + ch * 8, ok);
      }
    }
  };
  using TileRows = std::integral_constant<int, BKV>;
  auto load_tile = [&](int j) {
    uint4* st = ring + (j % STAGES) * 2 * TILE;
    copy_rows(st, kb, kvstride, k_begin + j * BKV, TileRows{});
    copy_rows(st + TILE, vb, kvstride, k_begin + j * BKV, TileRows{});
  };

  copy_rows(qs, qb, qstride, q0, std::integral_constant<int, BQ>{});
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + STAGES - 1 < n_tiles) load_tile(j + STAGES - 1);
    cp_async_commit();
    const uint4* ks = ring + (j % STAGES) * 2 * TILE;
    const uint4* vs = ks + TILE;
    const int k0 = k_begin + j * BKV;

    // ---- S = Q K^T ----
    float sc[KT][4];
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + swizzle<PITCH>(warp * 16 + (lane & 15),
                                         2 * kk + (lane >> 4)));
#pragma unroll
      for (int np = 0; np < KT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + swizzle<PITCH>(
                                 np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                 2 * kk + ((lane >> 3) & 1)));
        mma_bf16(sc[2 * np], a, bk);
        mma_bf16(sc[2 * np + 1], a, bk + 2);
      }
    }

    // ---- scale and mask (edge tiles only), online softmax ----
    const bool edge = k0 + BKV > S || (causal && k0 + BKV - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale_log2;
        if (edge) {
          const int tk = k0 + 8 * n + 2 * t + (e & 1);
          const int s = row0 + 8 * (e >> 1);
          const bool ok = tk < S && (!causal || tk <= s) &&
                          (window <= 0 || tk > s - window);
          x = ok ? x : -INFINITY;
        }
        sc[n][e] = x;
      }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int n = 0; n < KT; ++n)
        mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with every key masked so far keeps m = -inf; exp against 0
      base[i] = mx == -INFINITY ? 0.0f : mx;
      const float alpha = fast_exp2(m_run[i] - base[i]);
      m_run[i] = mx;
      l_run[i] *= alpha;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * i] *= alpha;
        acc[d][2 * i + 1] *= alpha;
      }
    }
    // P as the A operand of P V: S's n-tiles 2kk, 2kk + 1 are the k-step
    // kk of the product (the C layout of m16n8 is the A layout of m16k16)
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      const float p0 = fast_exp2(sc[n][0] - base[0]);
      const float p1 = fast_exp2(sc[n][1] - base[0]);
      const float p2 = fast_exp2(sc[n][2] - base[1]);
      const float p3 = fast_exp2(sc[n][3] - base[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pa[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // ---- O += P V ----
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, vs + swizzle<PITCH>(16 * kk + (lane & 7) +
                                        (((lane >> 3) & 1) << 3),
                                    2 * dp + (lane >> 4)));
        mma_bf16(acc[2 * dp], pa[kk], bv);
        mma_bf16(acc[2 * dp + 1], pa[kk], bv + 2);
      }
  }
  cp_async_wait<0>();

  // each thread summed its own columns: the row's sum is the quad's
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    const int s = row0 + 8 * i;
    if (s >= S) continue;
    const float inv = 1.0f / l_run[i];
    bf16* orow = o + ((size_t)b * S + s) * qstride + (size_t)h * D + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(orow + 8 * d) =
          pack_bf16(acc[d][2 * i] * inv, acc[d][2 * i + 1] * inv);
  }
}

template <int D, int WARPS, int STAGES>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KVH, float scale, int causal, int window,
                cudaStream_t stream) {
  constexpr int BQ = 16 * WARPS;
  constexpr int CPR = D / 8;
  constexpr int PITCH = CPR == 4 ? 4 : (CPR + 7) / 8 * 8;
  constexpr size_t smem = sizeof(uint4) * PITCH * (BQ + 2 * BKV * STAGES);
  static_assert(smem <= 232448, "a block's shared memory");
  auto* kernel = flash_attention_bf16_kernel<D, WARPS, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (S + BQ - 1) / BQ);
  kernel<<<grid, WARPS * 32, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, H, KVH,
      scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// ``window`` > 0 masks keys t <= s - window for query s; 0 sees them all.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int KVH, int D, float scale,
                                   int causal, int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return f32path::launch<32>(q, k, v, o, B, S, H, KVH, scale, causal,
                                 window, st);
    case 64:
      return f32path::launch<64>(q, k, v, o, B, S, H, KVH, scale, causal,
                                 window, st);
    case 80:
      return f32path::launch<80>(q, k, v, o, B, S, H, KVH, scale, causal,
                                 window, st);
    case 128:
      return f32path::launch<128>(q, k, v, o, B, S, H, KVH, scale, causal,
                                  window, st);
    case 256:
      return f32path::launch<256>(q, k, v, o, B, S, H, KVH, scale, causal,
                                  window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// WARPS (16 query rows each) and STAGES (K/V tiles in flight) per head_dim:
// 8 x 2 at 256 (a third stage of 8 warps would pass the 232,448 B, and
// 4 x 3 measured slower at recurrentgemma's band), 4 x 3 below (head_dim 80
// in rows padded to 128's).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int KVH, int D, float scale,
                                    int causal, int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch_bf16<32, 4, 3>(q, k, v, o, B, S, H, KVH, scale, causal,
                                   window, st);
    case 64:
      return launch_bf16<64, 4, 3>(q, k, v, o, B, S, H, KVH, scale, causal,
                                   window, st);
    case 80:
      return launch_bf16<80, 4, 3>(q, k, v, o, B, S, H, KVH, scale, causal,
                                   window, st);
    case 128:
      return launch_bf16<128, 4, 3>(q, k, v, o, B, S, H, KVH, scale, causal,
                                    window, st);
    case 256:
      return launch_bf16<256, 8, 2>(q, k, v, o, B, S, H, KVH, scale, causal,
                                    window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
