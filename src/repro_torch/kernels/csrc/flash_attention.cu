// Prefill attention for Hopper (sm_90a), the port of the Pallas TPU kernel
// ``repro/kernels/flash_attention.py::flash_attention`` (TPU kernel 1).
//
// Computes softmax(Q K^T d^-1/2) V, causal or not, for q (B, S, H, D) and
// k/v (B, S, KVH, D) in their model layout, optionally over a local
// window (``window`` > 0: query s sees keys t > s - window, as the
// reference's ``layers.dense_attention``; the local-attention blocks of
// hybrid archs, window 2048 at head_dim 256); q head h reads kv head h / G
// inside the kernel (no repeated K/V is ever materialized, unlike the
// reference wrapper's jnp.repeat). S may be any length: the engine's
// buckets (16, 32, 64, ...) are smaller than one tile and the ragged edge
// is masked here; a bucket's end padding is hidden by causality alone.
//
// Numerics follow the model's twin ``layers.dense_attention`` rather than
// an online softmax: pass 1 finds each row's max and sum over all keys,
// pass 2 forms the NORMALIZED probability, rounds it to the input type
// (the twin's ``probs.astype(q.dtype)``) and accumulates P V in float32.
// So bf16 outputs land where the twin's do, up to summation order.
//
// What bounds it: at the engine's prompt lengths (16..2048) a layer's
// attention is a few to a few tens of GFLOP, so the bound is the tensor
// cores' rate; this first version runs float32 FMAs from shared memory
// (no wgmma) and computes Q K^T twice, so it sits well below that bound.
// K/V tiles are staged once in shared memory per block and read by all
// 32 query rows, the next tile's loads in flight during the current
// tile's compute (TileLoader); tiles wholly past the causal edge or
// wholly behind the window are skipped. At head_dim 256 a block holds
// 4 * (32*256 + 32*257 + 32*256) B = 98,432 B of shared memory. Making it fast
// (wgmma on bf16 tiles, TMA, one pass) is later work.
#include "common.cuh"

namespace {

constexpr int BQ = 32;       // query rows per block
constexpr int BK = 32;       // keys per tile (one per lane)
constexpr int WARPS = 8;     // 4 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int H, int KVH, float scale, int causal, int window) {
  constexpr int E = D / 32;  // output columns per lane
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
        for (int e = 0; e < E; ++e) acc[i][e] += pj * vs[j * D + lane + 32 * e];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int s = q0 + w * ROWS_PER_WARP + i;
    if (s >= S) continue;
#pragma unroll
    for (int e = 0; e < E; ++e)
      o[((size_t)(b * S + s) * H + h) * D + lane + 32 * e] =
          from_f32<T>(acc[i][e]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KVH, float scale, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KVH, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int S, int H, int KVH, int D, float scale, int causal,
             int window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, H, KVH, scale, causal, window,
                           st);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, H, KVH, scale, causal, window,
                           st);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, H, KVH, scale, causal, window,
                            st);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, H, KVH, scale, causal, window,
                            st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ``window`` > 0 masks keys t <= s - window for query s; 0 sees them all.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int H, int KVH, int D, float scale,
                                   int causal, int window, void* stream) {
  return dispatch<float>(q, k, v, o, B, S, H, KVH, D, scale, causal, window,
                         stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int S,
                                    int H, int KVH, int D, float scale,
                                    int causal, int window, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, KVH, D, scale, causal,
                                 window, stream);
}
