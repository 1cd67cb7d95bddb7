// Split-context decode attention in float32 for Hopper (sm_90a): three
// launches of float32 FMAs, shared by the float32 entries of the ports of
// the Pallas TPU kernels
// ``repro/kernels/decode_attention.py::paged_decode_attention`` (TPU kernel
// 2, float32 pools: ``paged_decode_attention.cu``),
// ``::paged_decode_attention_int8`` (TPU kernel 4, int8 pools with one
// float32 scale per (slot, kv head) and float32 q:
// ``paged_decode_attention_int8.cu``) and ``::decode_attention`` (TPU kernel
// 6, float32 rings of W rows per slot: ``decode_attention.cu``). Every
// bfloat16 call takes a one-launch kernel of ``decode_sm90.cuh`` instead:
// the twin-order kernel for bf16 and int8 pools, the online-softmax one on
// the tensor cores for bf16 rings. float32 stays here: those kernels stage
// bf16 tiles, and the 2e-5 gate against the twins and the CUDA == CPU
// float32 streams of ``chip_smoke.py`` need float32 operands. The kernels
// are templated on the pool type; a pool type says where a cache row lives
// (through the slot's page-table row, or at row t of slot b of a ring when
// ``kRing``) and how a tile of rows becomes float32 in shared memory.
//
// For each decode slot b and kv head c, the G*S query rows that share the
// kv head (rows ordered (g, s); q head c*G + g) attend the slot's pages,
// resolved through its row of the page table, or its ring. Query s of S
// sees min(pos - (S-1) + s, W) cache slots (capped per query, as the
// twins: a ring written past W holds W valid rows for every query); slots
// at or past the slot's last valid one are never loaded. Past 64 rows
// (a chunk of prefill over a linear buffer: granite's 64-token chunk is
// 256 rows, a suffix up to 4096) the rows are cut into groups of 64, each
// group its own blocks (the grid's y is slot x group); every group of a
// slot splits its context alike, so the combine sums the same ranges.
//
// The pools are read in their model layout (P, ps, KVH, D) through the
// strides the wrapper passes: no per-call transpose of the pool (the
// reference wrapper's transpose would copy every layer's pool every tick
// in eager PyTorch). A block serves all G*S rows of one (slot, kv head),
// so each K/V element is fetched from device memory once for G heads.
//
// What bounds it: decode reads every valid K/V element once and does two
// FLOPs per element per query row, so at G*S <= 64 rows it is bound by
// device-memory bandwidth, and at the engine's batch (8 slots x 8 kv
// heads = 64 pairs for 132 SMs) by how many loads are in flight. So each
// slot's context is split across ``nsplit`` blocks (flash-decoding), and
// a block issues a whole 32-slot tile's 16-byte loads at once, with the
// next tile's loads in flight while it computes (the pool's tile loader).
//
// Numerics follow the model's twins ``layers.paged_decode_attention`` and
// ``layers.paged_decode_attention_int8``, whose probabilities are
// normalized by the row's GLOBAL max and sum before P V. Three launches
// keep that order across splits:
//   1. scores: each block writes its slots' scaled scores to a float32
//      scratch and the (max, sum of exp) of its range for every row;
//   2. pv: each block merges every split's (max, sum) into the row's
//      global ones, forms exp(s - max) / sum for its range and accumulates
//      P V into its partial output;
//   3. combine: the partial outputs are summed over the splits, in split
//      order.
#pragma once

#include "common.cuh"

namespace paged {

constexpr int TK = 32;        // cache slots per tile (one per lane)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
// G * S query rows per block, at most: each kernel is instantiated for
// MR = 32 and MR = 64 rows (MR / WARPS rows per warp in registers), and a
// call takes the smaller that holds a group's rows (recurrentgemma's 16
// heads over one kv head: 16 rows at S = 1, 64 at S = 4).
constexpr int MAX_ROWS = 64;

// What every block of one call shares: shapes and its own range. R is
// every row of a (slot, kv head); ngroups groups of up to MAX_ROWS.
struct Geometry {
  int S, H, KVH, G, R, n_pages, ps, W, wpad, nsplit, ngroups;
};

// The decode slot of block row y and its group's rows [r0, r0 + rows).
__device__ __forceinline__ void block_rows(const Geometry& g, int y, int& b,
                                           int& r0, int& rows) {
  b = y / g.ngroups;
  r0 = (y % g.ngroups) * MAX_ROWS;
  rows = min(g.R - r0, MAX_ROWS);
}

// The slots [t_begin, t_end) of slot b that split ``split`` covers: the
// slot's valid tiles are dealt out in contiguous runs.
__device__ __forceinline__ void split_range(const Geometry& g, int nmax,
                                            int split, int& t_begin,
                                            int& t_end) {
  const int ntiles = (nmax + TK - 1) / TK;
  const int per = (ntiles + g.nsplit - 1) / g.nsplit;
  t_begin = min(nmax, split * per * TK);
  t_end = min(nmax, (split + 1) * per * TK);
}

// Cache slot t0 + j of (decode slot b, kv head c), or the pool's empty
// row past the last valid one. A paged pool finds it through the slot's
// page-table row ``trow``; a ring holds it at row t of slot b.
template <typename Pool>
struct SlotRows {
  Pool pool;
  const int* trow;
  int b, ps, c, t0, nmax;
  __device__ __forceinline__ typename Pool::Row operator()(int j) const {
    const int t = t0 + j;
    if (t >= nmax) return Pool::none();
    if constexpr (Pool::kRing)
      return pool.ring_row(b, t, c);
    else
      return pool.row(trow[t / ps], t % ps, c);
  }
};

// The page-table row of decode slot b (none for a ring).
__device__ __forceinline__ const int* table_row(const int* table, int b,
                                                int n_pages) {
  return table != nullptr ? table + (size_t)b * n_pages : nullptr;
}

template <typename Pool, int D, int MR>
__global__ void __launch_bounds__(THREADS)
scores_kernel(const float* __restrict__ q, Pool kp,
              const int* __restrict__ table, const int* __restrict__ pos,
              float* __restrict__ scores,
              float2* __restrict__ stats, Geometry g, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;        // [R][D]: the group's rows
  float* ks = qs + MR * D;  // [TK][D + 1]

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c = blockIdx.x, split = blockIdx.z;
  int b, r0, R;
  block_rows(g, blockIdx.y, b, r0, R);
  const int nmax = min(pos[b], g.W);  // valid slots of the last query row
  int t_begin, t_end;
  split_range(g, nmax, split, t_begin, t_end);
  const int* trow = table_row(table, b, g.n_pages);

  typename Pool::template Tile<TK, D, THREADS> tile;
  if (t_begin < t_end)
    tile.load(SlotRows<Pool>{kp, trow, b, g.ps, c, t_begin, nmax});
  for (int idx = tid; idx < R * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    const int gi = (r0 + r) / g.S, s = (r0 + r) % g.S;
    qs[idx] = q[((size_t)(b * g.S + s) * g.H + c * g.G + gi) * D + d];
  }

  int nr = 0;  // rows of this warp: r = w + WARPS * i
  for (int r = w; r < R; r += WARPS) ++nr;
  constexpr int RPW = MR / WARPS;  // rows per warp, at most
  float m[RPW], l[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  float* srow = scores + (size_t)(b * g.KVH + c) * g.R * g.wpad;

  for (int t0 = t_begin; t0 < t_end; t0 += TK) {
    __syncthreads();
    tile.store(ks, D + 1);
    __syncthreads();
    if (t0 + TK < t_end)
      tile.load(SlotRows<Pool>{kp, trow, b, g.ps, c, t0 + TK, nmax});
    float acc[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) acc[i] = 0.0f;
    const float* kr = ks + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
        if (i < nr) acc[i] += qs[(w + WARPS * i) * D + d] * kd;
    }
    const int t = t0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (i >= nr) break;
      const int r = r0 + w + WARPS * i, s = r % g.S;
      const int lim = min(pos[b] - (g.S - 1) + s, g.W);
      const bool ok = t < lim;
      const float x = ok ? acc[i] * scale : -INFINITY;
      srow[(size_t)r * g.wpad + t] = x;
      const float mn = fmaxf(m[i], warp_max(x));
      const float e = warp_sum(ok ? expf(x - mn) : 0.0f);
      l[i] = (m[i] == -INFINITY ? 0.0f : l[i] * expf(m[i] - mn)) + e;
      m[i] = mn;
    }
  }
  if (lane == 0) {
    for (int i = 0; i < nr; ++i) {
      const int r = r0 + w + WARPS * i;
      stats[((size_t)(b * g.KVH + c) * g.nsplit + split) * g.R + r] =
          make_float2(m[i], l[i]);
    }
  }
}

template <typename Pool, int D, int MR>
__global__ void __launch_bounds__(THREADS)
pv_kernel(Pool vp, const int* __restrict__ table, const int* __restrict__ pos,
          const float* __restrict__ scores, const float2* __restrict__ stats,
          float* __restrict__ partial, Geometry g) {
  constexpr int E = D / 32;
  extern __shared__ float smem[];
  float* vs = smem;            // [TK][D]
  float* rm = vs + TK * D;     // [R] the row's global max
  float* rl = rm + MR;         // [R] and sum of exp

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c = blockIdx.x, split = blockIdx.z;
  int b, r0, R;
  block_rows(g, blockIdx.y, b, r0, R);
  const int nmax = min(pos[b], g.W);
  int t_begin, t_end;
  split_range(g, nmax, split, t_begin, t_end);
  const int* trow = table_row(table, b, g.n_pages);

  typename Pool::template Tile<TK, D, THREADS> tile;
  if (t_begin < t_end)
    tile.load(SlotRows<Pool>{vp, trow, b, g.ps, c, t_begin, nmax});
  const float2* st = stats + (size_t)(b * g.KVH + c) * g.nsplit * g.R + r0;
  for (int r = tid; r < R; r += blockDim.x) {
    float mx = -INFINITY;
    for (int j = 0; j < g.nsplit; ++j) mx = fmaxf(mx, st[j * g.R + r].x);
    float sum = 0.0f;
    for (int j = 0; j < g.nsplit; ++j) {
      const float2 ml = st[j * g.R + r];
      if (ml.y > 0.0f) sum += ml.y * expf(ml.x - mx);
    }
    rm[r] = mx;
    rl[r] = sum;
  }

  int nr = 0;
  for (int r = w; r < R; r += WARPS) ++nr;
  constexpr int RPW = MR / WARPS;
  float out[RPW][E];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) out[i][e] = 0.0f;
  const float* srow = scores + (size_t)(b * g.KVH + c) * g.R * g.wpad;

  for (int t0 = t_begin; t0 < t_end; t0 += TK) {
    __syncthreads();
    tile.store(vs, D);
    __syncthreads();
    if (t0 + TK < t_end)
      tile.load(SlotRows<Pool>{vp, trow, b, g.ps, c, t0 + TK, nmax});
    const int t = t0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      if (i >= nr) break;
      const int r = w + WARPS * i, s = (r0 + r) % g.S;
      const int lim = min(pos[b] - (g.S - 1) + s, g.W);
      const float p = t < lim ? expf(srow[(size_t)(r0 + r) * g.wpad + t] -
                                     rm[r]) / rl[r]
                              : 0.0f;
      for (int j = 0; j < TK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int e = 0; e < E; ++e) out[i][e] += pj * vs[j * D + lane + 32 * e];
      }
    }
  }

  float* dst = partial + ((size_t)(b * g.KVH + c) * g.nsplit + split) * g.R * D;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (i >= nr) break;
    const int r = r0 + w + WARPS * i;
#pragma unroll
    for (int e = 0; e < E; ++e) dst[(size_t)r * D + lane + 32 * e] = out[i][e];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ partial, float* __restrict__ o,
               Geometry g) {
  const int c = blockIdx.x, b = blockIdx.y;
  const float* src = partial + (size_t)(b * g.KVH + c) * g.nsplit * g.R * D;
  for (int idx = threadIdx.x; idx < g.R * D; idx += blockDim.x) {
    float sum = 0.0f;
    for (int j = 0; j < g.nsplit; ++j) sum += src[(size_t)j * g.R * D + idx];
    const int r = idx / D, d = idx % D, gi = r / g.S, s = r % g.S;
    o[((size_t)(b * g.S + s) * g.H + c * g.G + gi) * D + d] = sum;
  }
}

template <typename Pool, int D, int MR>
int launch(const void* q, const Pool& kp, const Pool& vp, const int* table,
           const int* pos, void* o, float* scores, float* stats,
           float* partial, int B, const Geometry& g, float scale,
           cudaStream_t stream) {
  const size_t smem_s = sizeof(float) * ((size_t)MR * D + TK * (D + 1));
  const size_t smem_p = sizeof(float) * ((size_t)TK * D + 2 * MR);
  cudaError_t err = cudaFuncSetAttribute(
      scores_kernel<Pool, D, MR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_s);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(g.KVH, B * g.ngroups, g.nsplit);
  scores_kernel<Pool, D, MR><<<grid, THREADS, smem_s, stream>>>(
      (const float*)q, kp, table, pos, scores, (float2*)stats, g, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pv_kernel<Pool, D, MR><<<grid, THREADS, smem_p, stream>>>(
      vp, table, pos, scores, (const float2*)stats, partial, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<D><<<dim3(g.KVH, B), THREADS, 0, stream>>>(
      partial, (float*)o, g);
  return (int)cudaGetLastError();
}

// The smaller row capacity that holds a group's rows.
template <typename Pool, int D>
int by_rows(const void* q, const Pool& kp, const Pool& vp, const int* table,
            const int* pos, void* o, float* scores, float* stats,
            float* partial, int B, const Geometry& g, float scale,
            cudaStream_t st) {
  if (g.R <= 32)  // one group
    return launch<Pool, D, 32>(q, kp, vp, table, pos, o, scores, stats,
                               partial, B, g, scale, st);
  return launch<Pool, D, 64>(q, kp, vp, table, pos, o, scores, stats,
                             partial, B, g, scale, st);
}

// Shapes to a Geometry, and the head dim to its instantiation. A ring is
// one page of W = ps rows per slot, with no page table (table nullptr).
template <typename Pool>
int dispatch(const void* q, const Pool& kp, const Pool& vp, const int* table,
             const int* pos, void* o, float* scores, float* stats,
             float* partial, int B, int S, int H, int KVH, int D,
             int n_pages, int ps, int nsplit, float scale, void* stream) {
  Geometry g;
  g.S = S;
  g.H = H;
  g.KVH = KVH;
  g.G = H / KVH;
  g.R = g.G * S;
  g.n_pages = n_pages;
  g.ps = ps;
  g.W = n_pages * ps;
  g.wpad = (g.W + TK - 1) / TK * TK;
  g.nsplit = nsplit;
  g.ngroups = (g.R + MAX_ROWS - 1) / MAX_ROWS;
  // a group's blocks share y with the slot's: gridDim.y is at most 65535
  if (g.R < 1 || nsplit < 1 || (long long)B * g.ngroups > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return by_rows<Pool, 32>(q, kp, vp, table, pos, o, scores, stats,
                               partial, B, g, scale, st);
    case 64:
      return by_rows<Pool, 64>(q, kp, vp, table, pos, o, scores, stats,
                               partial, B, g, scale, st);
    case 128:
      return by_rows<Pool, 128>(q, kp, vp, table, pos, o, scores, stats,
                                partial, B, g, scale, st);
    case 256:
      return by_rows<Pool, 256>(q, kp, vp, table, pos, o, scores, stats,
                                partial, B, g, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace paged
