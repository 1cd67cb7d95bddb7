// One-pass split-context decode attention on Hopper's tensor cores
// (sm_90a), bfloat16. It serves the port of the Pallas TPU kernel
// ``repro/kernels/decode_attention.py::decode_attention`` (TPU kernel 6)
// over bf16 rolling caches (``decode_attention.cu``, ``RingPool``), and is
// templated on the same pool concept as ``paged_decode.cuh`` (``SlotRows``,
// ``Pool::kRing``), so that the paged pools can move onto it by
// instantiation. The float32 ring and the paged pools stay on
// ``paged_decode.cuh``.
//
// For each decode slot b and kv head c, the G*S query rows that share the
// kv head (rows ordered (g, s)) attend the slot's cache rows; query s of S
// sees min(pos - (S-1) + s, W) rows. The grid is (KVH, B, nsplit): split z
// takes a contiguous run of the slot's 64-row tiles (``split_rows``).
//
// What bounds it: the bytes of the valid K/V rows (recurrentgemma: 8
// rings of 2048 rows x 256 x 2 B x 2 = 16.8 MB per layer when full), read
// once for the G query heads; the FLOPs are 4 * G * S per element, far
// below the tensor cores' rate. The three-launch core of
// ``paged_decode.cuh`` lost 3.9x to one SDPA call at recurrentgemma's
// shape: a float32 score scratch written and read back, scalar FMAs on
// float32 copies of each tile, and a combine launch on B x KVH = 8 blocks.
// This kernel is one launch with no score scratch:
//   * Q (G*S rows, padded to a multiple of 16 with zeros), K and V tiles
//     of 64 rows come into XOR-swizzled bf16 shared tiles by 16-byte
//     ``cp.async`` copies (rows past the slot's last valid one are
//     zero-filled and never fetched); K and V are separate commit groups,
//     so S = Q K^T starts while V is still in flight. A ring of up to 3
//     stages (as many as a split has tiles and shared memory holds: 3 at
//     16 rows and head_dim 256, 2 at 64 rows) keeps the next tiles'
//     copies in flight while one is computed. One bulk copy (TMA) per
//     cache row instead, started by one warp, measured slower on the H100.
//   * S = Q K^T and O += P V run on ``mma.sync.m16n8k16`` bf16 -> f32
//     with ``ldmatrix`` fragments: for S each warp takes 8 keys of the
//     tile for all query rows; the row maxima meet in shared memory; P =
//     exp(s - m), rounded to bf16 (as the one-pass prefill kernel
//     ``flash_attention.cu`` rounds it: before normalization, so the
//     output moves by at most one bf16 step against the twin, which
//     rounds the normalized p), goes to a shared tile; for O each warp
//     takes D / WARPS output columns. Running max, sum and O stay float32
//     in registers.
//   * The splits of one (slot, kv head), at most 8, are one thread-block
//     cluster on neighbouring SMs, and are merged deterministically, with
//     no atomics: each block publishes (m, l, O) in its own shared memory
//     and block r merges output columns [r D / nsplit, ...) of every
//     block through distributed shared memory, in rank order. At
//     recurrentgemma's shape (8 slots) that is 64 blocks of up to 4 tiles
//     each; 16 or 32 splits (two or four clusters merged by the last to
//     arrive, or one cluster of 16) measured slower, as did 4.
#pragma once

#include <cooperative_groups.h>

#include "paged_decode.cuh"
#include "tensor_core.cuh"

namespace sm90 {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int BKV = 64;         // ring rows per K/V tile
constexpr int MAX_CLUSTER = 8;   // splits per (slot, kv head): one cluster
constexpr int MAX_ROWS = 64;     // G * S query rows per block
constexpr int MAX_STAGES = 3;
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90

struct Geometry {
  int S, H, KVH, G, R, W, nsplit, stages;
  float scale_log2;  // d^-1/2 log2(e): scores in the exp2 domain
};

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The rows [t_begin, t_end) of a slot with nmax valid rows that split
// ``split`` of ``nsplit`` covers: whole 64-row tiles dealt out in
// contiguous runs (``decode_attention.split_rows`` in Python).
__device__ __forceinline__ void split_rows(int nmax, int nsplit, int split,
                                           int& t_begin, int& t_end) {
  const int ntiles = (nmax + BKV - 1) / BKV;
  const int per = (ntiles + nsplit - 1) / nsplit;
  t_begin = min(nmax, split * per * BKV);
  t_end = min(nmax, (split + 1) * per * BKV);
}

template <int D, int MT>
struct Config {
  static constexpr int WARPS = D >= 128 ? 8 : D / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int RP = MT * 16;         // query rows, padded
  static constexpr int CPR = D / 8;          // 16-byte chunks per row
  static constexpr int TILE = BKV * CPR;     // chunks of one K or V tile
  static constexpr int NPW = BKV / 8 / WARPS;  // 8-key tiles per warp (S)
  static constexpr int DPW = D / 8 / WARPS;    // 8-column tiles per warp (O)
  static constexpr int OPITCH = D + 4;       // floats per published O row
  static constexpr int Q_BYTES = RP * D * 2;
  static constexpr int P_OFF = Q_BYTES;
  static constexpr int RED_OFF = P_OFF + RP * BKV * 2;
  static constexpr int STAT_OFF = RED_OFF + WARPS * RP * 4;
  // pm, pl [RP]; merge weights [RP][MAX_CLUSTER]; 1 / merged sum [RP]
  static constexpr int RING_OFF = STAT_OFF + RP * (MAX_CLUSTER + 4) * 4;
  static constexpr int STAGE_BYTES = 2 * TILE * 16;
  static constexpr int O_BYTES = RP * OPITCH * 4;
  static constexpr int smem(int stages) {
    return RING_OFF + (stages * STAGE_BYTES > O_BYTES ? stages * STAGE_BYTES
                                                      : O_BYTES);
  }
  static_assert(DPW % 2 == 0 && NPW >= 1, "warp tiling");
  static_assert(RING_OFF % 16 == 0, "16-byte aligned ring");
};

template <typename Pool, int D, int MT>
__global__ void __launch_bounds__(Config<D, MT>::THREADS)
decode_kernel(const bf16* __restrict__ q, Pool kp, Pool vp,
              const int* __restrict__ pos, bf16* __restrict__ o,
              Geometry g) {
  using C = Config<D, MT>;
  constexpr int CPR = C::CPR, RP = C::RP, WARPS = C::WARPS;
  extern __shared__ uint4 sm90_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(sm90_smem);
  uint4* qs = sm90_smem;
  uint4* ps = reinterpret_cast<uint4*>(sm + C::P_OFF);  // P [RP][64] bf16
  float* red = reinterpret_cast<float*>(sm + C::RED_OFF);  // [WARPS][RP]
  float* pm = reinterpret_cast<float*>(sm + C::STAT_OFF);  // [RP] row max
  float* pl = pm + RP;                   // [RP] row sum
  float* cw = pl + RP;                   // [RP][MAX_CLUSTER] merge weights
  float* inv_sum = cw + RP * MAX_CLUSTER;  // [RP]
  uint4* ring = reinterpret_cast<uint4*>(sm + C::RING_OFF);
  float* os = reinterpret_cast<float*>(ring);  // [RP][OPITCH] after the loop

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int c = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int p = pos[b];
  const int nmax = min(p, g.W);
  const int lim0 = min(p - (g.S - 1), g.W);  // rows query 0 sees (fewest)
  int t_begin, t_end;
  split_rows(nmax, g.nsplit, split, t_begin, t_end);
  const int n_tiles = (t_end - t_begin + BKV - 1) / BKV;
  const int stages = g.stages;

  // Q rows r = gi * S + s (zeros past R), in the first commit group
  for (int idx = tid; idx < RP * CPR; idx += C::THREADS) {
    const int r = idx / CPR, ch = idx % CPR;
    const bool ok = r < g.R;
    const bf16* src = q;
    if (ok) {
      const int gi = r / g.S, s = r % g.S;
      src = q + ((size_t)(b * g.S + s) * g.H + c * g.G + gi) * D + ch * 8;
    }
    cp_async16(qs + swizzle<CPR>(r, ch), src, ok);
  }
  // 64 rows of a pool from row t0 of the slot; rows past nmax as zeros
  auto load = [&](uint4* dst, const Pool& pool, int t0) {
    const paged::SlotRows<Pool> rows{pool, nullptr, b, g.W, c, t0, nmax};
#pragma unroll
    for (int i = 0; i < C::TILE / C::THREADS; ++i) {
      const int idx = tid + i * C::THREADS;
      const int r = idx / CPR, ch = idx % CPR;
      const bf16* row = rows(r);
      cp_async16(dst + swizzle<CPR>(r, ch), row != nullptr ? row + ch * 8 : q,
                 row != nullptr);
    }
  };
  auto stage_k = [&](int j) { return ring + (j % stages) * 2 * C::TILE; };
  for (int st = 0; st < stages; ++st) {
    if (st < n_tiles) load(stage_k(st), kp, t_begin + st * BKV);
    cp_async_commit();
    if (st < n_tiles) load(stage_k(st) + C::TILE, vp, t_begin + st * BKV);
    cp_async_commit();
  }

  float acc[MT][C::DPW][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int d = 0; d < C::DPW; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][d][e] = 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_run[mt][h] = -INFINITY;
      l_run[mt][h] = 0.0f;
    }
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int t0 = t_begin + j * BKV;
    const uint4* ks = stage_k(j);
    const uint4* vs = ks + C::TILE;
    // K_j is commit group 2j of 2 (stages + j): 2 stages - 1 may fly
    if (stages == 1)
      cp_async_wait<1>();
    else if (stages == 2)
      cp_async_wait<3>();
    else
      cp_async_wait<5>();
    __syncthreads();

    // ---- S = Q K^T: this warp's keys 8 (warp + WARPS i) .. + 7 ----
    float sc[MT][C::NPW][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < C::NPW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][i][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t bk[C::NPW][4];  // k-steps kk ({0, 1}) and kk + 1 ({2, 3})
#pragma unroll
      for (int i = 0; i < C::NPW; ++i)
        ldmatrix_x4(bk[i], ks + swizzle<CPR>((warp + WARPS * i) * 8 +
                                                 (lane & 7),
                                             2 * kk + (lane >> 3)));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, qs + swizzle<CPR>(mt * 16 + (lane & 15),
                                          2 * kk + (lane >> 4)));
        ldmatrix_x4(a1, qs + swizzle<CPR>(mt * 16 + (lane & 15),
                                          2 * kk + 2 + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < C::NPW; ++i) {
          mma_bf16(sc[mt][i], a0, bk[i]);
          mma_bf16(sc[mt][i], a1, bk[i] + 2);
        }
      }
    }

    // ---- scale, mask (tiles past query 0's limit), row maxima ----
    const bool edge = t0 + BKV > lim0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < C::NPW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[mt][i][e] * g.scale_log2;
          if (edge) {
            const int tk = t0 + 8 * (warp + WARPS * i) + 2 * tq + (e & 1);
            const int s = (mt * 16 + gq + 8 * (e >> 1)) % g.S;
            if (tk >= min(p - (g.S - 1) + s, g.W)) x = -INFINITY;
          }
          sc[mt][i][e] = x;
        }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < C::NPW; ++i)
          mx = fmaxf(mx, fmaxf(sc[mt][i][2 * h], sc[mt][i][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (tq == 0) red[warp * RP + mt * 16 + gq + 8 * h] = mx;
      }
    __syncthreads();

    // ---- online softmax: every warp forms the same new max per row ----
    float base[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = mt * 16 + gq + 8 * h;
        float mx = m_run[mt][h];
#pragma unroll
        for (int w2 = 0; w2 < WARPS; ++w2) mx = fmaxf(mx, red[w2 * RP + row]);
        // a row with every key masked so far keeps m = -inf; exp against 0
        base[mt][h] = mx == -INFINITY ? 0.0f : mx;
        const float alpha = exp2_fast(m_run[mt][h] - base[mt][h]);
        m_run[mt][h] = mx;
        l_run[mt][h] *= alpha;
#pragma unroll
        for (int d = 0; d < C::DPW; ++d) {
          acc[mt][d][2 * h] *= alpha;
          acc[mt][d][2 * h + 1] *= alpha;
        }
      }
    // P = exp(s - m), rounded to bf16, into the shared P tile
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < C::NPW; ++i) {
        const int nt = warp + WARPS * i;
        const float p0 = exp2_fast(sc[mt][i][0] - base[mt][0]);
        const float p1 = exp2_fast(sc[mt][i][1] - base[mt][0]);
        const float p2 = exp2_fast(sc[mt][i][2] - base[mt][1]);
        const float p3 = exp2_fast(sc[mt][i][3] - base[mt][1]);
        l_run[mt][0] += p0 + p1;
        l_run[mt][1] += p2 + p3;
        reinterpret_cast<uint32_t*>(ps + swizzle<8>(mt * 16 + gq, nt))[tq] =
            pack_bf16(p0, p1);
        reinterpret_cast<uint32_t*>(
            ps + swizzle<8>(mt * 16 + gq + 8, nt))[tq] = pack_bf16(p2, p3);
      }
    if (stages == 1)  // V_j, group 2j + 1
      cp_async_wait<0>();
    else if (stages == 2)
      cp_async_wait<2>();
    else
      cp_async_wait<4>();
    __syncthreads();

    // ---- O += P V: this warp's output columns ----
    uint32_t pa[MT][BKV / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        ldmatrix_x4(pa[mt][kk], ps + swizzle<8>(mt * 16 + (lane & 15),
                                                2 * kk + (lane >> 4)));
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int dp = 0; dp < C::DPW / 2; ++dp) {
        const int pair = warp * (C::DPW / 2) + dp;
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, vs + swizzle<CPR>(16 * kk + (lane & 7) +
                                      (((lane >> 3) & 1) << 3),
                                  2 * pair + (lane >> 4)));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], pa[mt][kk], bv);
          mma_bf16(acc[mt][2 * dp + 1], pa[mt][kk], bv + 2);
        }
      }
    __syncthreads();  // every warp is done with this stage and with P
    const int nxt = j + stages;
    if (nxt < n_tiles) load(stage_k(nxt), kp, t_begin + nxt * BKV);
    cp_async_commit();
    if (nxt < n_tiles) load(stage_k(nxt) + C::TILE, vp, t_begin + nxt * BKV);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the published O

  // ---- publish this block's (m, l, O) in its shared memory ----
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = mt * 16 + gq + 8 * h;
      float l = l_run[mt][h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (tq == 0) {
        red[warp * RP + row] = l;
        if (warp == 0) pm[row] = m_run[mt][h];
      }
#pragma unroll
      for (int d = 0; d < C::DPW; ++d)
        *reinterpret_cast<float2*>(os + row * C::OPITCH +
                                   (warp * C::DPW + d) * 8 + 2 * tq) =
            make_float2(acc[mt][d][2 * h], acc[mt][d][2 * h + 1]);
    }
  __syncthreads();
  for (int row = tid; row < RP; row += C::THREADS) {
    float l = 0.0f;
#pragma unroll
    for (int w2 = 0; w2 < WARPS; ++w2) l += red[w2 * RP + row];
    pl[row] = l;
  }

  // ---- merge the splits (one cluster), block ``rank`` owning D / cs
  // output columns: every rank's (m, l) of a row, then its O, all loads in
  // flight at once, summed in rank order; ranks past cs count as empty
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  cl.sync();
  for (int row = tid; row < g.R; row += C::THREADS) {
    float mr[MAX_CLUSTER], lr[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      mr[r] = r < cs ? *cl.map_shared_rank(pm + row, r) : -INFINITY;
      lr[r] = r < cs ? *cl.map_shared_rank(pl + row, r) : 0.0f;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) mx = fmaxf(mx, mr[r]);
    // mx is finite: split 0 holds the slot's first row, which every
    // query row sees
    float l = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      const float w = exp2_fast(mr[r] - mx);
      cw[row * MAX_CLUSTER + r] = w;
      l += w * lr[r];
    }
    inv_sum[row] = 1.0f / l;
  }
  __syncthreads();
  const int dcs = D / cs, d0 = rank * dcs;
  const float* osr[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    osr[r] = cl.map_shared_rank(os, r < cs ? r : 0);
  for (int idx = tid; idx < g.R * dcs; idx += C::THREADS) {
    const int row = idx / dcs, d = d0 + idx % dcs;
    float v[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      v[r] = r < cs ? osr[r][row * C::OPITCH + d] : 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      sum += cw[row * MAX_CLUSTER + r] * v[r];
    const int gi = row / g.S, s = row % g.S;
    o[((size_t)(b * g.S + s) * g.H + c * g.G + gi) * D + d] =
        __float2bfloat16(sum * inv_sum[row]);
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

template <typename Pool, int D, int MT>
int launch(const void* q, const Pool& kp, const Pool& vp, const int* pos,
           void* o, int B, Geometry g, cudaStream_t stream) {
  using C = Config<D, MT>;
  while (g.stages > 1 && C::smem(g.stages) > MAX_SMEM) --g.stages;
  const int smem = C::smem(g.stages);
  auto* kernel = decode_kernel<Pool, D, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.KVH, B, g.nsplit);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = g.nsplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)q, kp, vp, pos,
                           (bf16*)o, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename Pool, int D>
int by_rows(const void* q, const Pool& kp, const Pool& vp, const int* pos,
            void* o, int B, const Geometry& g, cudaStream_t st) {
  if (g.R <= 16) return launch<Pool, D, 1>(q, kp, vp, pos, o, B, g, st);
  if (g.R <= 32) return launch<Pool, D, 2>(q, kp, vp, pos, o, B, g, st);
  return launch<Pool, D, 4>(q, kp, vp, pos, o, B, g, st);
}

// Shapes to a Geometry, and head_dim and rows to an instantiation. The
// nsplit splits of a (slot, kv head) are one cluster: a power of two up to
// MAX_CLUSTER. W rows per slot (a ring, or n_pages x ps).
template <typename Pool>
int dispatch(const void* q, const Pool& kp, const Pool& vp, const int* pos,
             void* o, int B, int S, int H, int KVH, int D, int W, int nsplit,
             float scale, void* stream) {
  Geometry g;
  g.S = S;
  g.H = H;
  g.KVH = KVH;
  g.G = H / KVH;
  g.R = g.G * S;
  g.W = W;
  g.nsplit = nsplit;
  g.scale_log2 = scale * 1.4426950408889634f;
  if (g.R > MAX_ROWS || g.R < 1 || nsplit < 1 || nsplit > MAX_CLUSTER ||
      (nsplit & (nsplit - 1)))
    return (int)cudaErrorInvalidValue;
  // as many stages as a split has tiles (``launch`` keeps what shared
  // memory holds)
  const int tiles = (W + BKV - 1) / BKV;
  const int per = (tiles + nsplit - 1) / nsplit;
  g.stages = per < MAX_STAGES ? per : MAX_STAGES;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return by_rows<Pool, 32>(q, kp, vp, pos, o, B, g, st);
    case 64:
      return by_rows<Pool, 64>(q, kp, vp, pos, o, B, g, st);
    case 128:
      return by_rows<Pool, 128>(q, kp, vp, pos, o, B, g, st);
    case 256:
      return by_rows<Pool, 256>(q, kp, vp, pos, o, B, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace sm90
