// One-launch split-context decode attention on Hopper (sm_90a), bfloat16,
// in two variants that share their loaders and their cluster of splits:
//   * ``decode_kernel``, an online softmax on the tensor cores, serves the
//     port of the Pallas TPU kernel
//     ``repro/kernels/decode_attention.py::decode_attention`` (TPU kernel
//     6) over bf16 rolling caches (``decode_attention.cu``, ``RingPool``);
//   * ``twin_kernel``, the twins' roundings over float64 sums, serves
//     ``::paged_decode_attention`` (TPU kernel 2) over bf16 pools
//     (``paged_decode_attention.cu``, ``PlainPool``) and
//     ``::paged_decode_attention_int8`` (TPU kernel 4) over int8 pools
//     with float32 scales (``paged_decode_attention_int8.cu``,
//     ``Int8Pool``).
// Both are templated on the pool concept of ``paged_decode.cuh``
// (``SlotRows``: a row through the slot's page-table row, or row t of a
// ring). float32 pools and rings stay on that header's three launches.
//
// For each decode slot b and kv head c, the G*S query rows that share the
// kv head (rows ordered (g, s)) attend the slot's cache rows; query s of S
// sees min(pos - (S-1) + s, W) rows. The grid is (KVH, B, nsplit): split z
// takes a contiguous run of the slot's 64-row tiles (``split_rows``), and
// the nsplit splits of one (slot, kv head), at most 8, are one
// thread-block cluster on neighbouring SMs, merged deterministically
// through distributed shared memory, in rank order, with no atomics. The
// online kernel also serves more than 64 query rows (a chunk of prefill
// over a linear buffer: granite's 64-token chunk is 256 rows, a suffix up
// to 4096): the rows are cut into groups of 64, each group its own
// cluster, folded with the slot into the grid's y (B x groups); a group
// is computed exactly as a call of its 64 rows alone would be.
//
// What bounds both: the bytes of the valid K/V rows, read once for the G
// query heads (granite: 8 slots x up to 1024 rows x 8 kv heads x 128 x 2 B
// x 2 = 33.6 MB per layer when full, half that plus 4 B a row in int8;
// recurrentgemma: 8 rings of 2048 x 256 x 2 B x 2 = 16.8 MB); the FLOPs
// are 4 * G * S per element, far below the card's rates. So both are one
// launch that keeps every intermediate on chip: Q, K and V tiles of 64
// rows come into XOR-swizzled bf16 shared tiles by 16-byte ``cp.async``
// copies (rows past the slot's last valid one are zero-filled and never
// fetched), through a ring that keeps the next tiles' copies in flight
// while one is computed. One bulk copy (TMA) per cache row instead,
// started by one warp, measured slower on the H100. int8 codes come in by
// 16-byte copies and each row's scale by a 4-byte one; a conversion pass
// writes round_to<bf16>(code * scale) into the swizzled bf16 tile,
// exactly the twin's dequantized cache.
//
// The online kernel computes S = Q K^T and O += P V on
// ``mma.sync.m16n8k16`` bf16 -> f32 with ``ldmatrix`` fragments (for S
// each warp 8 keys of the tile for all query rows, for O D / WARPS output
// columns) and rounds P = exp(s - m) to bf16 before normalization (as the
// one-pass prefill kernel ``flash_attention.cu`` does), so its output
// moves by at most one bf16 step against its twin (3.91e-3 at
// recurrentgemma's shape): each split keeps a running max, sum and O in
// registers, publishes (m, l, O), and block r merges output columns
// [r D / nsplit, ...) of every block with the weights exp(m_j - M).
//
// The twin kernel keeps the twins' roundings (``layers.paged_decode_
// attention``, ``_int8``, over bf16 caches), to which int8 decode is held
// at 1e-3: scores as one float32 FMA chain over d, the row's GLOBAL max M
// and sum L, then p = round_to<bf16>(exp(s - M) / L), P V, the output
// rounded to float32 and then bf16. L and P V are float64 sums: their
// terms (exp values, exact products of bf16 values) summed in float64 land
// where the twin's float64 sums do after the float32 rounding, whatever
// order either side sums in (the sums differ in their last float64 bits
// at most, 29 bits below a float32 step, and then 8 more below a bf16
// one); float32 sums in two orders put one output a bf16 step apart now
// and then, which at |o| >= 0.25 is past 1e-3 (seen at chatglm3's 32/2
// heads, S 4). On ``mma.sync`` the scores differed in their last bits and
// p flipped by one bf16 step, so the twin kernel stays off the tensor
// cores. One launch, blocks of 64 threads a row group of RT = 4 query
// rows up to 16 rows, else 8 (``twin_rt``; 16 past 32 rows at head_dim
// 256), with the registers that leave an SM 16 or 32 warps at every row
// count up to 64 at head_dim 128 over bf16 pools (``twin_min_blocks``):
//   A. thread t of a group takes key t of each K tile of its split and
//      runs RT independent score chains, one per query row, each over
//      d = 0, ..., D - 1 in float32, reading each K chunk once for all RT
//      rows; it keeps the scores in shared memory (``keep``) and a
//      running (m, l) of each row over its keys (one float64 exp a
//      score); the block's (m, l) of a row is their max and rescaled sum;
//   B. ``cluster.sync()``, then every block reads all ranks' (m, l)
//      through distributed shared memory and forms M = max m_j and L =
//      sum_j l_j exp(m_j - M) in rank order;
//   C. thread t forms p = round_to<bf16>(exp(s - M) / L) of its key (a
//      float64 ``exp`` and a true division) into a float64 P tile while
//      the V tile's copy lands; then thread t owns D / 64 output columns
//      of the group's RT rows (head_dim 32: 32 columns, two key halves)
//      and runs O += P V as float64 FMAs over the tile's keys, each V
//      element widened to float64 once for all RT rows (exact: a bf16
//      value is a float32 one); block r sums output columns
//      [r D / nsplit, ...) of every block's O in rank order (p is already
//      normalized: no rescaling) and writes bf16.
// What bounds it at granite's served pools (32 slots of 2.6-4k rows x 8
// kv heads, G 4): the bytes. A 64-row K and V tile pair is 32 KB, about
// 2260 SM cycles of the card's 3.35 TB/s; its work is 32768 float32 FMAs
// (256 cycles at 128 a cycle), 32768 float64 FMAs and 8192 widenings
// (512 cycles each at 64 and 16 a cycle), 512 float64 exps and 256
// divisions. Converting each product as the kernel once did (R D 64 a
// tile) cost 2048 cycles alone, and its one 173 KB block an SM left the
// card waiting on each block's chain of tiles. So the plan
// (``decode_attention.paged_plan_sm90``) keeps many small blocks on each
// SM, whose copies and arithmetic overlap one another's: at docqa's
// pools 8 splits (2048 blocks) of one ring slot each, the scores kept,
// P over Q, 26.7 KB a block, eight blocks (16 warps) an SM; a deeper
// ring costs more blocks than it hides (measured: one slot 0.289 ms a
// launch, two 0.318): the ring takes a second slot and more only while
// the SM holds as many blocks as at one (where the registers, not
// shared memory, set the blocks: 5 to 64 rows over short pools), up to
// one per event. The ring issues the
// first V tile while phases A and B finish. A split whose scores do not
// fit (``keep`` 0: long contexts at many query rows) computes its scores
// again in C from a second read of K. The ring's events are K tiles in A, then V tiles (or
// K then V tiles) in C.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "paged_decode.cuh"
#include "tensor_core.cuh"

namespace sm90 {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int BKV = 64;         // cache rows per K/V tile
constexpr int MAX_CLUSTER = 8;   // splits per (slot, kv head): one cluster
constexpr int MAX_ROWS = 64;     // G * S query rows per block (a group)
constexpr int MAX_STAGES = 3;    // ring stages of the online kernel
constexpr int MAX_RING = 8;      // ring slots of the twin kernel
constexpr int MAX_SMEM = 232448;  // a block's shared memory on sm_90

// A pool whose rows are int8 codes and a float32 scale (``Row`` a struct
// of both pointers), not bf16 elements (``Row`` a pointer).
template <typename Pool>
constexpr bool kCodes = !std::is_pointer<typename Pool::Row>::value;

struct Geometry {
  int S, H, KVH, G, R, W, n_pages, ps, nsplit, stages;
  int ngroups;  // groups of up to MAX_ROWS of the R rows (the twin: 1)
  int keep, per;  // twin kernel: scores kept in shared memory; tiles a split
  float scale;       // d^-1/2
  float scale_log2;  // d^-1/2 log2(e): the online kernel's exp2 domain
};

__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Wait until at most n (0..7) of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
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

// Q rows r0 + r (r < R; row gi * S + s) of (slot b, kv head c) into the
// swizzled tile (zeros from R to RP); the caller commits the group.
template <int D, int RP, int THREADS>
__device__ __forceinline__ void load_q(uint4* qs, const bf16* q, int b,
                                       int c, int r0, int R,
                                       const Geometry& g) {
  constexpr int CPR = D / 8;
  for (int idx = threadIdx.x; idx < RP * CPR; idx += THREADS) {
    const int r = idx / CPR, ch = idx % CPR;
    const bool ok = r < R;
    const bf16* src = q;
    if (ok) {
      const int gi = (r0 + r) / g.S, s = (r0 + r) % g.S;
      src = q + ((size_t)(b * g.S + s) * g.H + c * g.G + gi) * D + ch * 8;
    }
    cp_async16(qs + swizzle<CPR>(r, ch), src, ok);
  }
}

// Start the copies of 64 rows of a pool (``rows``) into a ring slot, rows
// past the slot's last valid one as zeros, never fetched: bf16 rows
// straight into the swizzled tile ``ldmatrix`` reads; int8 codes ([64][D]
// bytes) and their scales ([64] floats after them) as they lie, for
// ``convert_tile``. ``dummy`` is any mapped address.
template <typename Pool, int D, int THREADS>
__device__ __forceinline__ void issue_tile(unsigned char* slot,
                                           const paged::SlotRows<Pool>& rows,
                                           const void* dummy) {
  const int tid = threadIdx.x;
  if constexpr (!kCodes<Pool>) {
    constexpr int CPR = D / 8, N = BKV * CPR;
    uint4* dst = reinterpret_cast<uint4*>(slot);
#pragma unroll
    for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      if (N % THREADS != 0 && idx >= N) break;
      const int r = idx / CPR, ch = idx % CPR;
      const bf16* row = rows(r);
      cp_async16(dst + swizzle<CPR>(r, ch),
                 row != nullptr ? (const void*)(row + ch * 8) : dummy,
                 row != nullptr);
    }
  } else {
    constexpr int C16 = D / 16;  // 16-byte chunks of codes per row
    constexpr int N16 = BKV * C16;
#pragma unroll
    for (int i = 0; i < (N16 + THREADS - 1) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      if (N16 % THREADS != 0 && idx >= N16) break;
      const int r = idx / C16, ch = idx % C16;
      const auto row = rows(r);
      cp_async16(slot + r * D + ch * 16,
                 row.v != nullptr ? (const void*)(row.v + ch * 16) : dummy,
                 row.v != nullptr);
    }
    float* sc = reinterpret_cast<float*>(slot + BKV * D);
    for (int r = tid; r < BKV; r += THREADS) {
      const auto row = rows(r);
      cp_async4(sc + r, row.s != nullptr ? (const void*)row.s : dummy,
                row.s != nullptr);
    }
  }
}

// A slot of int8 codes and scales to the swizzled bf16 tile: each element
// round_to<bf16>(code * scale), one float32 product rounded to nearest
// even, as the twin dequantizes its cache.
template <int D, int THREADS>
__device__ __forceinline__ void convert_tile(const unsigned char* slot,
                                             uint4* dst) {
  constexpr int CPR = D / 8, N = BKV * CPR;
  const float* sc = reinterpret_cast<const float*>(slot + BKV * D);
  auto code = [](uint32_t w, int e) {
    return (float)(int8_t)(uint8_t)(w >> (8 * e));
  };
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    if (N % THREADS != 0 && idx >= N) break;
    const int r = idx / CPR, ch = idx % CPR;
    const uint2 c = *reinterpret_cast<const uint2*>(slot + r * D + ch * 8);
    const float s = sc[r];
    uint4 out;
    out.x = pack_bf16(code(c.x, 0) * s, code(c.x, 1) * s);
    out.y = pack_bf16(code(c.x, 2) * s, code(c.x, 3) * s);
    out.z = pack_bf16(code(c.y, 0) * s, code(c.y, 1) * s);
    out.w = pack_bf16(code(c.y, 2) * s, code(c.y, 3) * s);
    dst[swizzle<CPR>(r, ch)] = out;
  }
}

// S = Q K^T of one 64-row K tile on the tensor cores: this warp's keys
// 8 (warp + WARPS i) .. + 7 for all RP = 16 MT query rows, in the
// accumulator layout (rows mt * 16 + g (+ 8), keys 2 t (+ 1)).
template <int D, int MT, int WARPS>
__device__ __forceinline__ void qk_tile(const uint4* qs, const uint4* ks,
                                        float (&sc)[MT][BKV / 8 / WARPS][4]) {
  constexpr int CPR = D / 8, NPW = BKV / 8 / WARPS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NPW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[mt][i][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; kk += 2) {
    uint32_t bk[NPW][4];  // k-steps kk ({0, 1}) and kk + 1 ({2, 3})
#pragma unroll
    for (int i = 0; i < NPW; ++i)
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
      for (int i = 0; i < NPW; ++i) {
        mma_bf16(sc[mt][i], a0, bk[i]);
        mma_bf16(sc[mt][i], a1, bk[i] + 2);
      }
    }
  }
}

// O += P V of one 64-row V tile: P [RP][64] bf16 in ``ps``, this warp's
// output columns (pairs of 8-column tiles warp * DPW / 2 + dp).
template <int D, int MT, int WARPS>
__device__ __forceinline__ void pv_tile(const uint4* ps, const uint4* vs,
                                        float (&acc)[MT][D / 8 / WARPS][4]) {
  constexpr int CPR = D / 8, DPW = D / 8 / WARPS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
    for (int dp = 0; dp < DPW / 2; ++dp) {
      const int pair = warp * (DPW / 2) + dp;
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
              const int* __restrict__ table, const int* __restrict__ pos,
              bf16* __restrict__ o, Geometry g) {
  using C = Config<D, MT>;
  constexpr int RP = C::RP, WARPS = C::WARPS;
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
  const int c = blockIdx.x, split = blockIdx.z;
  // the slot and the group's rows [r0, r0 + R)
  const int b = blockIdx.y / g.ngroups;
  const int r0 = (blockIdx.y % g.ngroups) * MAX_ROWS;
  const int R = min(g.R - r0, MAX_ROWS);
  const int p = pos[b];
  const int nmax = min(p, g.W);
  // the fewest rows a query of the group sees: its smallest s (0 when the
  // group's rows wrap past a head's S queries)
  const int s_min = r0 % g.S + R <= g.S ? r0 % g.S : 0;
  const int lim0 = min(p - (g.S - 1) + s_min, g.W);
  int t_begin, t_end;
  split_rows(nmax, g.nsplit, split, t_begin, t_end);
  const int n_tiles = (t_end - t_begin + BKV - 1) / BKV;
  const int stages = g.stages;
  const int* trow = paged::table_row(table, b, g.n_pages);

  // Q in the first commit group
  load_q<D, RP, C::THREADS>(qs, q, b, c, r0, R, g);
  // 64 rows of a pool from row t0 of the slot; rows past nmax as zeros
  auto load = [&](uint4* dst, const Pool& pool, int t0) {
    issue_tile<Pool, D, C::THREADS>(
        reinterpret_cast<unsigned char*>(dst),
        paged::SlotRows<Pool>{pool, trow, b, g.ps, c, t0, nmax}, q);
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
    cp_async_wait_dyn(2 * stages - 1);
    __syncthreads();

    float sc[MT][C::NPW][4];
    qk_tile<D, MT, WARPS>(qs, ks, sc);

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
            const int s = (r0 + mt * 16 + gq + 8 * (e >> 1)) % g.S;
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
    cp_async_wait_dyn(2 * stages - 2);  // V_j, group 2j + 1
    __syncthreads();

    pv_tile<D, MT, WARPS>(ps, vs, acc);
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
  for (int row = tid; row < R; row += C::THREADS) {
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
  for (int idx = tid; idx < R * dcs; idx += C::THREADS) {
    const int row = idx / dcs, d = d0 + idx % dcs;
    float v[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      v[r] = r < cs ? osr[r][row * C::OPITCH + d] : 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      sum += cw[row * MAX_CLUSTER + r] * v[r];
    const int gi = (r0 + row) / g.S, s = (r0 + row) % g.S;
    o[((size_t)(b * g.S + s) * g.H + c * g.G + gi) * D + d] =
        __float2bfloat16(sum * inv_sum[row]);
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

// ---- the twin-order kernel -------------------------------------------

__device__ __forceinline__ double warp_sum_f64(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& w, float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(u[k] << 16);
    f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
  }
}

// Its blocks: the G * S query rows padded to RP = 4, 8, 16, 32 or 64
// (``twin_rp``), in row groups of RT rows (``twin_rt``: 4 up to 16 rows,
// else 8; 16 past 32 rows at head_dim 256), 64 threads a group; the shared-memory layout, in
// bytes: per-split l and global L [RP] float64 each, per-split m and
// global M [RP] float32 each (which other blocks of the cluster read) | Q
// [RP][D] float32, and in its place in C (``keep``) P of one V tile [64]
// [RP] float64 | int8 only: the converted K or V tile [64][D] bf16 |
// ``keep``: the scores [RP][64 per] float32, else P | the ring,
// ``stages`` slots of one tile each. After C the published O [KG][RP][D +
// 2] float64 lies over everything past the statistics.
// ``decode_attention.sm90_smem`` in Python mirrors it.
__host__ __device__ constexpr int twin_rp(int rows) {
  return rows <= 4 ? 4 : rows <= 8 ? 8 : rows <= 16 ? 16 : rows <= 32 ? 32
                                                                       : 64;
}
__host__ __device__ constexpr int twin_rt(int d, int rp) {
  return rp <= 16 ? 4 : rp <= 32 || d <= 128 ? 8 : 16;
}
__host__ __device__ constexpr int twin_kg(int d) { return d < 64 ? 64 / d : 1; }
__host__ __device__ constexpr int twin_slot(bool codes, int d) {
  return codes ? BKV * d + BKV * 4 : BKV * d * 2;
}
__host__ __device__ constexpr int twin_stats(int rp) { return rp * 24; }
__host__ __device__ constexpr int twin_q_bytes(int d, int rp, int keep) {
  return keep && BKV * rp * 8 > rp * d * 4 ? BKV * rp * 8 : rp * d * 4;
}
__host__ __device__ constexpr int twin_scs_off(bool codes, int d, int rp,
                                               int keep) {
  return twin_stats(rp) + twin_q_bytes(d, rp, keep) +
         (codes ? BKV * d * 2 : 0);
}
__host__ __device__ constexpr int twin_pd_off(bool codes, int d, int rp,
                                              int keep) {
  return keep ? twin_stats(rp) : twin_scs_off(codes, d, rp, keep);
}
__host__ __device__ constexpr int twin_ring_off(bool codes, int d, int rp,
                                                int per, int keep) {
  return twin_scs_off(codes, d, rp, keep) +
         (keep ? rp * per * BKV * 4 : BKV * rp * 8);
}
__host__ __device__ constexpr int twin_smem(bool codes, int d, int rows,
                                            int per, int keep, int stages) {
  const int rp = twin_rp(rows);
  const int work = twin_ring_off(codes, d, rp, per, keep) - twin_stats(rp) +
                   stages * twin_slot(codes, d);
  const int obytes = twin_kg(d) * rp * (d + 2) * 8;
  return twin_stats(rp) + (work > obytes ? work : obytes);
}

// Blocks an SM the registers must allow: 64 registers a thread at 4 rows
// a thread in blocks of 2 or 4 row groups (5 to 16 rows: 32 warps an
// SM), 128 at 4 rows in 64-thread blocks and at 8 rows (16 warps: eight
// 64-thread blocks at the served pools, as the plan's shared memory
// allows, two of 256 threads at 32 rows, one of 512 at 64), all 255 at
// head_dim 256 and at 16 rows, whose float64 sums need them. Over int8
// pools a 64-thread block takes 168 (its conversion pass spilled at 128:
// chip_smoke's short shape, S 1, 0.0370 ms against 0.0335 at 168).
template <int D, int RT, int MT, bool CODES>
constexpr int twin_min_blocks() {
  constexpr int regs = D > 128 || RT > 8      ? 255
                       : RT == 4 && MT > 1    ? 64
                       : CODES && MT == 1     ? 168
                                              : 128;
  constexpr int n = 65536 / (regs * 64 * MT);
  return n > 1 ? n : 1;
}

// The scores of this thread's key (row ``key`` of the K tile ``ks``)
// for RT query rows (float32 Q [RT][D] in ``qf``): RT independent chains,
// each one float32 FMA chain over d = 0, 1, ..., D - 1, the twin's
// float32 product bit for bit (bf16 products are exact); the K chunk is
// read once for all RT rows.
template <int D, int RT>
__device__ __forceinline__ void score_chains(const float* qf, const uint4* ks,
                                             int key, float (&acc)[RT]) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int i = 0; i < RT; ++i) acc[i] = 0.0f;
#pragma unroll 2
  for (int ch = 0; ch < CPR; ++ch) {
    float kf[8];
    unpack_bf16x8(ks[swizzle<CPR>(key, ch)], kf);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4* qv = reinterpret_cast<const float4*>(qf + i * D) + 2 * ch;
      const float4 a = qv[0], b = qv[1];
      const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i] = fmaf(x[e], kf[e], acc[i]);
    }
  }
}

// One score into this thread's running (m, l) of its row: l the float64
// sum of exp(s - m) over the row's scores so far, rescaled when m grows
// (one exp a score either way); masked scores change nothing.
__device__ __forceinline__ void online_stat(float x, float& m, double& l) {
  if (x != -INFINITY) {
    const bool up = x > m;
    const double e = exp(up ? (double)m - (double)x : (double)x - (double)m);
    l = up ? l * e + 1.0 : l + e;
    m = up ? x : m;
  }
}

// CPT bf16 values of V row t from column c0 (a 2-, 4- or 8-byte load of
// the swizzled tile), each widened to float64 once, exactly.
template <int D, int CPT>
__device__ __forceinline__ void load_v(const uint4* vs, int t, int c0,
                                       double (&v)[CPT]) {
  constexpr int CPR = D / 8;
  const unsigned char* chunk = reinterpret_cast<const unsigned char*>(
      vs + swizzle<CPR>(t, c0 / 8));
  if constexpr (CPT == 1) {
    const uint32_t h =
        reinterpret_cast<const unsigned short*>(chunk)[c0 % 8];
    v[0] = (double)__uint_as_float(h << 16);
  } else if constexpr (CPT == 2) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(chunk)[(c0 % 8) / 2];
    v[0] = (double)__uint_as_float(w << 16);
    v[1] = (double)__uint_as_float(w & 0xffff0000u);
  } else {
    const uint2 w = reinterpret_cast<const uint2*>(chunk)[(c0 % 8) / 4];
    v[0] = (double)__uint_as_float(w.x << 16);
    v[1] = (double)__uint_as_float(w.x & 0xffff0000u);
    v[2] = (double)__uint_as_float(w.y << 16);
    v[3] = (double)__uint_as_float(w.y & 0xffff0000u);
  }
}

// O += P V of one V tile for this thread's RT rows and CPT columns from
// c0, over its key group's keys: P float64 (bf16 values) in pd[t][RP]
// (``pd`` at the group's first row), each output a float64 FMA chain of
// exact products, each V element widened once for all RT rows.
template <int D, int RT, int RP, int CPT, int KG>
__device__ __forceinline__ void pv_f64(const double* pd, const uint4* vs,
                                       double (&acc)[RT][CPT], int c0,
                                       int kg) {
  constexpr int KEYS = BKV / KG;
#pragma unroll 4
  for (int k = 0; k < KEYS; ++k) {
    const int t = kg * KEYS + k;
    double v[CPT];
    load_v<D, CPT>(vs, t, c0, v);
    const double2* pr = reinterpret_cast<const double2*>(pd + t * RP);
#pragma unroll
    for (int i = 0; i < RT / 2; ++i) {
      const double2 pp = pr[i];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        acc[2 * i][cc] = fma(pp.x, v[cc], acc[2 * i][cc]);
        acc[2 * i + 1][cc] = fma(pp.y, v[cc], acc[2 * i + 1][cc]);
      }
    }
  }
}

template <typename Pool, int D, int RT, int MT>
__global__ void __launch_bounds__(64 * MT,
                                  twin_min_blocks<D, RT, MT, kCodes<Pool>>())
twin_kernel(const bf16* __restrict__ q, Pool kp, Pool vp,
            const int* __restrict__ table, const int* __restrict__ pos,
            bf16* __restrict__ o, Geometry g) {
  constexpr bool CODES = kCodes<Pool>;
  constexpr int THREADS = 64 * MT, RP = RT * MT, WARPS = THREADS / 32;
  constexpr int SLOT = twin_slot(CODES, D);
  constexpr int KG = twin_kg(D);  // key groups of P V (head_dim 32: 2)
  constexpr int CPT = D * KG / 64;  // P V columns a thread: 1, 2 or 4
  constexpr int OP = D + 2;         // doubles per published O row
  extern __shared__ uint4 sm90_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(sm90_smem);
  // [RP] float64: this split's row sum of exp(s - max), the row's sum
  double* pl = reinterpret_cast<double*>(sm);
  double* gl = pl + RP;
  float* pm = reinterpret_cast<float*>(gl + RP);  // [RP] this split's max
  float* gm = pm + RP;  // [RP] the row's global max
  float* qf = gm + RP;  // Q [RP][D]
  uint4* conv = reinterpret_cast<uint4*>(  // int8: the K or V tile
      sm + twin_stats(RP) + twin_q_bytes(D, RP, g.keep));
  float* scs =
      reinterpret_cast<float*>(sm + twin_scs_off(CODES, D, RP, g.keep));
  double* pd = reinterpret_cast<double*>(
      sm + twin_pd_off(CODES, D, RP, g.keep));  // P [64][RP]
  unsigned char* ring = sm + twin_ring_off(CODES, D, RP, g.per, g.keep);
  // [KG][RP][OP] after C, over Q and everything after it
  double* os = reinterpret_cast<double*>(qf);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's key of a tile (A) or column unit (C), and row group
  const int u = tid & 63, r0 = (tid >> 6) * RT;
  const int c = blockIdx.x, b = blockIdx.y;
  const int p = pos[b];
  const int nmax = min(p, g.W);
  int t_begin, t_end;
  split_rows(nmax, g.nsplit, blockIdx.z, t_begin, t_end);
  const int T = (t_end - t_begin + BKV - 1) / BKV;
  const bool keep = g.keep != 0;
  const int E = (keep ? 2 : 3) * T;  // ring events of this split
  const int stages = g.stages;
  const int spitch = g.per * BKV;  // keep: floats per row of the scores
  const int* trow = paged::table_row(table, b, g.n_pages);

  // ---- the ring: event e < T is K tile e (A); then V tile j (keep) or
  // K tile j, V tile j (recompute) (C); slot e % stages. Event e is
  // commit group e; one group is committed for each event consumed, so
  // stages - 1 groups may be in flight at acquire ----
  auto slot = [&](int e) { return ring + (e % stages) * SLOT; };
  auto issue = [&](int e) {
    if (e < E) {
      int j = e;
      bool v = false;
      if (e >= T) {
        j = e - T;
        v = keep || (j & 1);
        if (!keep) j >>= 1;
      }
      issue_tile<Pool, D, THREADS>(
          slot(e),
          paged::SlotRows<Pool>{v ? vp : kp, trow, b, g.ps, c,
                                t_begin + j * BKV, nmax},
          q);
    }
    cp_async_commit();
  };
  // Event e's bf16 tile; int8: converted into ``conv`` (every read of the
  // previous tile there is behind the barrier below), its slot refilled
  // at once. A bf16 slot is refilled by ``release`` once every warp is
  // past a barrier after its last read.
  auto acquire = [&](int e) -> const uint4* {
    cp_async_wait_dyn(stages - 1);
    __syncthreads();
    if constexpr (CODES) {
      convert_tile<D, THREADS>(slot(e), conv);
      __syncthreads();
      issue(e + stages);
      return conv;
    } else {
      return reinterpret_cast<const uint4*>(slot(e));
    }
  };
  auto release = [&](int e) {
    if constexpr (!CODES) issue(e + stages);
  };
  // this thread's scaled, masked scores of K tile j (in ``ks``): row
  // r0 + i sees min(pos - (S-1) + s, W) keys; padded rows see none
  auto scores = [&](const uint4* ks, int j, float (&x)[RT]) {
    score_chains<D, RT>(qf + r0 * D, ks, u, x);
    const int t = t_begin + j * BKV + u;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = r0 + i;
      const int lim = r < g.R ? min(p - (g.S - 1) + r % g.S, g.W) : 0;
      x[i] = t < lim ? x[i] * g.scale : -INFINITY;
    }
  };

  // the first copies, then Q as float32 (padded rows zero)
  for (int e = 0; e < stages; ++e) issue(e);
  for (int idx = tid; idx < RP * D; idx += THREADS) {
    const int r = idx / D, gi = r / g.S, s = r % g.S;
    qf[idx] = r < g.R ? __bfloat162float(q[((size_t)(b * g.S + s) * g.H +
                                            c * g.G + gi) * D + idx % D])
                      : 0.0f;
  }

  // ---- A: scores (kept in shared memory, by and for this thread), and
  // this thread's running (m, l) of each of its rows over its keys ----
  float m_t[RT];
  double l_t[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m_t[i] = -INFINITY;
    l_t[i] = 0.0;
  }
  for (int j = 0; j < T; ++j) {
    const uint4* ks = acquire(j);
    float x[RT];
    scores(ks, j, x);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      if (keep) scs[(r0 + i) * spitch + j * BKV + u] = x[i];
      online_stat(x[i], m_t[i], l_t[i]);
    }
    if constexpr (!CODES) {
      __syncthreads();  // every warp is done with K
      release(j);
    }
  }
  __syncthreads();  // every warp is done with Q (``keep``: P lies there)
  // the split's (m, l) of each row: its group's max, then the threads'
  // sums rescaled to it, summed (a float64 sum: any order, see the note)
  float* redm = reinterpret_cast<float*>(pd);         // [WARPS][RT]
  double* redl = pd + WARPS * RT;                     // [WARPS][RT]
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const float mx = warp_max(m_t[i]);
    if (lane == 0) redm[warp * RT + i] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int w0 = (warp & ~1) * RT + i;
    const float mb = fmaxf(redm[w0], redm[w0 + RT]);
    double l = m_t[i] == -INFINITY
                   ? 0.0
                   : l_t[i] * exp((double)m_t[i] - (double)mb);
    l = warp_sum_f64(l);
    if (lane == 0) redl[warp * RT + i] = l;
  }
  __syncthreads();
  for (int r = tid; r < RP; r += THREADS) {
    const int w0 = (r / RT) * 2 * RT + r % RT;
    pm[r] = fmaxf(redm[w0], redm[w0 + RT]);
    pl[r] = redl[w0] + redl[w0 + RT];
  }

  // ---- B: every rank's (m, l) of a row through distributed shared
  // memory, all loads in flight at once; the row's M and L in rank order
  // (ranks past cs count as empty) ----
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  cl.sync();
  for (int row = tid; row < g.R; row += THREADS) {
    float mr[MAX_CLUSTER];
    double lr[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) {
      mr[r] = r < cs ? *cl.map_shared_rank(pm + row, r) : -INFINITY;
      lr[r] = r < cs ? *cl.map_shared_rank(pl + row, r) : 0.0;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) mx = fmaxf(mx, mr[r]);
    double l = 0.0;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (lr[r] > 0.0) l += lr[r] * exp((double)mr[r] - (double)mx);
    gm[row] = mx;
    gl[row] = l;
  }
  __syncthreads();

  // ---- C: this thread's p = round_to<bf16>(exp(s - M) / L) of its key
  // into P (float64), then O += P V by column units ----
  const int kg = u / (64 / KG), c0 = (u % (64 / KG)) * CPT;
  double acc[RT][CPT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.0;
  for (int j = 0; j < T; ++j) {
    int e = T + (keep ? j : 2 * j);
    float x[RT];
    if (keep) {
#pragma unroll
      for (int i = 0; i < RT; ++i) x[i] = scs[(r0 + i) * spitch + j * BKV + u];
    } else {
      scores(acquire(e), j, x);
      if constexpr (!CODES) {
        __syncthreads();  // every warp is done with K
        release(e);
      }
      ++e;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int r = r0 + i;
      pd[u * RP + r] =
          x[i] == -INFINITY
              ? 0.0
              : (double)round_to<bf16>(__double2float_rn(
                    exp((double)x[i] - (double)gm[r]) / gl[r]));
    }
    const uint4* vs = acquire(e);  // its barrier also makes P whole
    pv_f64<D, RT, RP, CPT, KG>(pd + r0, vs, acc, c0, kg);
    __syncthreads();  // every warp is done with P and the V tile
    release(e);
  }
  cp_async_wait<0>();
  __syncthreads();  // Q, the tiles, P and the ring are free for O

  // ---- merge: block ``rank`` sums output columns [rank D / cs, ...) of
  // every rank's O (key groups, then ranks, in order) and writes them ----
#pragma unroll
  for (int i = 0; i < RT; ++i)
    if (r0 + i < g.R)
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc)
        os[(kg * RP + r0 + i) * OP + c0 + cc] = acc[i][cc];
  cl.sync();
  const int dcs = D / cs, d0 = rank * dcs;
  const double* osr[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    osr[r] = cl.map_shared_rank(os, r < cs ? r : 0);
  for (int idx = tid; idx < g.R * dcs; idx += THREADS) {
    const int row = idx / dcs, d = d0 + idx % dcs;
    double v[MAX_CLUSTER][KG];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
#pragma unroll
      for (int k = 0; k < KG; ++k)
        v[r][k] = r < cs ? osr[r][(k * RP + row) * OP + d] : 0.0;
    double sum = 0.0;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
#pragma unroll
      for (int k = 0; k < KG; ++k) sum += v[r][k];
    const int gi = row / g.S, s = row % g.S;
    // float64 -> float32 -> bf16, as the twin's conversions round
    o[((size_t)(b * g.S + s) * g.H + c * g.G + gi) * D + d] =
        __float2bfloat16(__double2float_rn(sum));
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

// One launch of ``kernel`` on the (KVH, B x groups, nsplit) grid, the
// nsplit splits of a (slot, kv head, group) one cluster.
template <typename Kernel, typename Pool>
int launch_cluster(Kernel kernel, int threads, int smem, const void* q,
                   const Pool& kp, const Pool& vp, const int* table,
                   const int* pos, void* o, int B, const Geometry& g,
                   cudaStream_t stream) {
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.KVH, B * g.ngroups, g.nsplit);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = g.nsplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const bf16*)q, kp, vp, table, pos,
                           (bf16*)o, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The online kernel with as many stages as fit.
template <typename Pool, int D, int MT>
int launch(const void* q, const Pool& kp, const Pool& vp, const int* table,
           const int* pos, void* o, int B, Geometry g, cudaStream_t stream) {
  using C = Config<D, MT>;
  while (g.stages > 1 && C::smem(g.stages) > MAX_SMEM) --g.stages;
  return launch_cluster(decode_kernel<Pool, D, MT>, C::THREADS,
                        C::smem(g.stages), q, kp, vp, table, pos, o, B, g,
                        stream);
}

// The twin-order kernel at RT rows a row group, MT groups, and its layout.
template <typename Pool, int D, int RT, int MT>
int launch_twin(const void* q, const Pool& kp, const Pool& vp,
                const int* table, const int* pos, void* o, int B,
                const Geometry& g, cudaStream_t stream) {
  return launch_cluster(
      twin_kernel<Pool, D, RT, MT>, 64 * MT,
      twin_smem(kCodes<Pool>, D, g.R, g.per, g.keep, g.stages), q, kp, vp,
      table, pos, o, B, g, stream);
}

// Blocks of the twin-order kernel one SM holds at ``smem`` bytes, as the
// runtime counts them (shared memory, registers, threads); -1 on error.
template <typename Pool, int D, int RT, int MT>
int twin_occupancy(int smem) {
  auto kernel = twin_kernel<Pool, D, RT, MT>;
  int n = 0;
  if (smem > MAX_SMEM ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 64 * MT,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

// f(RT, MT) (``std::integral_constant``s) at the instantiation of R query
// rows: padded as ``twin_rp``, in ``twin_rt`` groups.
template <int D, typename F>
int by_twin_rows(int R, F&& f) {
  using std::integral_constant;
  constexpr int RT4 = twin_rt(D, 4), RT8 = twin_rt(D, 8),
                RT16 = twin_rt(D, 16), RT32 = twin_rt(D, 32),
                RT64 = twin_rt(D, 64);
  if (R <= 4)
    return f(integral_constant<int, RT4>{}, integral_constant<int, 4 / RT4>{});
  if (R <= 8)
    return f(integral_constant<int, RT8>{}, integral_constant<int, 8 / RT8>{});
  if (R <= 16)
    return f(integral_constant<int, RT16>{},
             integral_constant<int, 16 / RT16>{});
  if (R <= 32)
    return f(integral_constant<int, RT32>{},
             integral_constant<int, 32 / RT32>{});
  return f(integral_constant<int, RT64>{}, integral_constant<int, 64 / RT64>{});
}

template <typename Pool>
int twin_blocks_per_sm(int D, int R, int smem) {
  auto occ = [&](auto d) {
    return by_twin_rows<decltype(d)::value>(R, [&](auto rt, auto mt) {
      return twin_occupancy<Pool, decltype(d)::value, decltype(rt)::value,
                            decltype(mt)::value>(smem);
    });
  };
  switch (D) {
    case 32: return occ(std::integral_constant<int, 32>{});
    case 64: return occ(std::integral_constant<int, 64>{});
    case 128: return occ(std::integral_constant<int, 128>{});
    case 256: return occ(std::integral_constant<int, 256>{});
    default: return -1;
  }
}

template <bool TWIN, typename Pool, int D>
int by_rows(const void* q, const Pool& kp, const Pool& vp, const int* table,
            const int* pos, void* o, int B, const Geometry& g,
            cudaStream_t st) {
  if constexpr (TWIN) {
    return by_twin_rows<D>(g.R, [&](auto rt, auto mt) {
      return launch_twin<Pool, D, decltype(rt)::value, decltype(mt)::value>(
          q, kp, vp, table, pos, o, B, g, st);
    });
  } else {
    if (g.R <= 16)  // one group
      return launch<Pool, D, 1>(q, kp, vp, table, pos, o, B, g, st);
    if (g.R <= 32)
      return launch<Pool, D, 2>(q, kp, vp, table, pos, o, B, g, st);
    return launch<Pool, D, 4>(q, kp, vp, table, pos, o, B, g, st);
  }
}

// Shapes to a Geometry, and head_dim and rows to an instantiation. The
// nsplit splits of a (slot, kv head, group) are one cluster: a power of
// two up to MAX_CLUSTER. W = n_pages x ps rows per slot (a ring: one page
// of W rows, no table). ``max_rows``: the rows the kernel takes (the twin
// kernel one group of MAX_ROWS).
inline int geometry(Geometry& g, int B, int S, int H, int KVH, int n_pages,
                    int ps, int nsplit, float scale, int max_rows) {
  g.S = S;
  g.H = H;
  g.KVH = KVH;
  g.G = H / KVH;
  g.R = g.G * S;
  g.n_pages = n_pages;
  g.ps = ps;
  g.W = n_pages * ps;
  g.nsplit = nsplit;
  g.keep = 0;
  g.per = 0;
  g.scale = scale;
  g.scale_log2 = scale * 1.4426950408889634f;
  g.ngroups = (g.R + MAX_ROWS - 1) / MAX_ROWS;
  if (g.R > max_rows || g.R < 1 || nsplit < 1 || nsplit > MAX_CLUSTER ||
      (nsplit & (nsplit - 1)) || (long long)B * g.ngroups > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool TWIN, typename Pool>
int by_head_dim(const void* q, const Pool& kp, const Pool& vp,
                const int* table, const int* pos, void* o, int B, int D,
                const Geometry& g, cudaStream_t st) {
  switch (D) {
    case 32:
      return by_rows<TWIN, Pool, 32>(q, kp, vp, table, pos, o, B, g, st);
    case 64:
      return by_rows<TWIN, Pool, 64>(q, kp, vp, table, pos, o, B, g, st);
    case 128:
      return by_rows<TWIN, Pool, 128>(q, kp, vp, table, pos, o, B, g, st);
    case 256:
      return by_rows<TWIN, Pool, 256>(q, kp, vp, table, pos, o, B, g, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The online kernel over rings of W rows.
template <typename Pool>
int dispatch(const void* q, const Pool& kp, const Pool& vp, const int* pos,
             void* o, int B, int S, int H, int KVH, int D, int W, int nsplit,
             float scale, void* stream) {
  Geometry g;
  int err = geometry(g, B, S, H, KVH, 1, W, nsplit, scale, 1 << 30);
  if (err) return err;
  // as many stages as a split has tiles (``launch`` keeps what shared
  // memory holds)
  const int tiles = (W + BKV - 1) / BKV;
  const int per = (tiles + nsplit - 1) / nsplit;
  g.stages = per < MAX_STAGES ? per : MAX_STAGES;
  return by_head_dim<false>(q, kp, vp, nullptr, pos, o, B, D, g,
                            (cudaStream_t)stream);
}

// The 64-row tiles of a split of W rows over nsplit.
inline int tiles_per_split(int W, int nsplit) {
  return ((W + BKV - 1) / BKV + nsplit - 1) / nsplit;
}

// The twin-order kernel over paged pools: the plan (nsplit, keep,
// stages) is ``decode_attention.paged_plan_sm90``'s.
template <typename Pool>
int dispatch_twin(const void* q, const Pool& kp, const Pool& vp,
                  const int* table, const int* pos, void* o, int B, int S,
                  int H, int KVH, int D, int n_pages, int ps, int nsplit,
                  int keep, int stages, float scale, void* stream) {
  Geometry g;
  int err = geometry(g, B, S, H, KVH, n_pages, ps, nsplit, scale, MAX_ROWS);
  if (err) return err;
  if (stages < 1 || stages > MAX_RING || (keep != 0 && keep != 1))
    return (int)cudaErrorInvalidValue;
  g.keep = keep;
  g.stages = stages;
  g.per = tiles_per_split(g.W, nsplit);
  return by_head_dim<true>(q, kp, vp, table, pos, o, B, D, g,
                           (cudaStream_t)stream);
}

}  // namespace sm90
