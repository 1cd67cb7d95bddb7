// The routed experts of a MoE layer over its token-sorted rows, for Hopper
// (sm_90a): one grouped product per launch over every expert at once. It
// replaces no TPU kernel: the reference's MoE is plain jnp (einsums over a
// capacity buffer), and the port's token-sorted prefill ran a host loop over
// the experts, two products, the activation, the multiply, the down product
// and a copy for each, after reading the per-expert counts to the host.
//
// The rows are the (token, expert) pairs sorted by expert (a stable sort):
// row p belongs to pair order[p], token order[p] / k, and expert e owns rows
// [offsets[e], offsets[e + 1]). Two launches a layer:
//   1. h[p] = act(x[tok] w_gate[e]) * (x[tok] w_up[e]), or gelu(x[tok]
//      w_up[e]) without a gate: both products of a tile in one block, the
//      activation and the multiply on the float32 accumulators, h (R, ff)
//      written once in bf16. The block gathers x's rows itself through
//      ``order``, so the (R, d) copy of the rows is never made.
//   2. ys[p] = h[p] w_down[e], (R, d) in bf16.
// The offsets stay on the device: the grid is sized from shapes the host
// knows (``tiles``, at most floor((R + E (BM - 1)) / BM) row tiles, times
// the column tiles), each block finds its expert and row tile by a warp's
// scan over the offsets, and a block past the last tile returns at once.
//
// What bounds it on the H100: the expert weights' read at prefill lengths.
// At granite-4.0-h's widths (E 72, top 10, d 4096, ff 768) and 1792
// tokens, an expert averages 249 rows, 249 FLOP a weight byte against the
// card's ~295: each of a layer's 72 x 18.9 MB of weights should come from
// device memory once. The tiles are ordered expert by expert with the
// column tiles of one row tile adjacent, so an expert's row tiles, and a
// row tile's column tiles, run at the same time and L2 serves their
// re-reads of a weight slice and of x's rows.
//
// The design: a block is two warpgroups, each computing 64 output columns
// for BM rows (BM 64 or 128, by the mean rows an expert gets: fewer padded
// rows in an expert's last tile when it gets few). y^T = w^T x^T on
// ``wgmma``: the weight is the A operand, loaded from a row-major [k][n]
// tile in shared memory by ``ldmatrix .trans`` into registers, the rows the
// B operand, read by ``wgmma`` through a descriptor from the 128-byte
// swizzle (K-major, as int8_matmul.cu's prefill tile). A ring of 4 stages
// of 64 k rows, filled by 16-byte ``cp.async`` copies (zeros past the
// tile's rows, K and N), keeps 3 tiles in flight. The output tile is staged
// through shared memory and written by 16-byte stores.
//
// Numerics: float32 accumulation; launch 1 rounds h once (the plain version
// rounds the gate, the up product, the activation and the product, each to
// bf16), launch 2 rounds ys once, as the plain version's product does.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BN = 128, BK = 64, THREADS = 256, STAGES = 4;
constexpr int WBYTES = BK * BN * 2;  // a weight slot: 64 k rows of 256 B
constexpr int OPITCH = BN * 2 + 16;  // bytes a row of the staged output

enum Act { NONE = 0, SWIGLU = 1, GEGLU = 2, GELU = 3 };

// PyTorch's silu and gelu(approximate="tanh"), in float32.
__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}
__device__ __forceinline__ float gelu_tanh(float g) {
  const float k0 = 0.7978845608028654f, k1 = 0.044715f;
  return 0.5f * g * (1.0f + tanhf(k0 * (g + k1 * g * g * g)));
}

template <int BM, int ACT>
struct Cfg {
  static constexpr bool GATED = ACT == SWIGLU || ACT == GEGLU;
  static constexpr int XBYTES = BM * BK * 2;  // BM rows of 128 B
  static constexpr int STAGE = XBYTES + (GATED ? 2 : 1) * WBYTES;
  static constexpr int SMEM = 1024 + STAGES * STAGE;  // + alignment
  static_assert(STAGES * STAGE >= BM * OPITCH, "the output fits the ring");
};

template <int BM>
__device__ __forceinline__ void wgmma_bm(float* d, const uint32_t* a,
                                         uint64_t desc) {
  if constexpr (BM == 128)
    wgmma_n128(d, a, desc);
  else
    wgmma_n64(d, a, desc);
}

// x (rows of K), order (R,) int64 or null (row p is x's row p), offsets
// (E + 1,) int32; w_gate, w_up (E, K, N); out (R, N).
template <int BM, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
grouped_kernel(const __nv_bfloat16* __restrict__ x,
               const long long* __restrict__ order, int kdiv,
               const int* __restrict__ offsets,
               const __nv_bfloat16* __restrict__ w_gate,
               const __nv_bfloat16* __restrict__ w_up,
               __nv_bfloat16* __restrict__ out, int E, int K, int N) {
  using C = Cfg<BM, ACT>;
  constexpr int XCH = BM * 8 / THREADS;  // x chunks a thread copies a tile
  extern __shared__ uint4 mg_smem[];
  __shared__ int tile_of[3];  // expert, first row, end row
  unsigned char* sm = reinterpret_cast<unsigned char*>(mg_smem) +
                      ((1024 - (smem_addr(mg_smem) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wgi = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
  const int g = lane >> 2, t = lane & 3;
  const int n_col = (N + BN - 1) / BN;
  const int tile = blockIdx.x / n_col, n0 = (blockIdx.x % n_col) * BN;

  // This block's expert and rows: the row tiles are numbered expert by
  // expert, ceil(count / BM) each; warp 0 scans the offsets 32 at a time.
  if (warp == 0) {
    if (lane == 0) tile_of[0] = -1;
    __syncwarp();
    int carry = 0;
    for (int base = 0; base < E && carry <= tile; base += 32) {
      const int e = base + lane;
      const int lo = e < E ? offsets[e] : 0, hi = e < E ? offsets[e + 1] : 0;
      const int cnt = (hi - lo + BM - 1) / BM;
      int inc = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += v;
      }
      const int first = carry + inc - cnt;
      if (tile >= first && tile < first + cnt) {
        const int r0 = lo + (tile - first) * BM;
        tile_of[0] = e;
        tile_of[1] = r0;
        tile_of[2] = min(hi, r0 + BM);
      }
      carry += __shfl_sync(0xffffffffu, inc, 31);
    }
  }
  __syncthreads();
  const int e = tile_of[0];
  if (e < 0) return;
  const int r0 = tile_of[1], r1 = tile_of[2];
  const size_t w_off = (size_t)e * K * N;

  // The source rows of this thread's x chunks: tile rows tid / 8 + 32 i.
  const __nv_bfloat16* xrow[XCH];
  bool xok[XCH];
#pragma unroll
  for (int i = 0; i < XCH; ++i) {
    const int p = r0 + (tid >> 3) + 32 * i;
    xok[i] = p < r1;
    const long long src = !xok[i] ? 0 : order ? order[p] / kdiv : p;
    xrow[i] = x + src * K;
  }

  // Tile j: x rows (8 chunks of 8 each, 128-byte swizzle) and each weight
  // slot's k rows k0.. (16 chunks of 8 columns, swizzled likewise); zeros
  // past the tile's rows, K and N (K and N are multiples of 8).
  auto load_tile = [&](int j) {
    unsigned char* st = sm + (j % STAGES) * C::STAGE;
    uint4* xs = reinterpret_cast<uint4*>(st);
    const int k0 = j * BK;
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int r = (tid >> 3) + 32 * i, ch = tid & 7, k = k0 + 8 * ch;
      const bool ok = xok[i] && k < K;
      cp_async16(xs + swizzle<8>(r, ch), ok ? xrow[i] + k : x, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * 16 / THREADS; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 4, ch = idx & 15;
      const int k = k0 + r, n = n0 + 8 * ch;
      const bool ok = k < K && n < N;
      const size_t at = ok ? w_off + (size_t)k * N + n : 0;
      uint4* wu = reinterpret_cast<uint4*>(st + C::XBYTES);
      cp_async16(wu + swizzle<16>(r, ch), w_up + at, ok);
      if constexpr (C::GATED) {
        uint4* wg = reinterpret_cast<uint4*>(st + C::XBYTES + WBYTES);
        cp_async16(wg + swizzle<16>(r, ch), w_gate + at, ok);
      }
    }
  };

  float acc_u[BM / 2], acc_g[C::GATED ? BM / 2 : 1];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc_u[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < (C::GATED ? BM / 2 : 1); ++i) acc_g[i] = 0.0f;

  const int n_tiles = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }
  // ldmatrix .x4 .trans: lanes 8m.. give the k rows of matrix m, which
  // lands in A register m: (weight columns 16 wq + 8 (m & 1) .., k rows 8
  // (m >> 1) ..) of this warp's 16 columns and the k-step's 16 rows.
  const int lm = lane >> 3, lk = 8 * (lm >> 1) + (lane & 7);
  const int lc = 8 * wgi + 2 * wq + (lm & 1);  // 16-byte column chunk
  uint32_t au[BK / 16][4], ag[C::GATED ? BK / 16 : 1][4];
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();
    fence_async_shared();
    __syncthreads();  // tile j landed; every product of tile j - 1 done
    if (j + STAGES - 1 < n_tiles) load_tile(j + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = sm + (j % STAGES) * C::STAGE;
    const uint32_t xs = smem_addr(st);
    const uint4* wu = reinterpret_cast<const uint4*>(st + C::XBYTES);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      ldmatrix_x4_trans(au[ks], wu + swizzle<16>(16 * ks + lk, lc));
      if constexpr (C::GATED)
        ldmatrix_x4_trans(ag[ks], wu + BK * 16 + swizzle<16>(16 * ks + lk,
                                                             lc));
    }
    // every A register is written before the group starts
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      wgmma_bm<BM>(acc_u, au[ks], desc_sw128(xs + 32 * ks));
      if constexpr (C::GATED)
        wgmma_bm<BM>(acc_g, ag[ks], desc_sw128(xs + 32 * ks));
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fence_reg(au[ks][q]);
        if constexpr (C::GATED) fence_reg(ag[ks][q]);
      }
  }
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) {
    fence_reg(acc_u[i]);
    if constexpr (C::GATED) fence_reg(acc_g[i]);
  }
  cp_async_wait<0>();
  __syncthreads();  // both warpgroups' products done: the ring is free

  // acc[4i + q]: weight column 16 wq + g (q < 2) or + 8, tile row 8i + 2t +
  // (q & 1); staged as [row][column] bf16.
  unsigned char* os = sm;
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int at = 4 * i + q;
      float v = acc_u[at];
      if constexpr (ACT == SWIGLU) v *= silu(acc_g[at]);
      if constexpr (ACT == GEGLU) v *= gelu_tanh(acc_g[at]);
      if constexpr (ACT == GELU) v = gelu_tanh(v);
      const int row = 8 * i + 2 * t + (q & 1);
      const int col = 64 * wgi + 16 * wq + g + 8 * (q >> 1);
      *reinterpret_cast<__nv_bfloat16*>(os + row * OPITCH + 2 * col) =
          __float2bfloat16(v);
    }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < BM * 16 / THREADS; ++i) {
    const int idx = tid + i * THREADS, r = idx >> 4, ch = idx & 15;
    const int p = r0 + r, n = n0 + 8 * ch;
    if (p < r1 && n < N)
      *reinterpret_cast<uint4*>(out + (size_t)p * N + n) =
          *reinterpret_cast<const uint4*>(os + r * OPITCH + 16 * ch);
  }
}

template <int BM, int ACT>
int launch(const void* x, const void* order, int kdiv, const void* offsets,
           const void* w_gate, const void* w_up, void* out, int E, int K,
           int N, int tiles, cudaStream_t st) {
  using C = Cfg<BM, ACT>;
  auto* k = grouped_kernel<BM, ACT>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)tiles * ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k<<<(unsigned)blocks, THREADS, C::SMEM, st>>>(
      (const __nv_bfloat16*)x, (const long long*)order, kdiv,
      (const int*)offsets, (const __nv_bfloat16*)w_gate,
      (const __nv_bfloat16*)w_up, (__nv_bfloat16*)out, E, K, N);
  return (int)cudaGetLastError();
}

template <int BM>
int by_act(const void* x, const void* order, int kdiv, const void* offsets,
           const void* w_gate, const void* w_up, void* out, int E, int K,
           int N, int act, int tiles, cudaStream_t st) {
#define MG_ARGS x, order, kdiv, offsets, w_gate, w_up, out, E, K, N, tiles, st
  switch (act) {
    case NONE: return launch<BM, NONE>(MG_ARGS);
    case SWIGLU: return launch<BM, SWIGLU>(MG_ARGS);
    case GEGLU: return launch<BM, GEGLU>(MG_ARGS);
    case GELU: return launch<BM, GELU>(MG_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MG_ARGS
}

}  // namespace

// One launch of the grouped product: out (R, N) = act over x's rows (row p
// is x's row order[p] / kdiv, or p where order is null) times each row's
// expert's w_up (and w_gate for act SWIGLU / GEGLU), (E, K, N) bf16
// stacks; offsets (E + 1,) int32 on the device. bm 64 or 128 and
// ``tiles`` row tiles (``moe_grouped.grouped_plan``); K and N multiples of
// 8, every pointer 16-byte aligned.
extern "C" int moe_grouped_bf16(const void* x, const void* order, int kdiv,
                                const void* offsets, const void* w_gate,
                                const void* w_up, void* out, int R, int E,
                                int K, int N, int act, int bm, int tiles,
                                void* stream) {
  const bool gated = act == SWIGLU || act == GEGLU;
  if (R < 1 || E < 1 || K < 8 || N < 8 || K % 8 || N % 8 || kdiv < 1 ||
      tiles < 1 || (gated && w_gate == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bm == 64)
    return by_act<64>(x, order, kdiv, offsets, w_gate, w_up, out, E, K, N,
                      act, tiles, st);
  if (bm == 128)
    return by_act<128>(x, order, kdiv, offsets, w_gate, w_up, out, E, K, N,
                       act, tiles, st);
  return (int)cudaErrorInvalidValue;
}
