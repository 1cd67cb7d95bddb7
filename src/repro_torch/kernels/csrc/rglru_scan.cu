// RG-LRU linear recurrence for Hopper (sm_90a), the port of the Pallas TPU
// kernel ``repro/kernels/rglru_scan.py::rglru_scan_kernel`` (TPU kernel 7).
//
// Computes h_t = a_t * h_{t-1} + x_t over a, x (B, S, L) float32 from
// h0 (B, L), writing every h_t to y (B, S, L) and the last to hT (B, L).
// The Pallas kernel keeps h in VMEM and walks time in order over channel
// blocks; here one lane of warp 0 owns one channel of one row and keeps h
// in a register, walking t = 0 .. S-1. Any S and any L are taken (the
// Pallas kernel needs S % block_t == 0; the engine's prompts have exact
// lengths).
//
// What bounds it: three float32 streams of B*S*L (read a and x, write y),
// 3 * B*S*L * 4 bytes over the device memory rate (37.6 us at (1, 2560,
// 4096)); two FLOPs per element. The dependent chain is one multiply and
// one add per step, about 8 cycles, so 2560 steps take ~12 us: the bound
// is reachable without touching the order of the arithmetic. What stood in
// the way, as measured on an H100 SXM, was the work around the chain in the
// warp that carries it: while that warp also issued the copies and the
// stores of y and read each step's a and x between them, it moved ~9 GB/s
// however deep its ring (one thread per channel on 64 SMs at B 1 in the
// first port; one warp per 32 channels on 128 SMs in a first try of this
// design), and the time fell as that work left it.
//
// The design: a block owns 32 channels (one 128-byte segment a step), so
// B 1, L 4096 runs 128 blocks on 128 SMs. Warp 0 only computes: it loads a
// tile of TT steps of a and x from shared memory into registers, walks it
// (h in a register, one lane a channel) and writes h_t into a y tile in
// shared memory. The other WARPS - 1 warps stream the tiles of a and x
// through a ring of STAGES tiles in shared memory with 16-byte
// ``cp.async`` copies (4-byte ones where L % 4 != 0 or a row is not
// 16-byte aligned), STAGES - 1 tiles in flight, and store each finished y
// tile with 16-byte stores while warp 0 walks the next; one block barrier
// a tile hands the tiles over. WARPS, TT and STAGES are 4, 32 and 8 (56 KB
// of a and x in flight a block) for every shape.
//
// Numerics: ``a * h`` and ``+ x`` are rounded separately (no fused
// multiply-add), in time order, as the plain version ``plain.rglru_scan``
// computes them, so the two agree bit for bit; a time-parallel scan would
// change the roundings and is not used.
#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int WARPS = 4;  // warp 0 computes, the others copy
constexpr int TT = 32;    // steps of a and x in one ring stage
constexpr int STAGES = 8;  // ring depth

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
            const float* __restrict__ h0, float* __restrict__ y,
            float* __restrict__ hT, int S, int L) {
  extern __shared__ float4 smem4[];
  constexpr int THREADS = WARPS * 32;
  constexpr int TILE = TT * 32;  // floats of one array in one stage
  // [STAGES][a tile, x tile], then two y tiles; step r of a tile at
  // [32 r, 32 r + 32), channel c0 + j at column j
  float* ring = reinterpret_cast<float*>(smem4);
  float* ybuf = ring + STAGES * 2 * TILE;
  const int tid = threadIdx.x, lane = tid & 31;
  // warps 1.. copy and store (warp 0 too when it is alone)
  constexpr int COPIERS = WARPS == 1 ? 32 : THREADS - 32;
  const bool copier = WARPS == 1 || tid >= 32;
  const int ct = WARPS == 1 ? tid : tid - 32;
  const int b = blockIdx.y, c0 = blockIdx.x * 32;
  const size_t row0 = (size_t)b * S * L;
  const int n_tiles = (S + TT - 1) / TT;

  auto issue = [&](int tile) {
    if (tile < n_tiles && copier) {
      float* st = ring + (tile % STAGES) * 2 * TILE;
      const int t0 = tile * TT;
      if (VEC) {  // TT rows of 8 16-byte chunks an array
#pragma unroll
        for (int i = ct; i < TT * 8; i += COPIERS) {
          const int r = i >> 3, col = c0 + 4 * (i & 7);
          const bool ok = t0 + r < S && col < L;
          const size_t off = ok ? row0 + (size_t)(t0 + r) * L + col : 0;
          cp_async16(st + 4 * i, a + off, ok);
          cp_async16(st + TILE + 4 * i, x + off, ok);
        }
      } else {
#pragma unroll
        for (int i = ct; i < TT * 32; i += COPIERS) {
          const int r = i >> 5, col = c0 + (i & 31);
          const bool ok = t0 + r < S && col < L;
          const size_t off = ok ? row0 + (size_t)(t0 + r) * L + col : 0;
          cp_async4(st + i, a + off, ok);
          cp_async4(st + TILE + i, x + off, ok);
        }
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // y tile ``tile`` from shared memory to y, by the copiers
  auto store = [&](int tile) {
    if (!copier) return;
    const float* yt = ybuf + (tile & 1) * TILE;
    const int t0 = tile * TT;
    if (VEC) {
#pragma unroll
      for (int i = ct; i < TT * 8; i += COPIERS) {
        const int r = i >> 3, col = c0 + 4 * (i & 7);
        if (t0 + r < S && col < L)
          *reinterpret_cast<float4*>(y + row0 + (size_t)(t0 + r) * L + col) =
              *reinterpret_cast<const float4*>(yt + 4 * i);
      }
    } else {
#pragma unroll
      for (int i = ct; i < TT * 32; i += COPIERS) {
        const int r = i >> 5, col = c0 + (i & 31);
        if (t0 + r < S && col < L) y[row0 + (size_t)(t0 + r) * L + col] = yt[i];
      }
    }
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  const int l = c0 + lane;
  float h = tid < 32 && l < L ? h0[(size_t)b * L + l] : 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    // every copier's copies of this tile have landed; warp 0 is done with
    // the stage the next issue overwrites (the previous tile's) and has
    // written the previous y tile; the copiers have stored the one before
    __syncthreads();
    issue(tile + STAGES - 1);
    if (tile > 0) store(tile - 1);
    if (tid < 32) {
      // the tile's a and x into registers first: the y stores between the
      // steps would otherwise hold each step's loads behind them
      const float* st = ring + (tile % STAGES) * 2 * TILE + lane;
      float ra[TT], rx[TT];
#pragma unroll
      for (int r = 0; r < TT; ++r) {
        ra[r] = st[32 * r];
        rx[r] = st[TILE + 32 * r];
      }
      float* yt = ybuf + (tile & 1) * TILE + lane;
      const int steps = min(TT, S - tile * TT);
#pragma unroll
      for (int r = 0; r < TT; ++r) {
        if (r < steps) {
          h = __fadd_rn(__fmul_rn(ra[r], h), rx[r]);
          yt[32 * r] = h;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  store(n_tiles - 1);
  if (tid < 32 && l < L) hT[(size_t)b * L + l] = h;
}

template <bool VEC>
int launch(const void* a, const void* x, const void* h0, void* y, void* hT,
           int B, int S, int L, cudaStream_t stream) {
  auto* k = scan_kernel<VEC>;
  const int smem = (STAGES + 1) * 2 * TT * 32 * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + 31) / 32, B);
  k<<<grid, WARPS * 32, smem, stream>>>(
      (const float*)a, (const float*)x, (const float*)h0, (float*)y,
      (float*)hT, S, L);
  return (int)cudaGetLastError();
}

}  // namespace

// vec: 16-byte copies (L % 4 == 0 and 16-byte aligned a, x and y), else
// 4-byte ones.
extern "C" int rglru_scan_f32(const void* a, const void* x, const void* h0,
                              void* y, void* hT, int B, int S, int L,
                              int vec, void* stream) {
  if (B < 1 || S < 1 || L < 1) return (int)cudaErrorInvalidValue;
  if (vec && (L % 4 != 0 ||
              ((uintptr_t)a | (uintptr_t)x | (uintptr_t)y) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return vec ? launch<true>(a, x, h0, y, hT, B, S, L, st)
             : launch<false>(a, x, h0, y, hT, B, S, L, st);
}
