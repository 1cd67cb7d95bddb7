// Weight-only int8 matmul for Hopper (sm_90a), the port of the Pallas TPU
// kernel ``repro/kernels/int8_matmul.py::int8_matmul`` (TPU kernel 5):
//   y (M, N) = (float(x) @ float(w_q)) * scale, cast once to x's type,
// x (M, K) float32 or bfloat16 row-major, w_q (K, N) int8 row-major (the
// JAX orientation, which ``models.model.quantize_weights`` keeps: no
// re-ordered copy of a weight is ever made), scale (N,) float32, applied
// per output column after the dot (``layers.linear``'s dict path).
//
// What bounds it: at decode (M = 8 slots) the int8 weight read, K*N bytes
// against 2*M*K*N FLOPs, so device-memory bandwidth; at prefill (M = a
// bucket of 32..1024) the FLOPs (granite's projections at M 512: 4.3 to
// 60 GFLOP against 4 to 59 MB). The weight is read as int8, once per M
// tile, and converted in registers: no dequantized copy of a weight is
// ever written to device memory, since halving that read is the point.
// Few output tiles cannot keep 132 SMs busy, so the wrapper splits K over
// ``splits`` blocks per tile, and the partials are summed in split order
// (deterministic): inside the launch by the bf16 decode tile, by a second
// launch after the prefill and float32 tiles, which write float32
// partials.
//
// bfloat16 x runs on tensor cores, bf16 x bf16 -> f32. An int8 code
// (|q| <= 127) is exact in bfloat16, and the product of two bfloat16
// values is exact in float32, so the tensor cores form the twin's
// products exactly; only the order of the sum differs.
//
// Prefill (bm 128, M > 32): ``wgmma``, Hopper's warpgroup product, on
// y^T = w^T x^T. A block is one warpgroup (4 warps) computing 64 output
// columns for 128 rows of x, 64 deep per step. A ring of 3 shared-memory
// stages, filled by 16-byte ``cp.async`` copies with the next 2 tiles in
// flight, holds x in bf16 (rows of 128 B in the 128-byte swizzle, which
// ``wgmma`` reads directly through a descriptor as its B operand) and w
// AS INT8 (half the bytes of a bf16 copy), with one barrier per step.
// The weight is the A operand, from registers: each thread loads 16-bit
// words (two columns) from its 4 k rows per k-step and byte permutes plus
// one float subtraction turn them into exact bf16 pairs
// (``codes_to_bf16x2``), so the conversion never touches the copy path.
// A tile's 4 k-steps are converted first and then issued as one group of
// 4 products: ptxas serializes products whose A registers are written
// while earlier ones are in flight, and 3 blocks per SM (64 KB each) fill
// each other's conversion gaps. An ``mma.sync.m16n8k16`` tile with
// ``ldmatrix`` fragments (the first design) measured slower than this one
// at granite's M-512 shapes on the H100.
//
// Decode (M <= 32, ``decode::kernel``): a weight stream on
// ``mma.sync.m16n8k16``, also on y^T = w^T x^T, so the weight fills the
// m16 side and the slots the n8 side (8 slots are one n8 tile, with no
// padded half). The int8 weight and x go global -> shared by 16-byte
// ``cp.async`` copies into a ring of 6 stages of 64 K rows (5 in flight,
// 20 KB of weight per block at 64 columns, 40 KB at 128), with no
// register staging; each warp converts its codes to exact bf16 pairs in
// registers right before its products (one 32-bit shared load per k row
// gives the codes of two m16 tiles). The wrapper's plan (``decode_plan``)
// picks 128, 64 or 32 columns per block and the fewest K splits (a power
// of two up to 8) that make about one block per SM; the splits of one
// column tile are one thread-block cluster, and each block sums its share
// of the columns over the cluster's partials through distributed shared
// memory, in rank order, then scales and casts: one launch, no float32
// partials in device memory. One bulk copy (TMA) per weight row instead,
// started by one warp, measured slower on the H100. The first decode
// tile (16 x 128, weights staged through registers 4 KB a block, converted
// into shared memory, a second launch for the split sum) ran 0.0134 ms
// on an H100 SXM (700 W) at M 8 and 4096x1024, against 0.0082 for bf16
// ``torch.matmul``.
//
// float32 x is not exact in bf16 (nor in TF32) and the 2e-5 gate needs
// float32 arithmetic: it takes a float32 FMA path.
#include <cooperative_groups.h>

#include "common.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BN = 128;         // output columns per block
constexpr int BK = 32;          // contraction depth per tile
constexpr int THREADS = 128;    // four warps
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

// bfloat16 x at decode (M <= 32): the weight stream, on y^T = w^T x^T.
namespace decode {

namespace cg = cooperative_groups;

constexpr int BK = 64;           // K rows per stage
constexpr int MAX_CLUSTER = 8;   // K splits of one column tile, at most

// BN output columns per block (32, 64 or 128: a warp per 32 columns,
// the warps of a column group splitting each stage's 4 k-steps; 8 warps,
// 4 at 32 columns), MTN n8 tiles of x rows (M <= 8 MTN, rows past M
// zero).
template <int BN, int MTN>
struct Cfg {
  // ring depth: 5 stages in flight ahead of the one in use (12 or 16 at
  // 64 or 32 columns measured no faster)
  static constexpr int STAGES = 6;
  static constexpr int WPITCH = BN + 16;  // bytes per weight row: the rows
                                          // 2t of a quad in distinct banks
  static constexpr int W_BYTES = BK * WPITCH;
  static constexpr int XR = MTN * 8;
  static constexpr int X_BYTES = XR * BK * 2;  // rows of 128 B, swizzled
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int WARPS = BN == 32 ? 4 : 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int CG = BN / 32;     // column groups
  static constexpr int KG = WARPS / CG;  // k groups per column group
  static constexpr int KSW = BK / 16 / KG;  // k-steps per warp per stage
  static constexpr int OPITCH = BN + 4;  // floats per published row
  static constexpr int O_BYTES = KG * XR * OPITCH * 4;
  static constexpr int SMEM =
      STAGES * STAGE > O_BYTES ? STAGES * STAGE : O_BYTES;
  static_assert(STAGE % 16 == 0 && KSW >= 1, "tiling");
};

// The weight is the A operand of ``mma.sync.m16n8k16``: a warp's 32
// columns are two m16 tiles, logical rows g and g + 8 of tile u being
// columns 4g + 2u and 4g + 2u + 1, so one 32-bit shared load per k row
// gives a thread the codes of both tiles; ``codes_to_bf16x2`` turns them
// into exact bf16 pairs in registers. x is the B operand (``ldmatrix``
// from the swizzled x tile): 8 slots fill one n8 tile.
template <int BN, int MTN>
__global__ void __launch_bounds__(Cfg<BN, MTN>::THREADS)
kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
       const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
       int M, int K, int N, int kchunk) {
  using C = Cfg<BN, MTN>;
  extern __shared__ uint4 dec_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(dec_smem);
  float* os = reinterpret_cast<float*>(dec_smem);  // after the loop
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cgp = warp % C::CG, kgp = warp / C::CG;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  // Stage j: BK weight rows of BN codes, and x's XR rows of BK values;
  // zeros past M, N and the split's end (K and N are multiples of 16, so
  // a 16-byte chunk is wholly inside or outside).
  auto load_tile = [&](int j) {
    unsigned char* st = sm + (j % C::STAGES) * C::STAGE;
    uint4* xs = reinterpret_cast<uint4*>(st + C::W_BYTES);
    const int k0 = k_begin + j * BK;
    constexpr int WCH = BK * BN / 16, XCH = C::XR * 8;
#pragma unroll
    for (int i = 0; i < WCH / C::THREADS; ++i) {
      const int idx = tid + i * C::THREADS;
      const int r = idx / (BN / 16), ch = idx % (BN / 16);
      const int k = k0 + r, n = n0 + 16 * ch;
      const bool ok = k < k_end && n < N;
      cp_async16(st + r * C::WPITCH + 16 * ch,
                 w + (ok ? (size_t)k * N + n : 0), ok);
    }
#pragma unroll
    for (int i = 0; i < (XCH + C::THREADS - 1) / C::THREADS; ++i) {
      const int idx = tid + i * C::THREADS;
      if (XCH % C::THREADS == 0 || idx < XCH) {
        const int r = idx >> 3, ch = idx & 7, k = k0 + 8 * ch;
        const bool ok = r < M && k < k_end;
        cp_async16(xs + swizzle<8>(r, ch), x + (ok ? (size_t)r * K + k : 0),
                   ok);
      }
    }
  };

  float acc[2][MTN][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int jn = 0; jn < MTN; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][jn][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < C::STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // stage j landed; every warp is done with stage j - 1
    if (j + C::STAGES - 1 < n_tiles) load_tile(j + C::STAGES - 1);
    cp_async_commit();
    const unsigned char* ws = sm + (j % C::STAGES) * C::STAGE;
    const uint4* xs = reinterpret_cast<const uint4*>(ws + C::W_BYTES);
#pragma unroll
    for (int kq = 0; kq < C::KSW; ++kq) {
      const int ks = kgp * C::KSW + kq;
      const unsigned char* p =
          ws + (16 * ks + 2 * t) * C::WPITCH + 32 * cgp + 4 * g;
      // k rows 2t, 2t + 1, 2t + 8, 2t + 9; codes biased by 0x80
      const uint32_t h0 = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
      const uint32_t h1 =
          *reinterpret_cast<const uint32_t*>(p + C::WPITCH) ^ 0x80808080u;
      const uint32_t h2 =
          *reinterpret_cast<const uint32_t*>(p + 8 * C::WPITCH) ^ 0x80808080u;
      const uint32_t h3 =
          *reinterpret_cast<const uint32_t*>(p + 9 * C::WPITCH) ^ 0x80808080u;
      uint32_t a[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        a[u][0] = codes_to_bf16x2(h0, h1, 2 * u);
        a[u][1] = codes_to_bf16x2(h0, h1, 2 * u + 1);
        a[u][2] = codes_to_bf16x2(h2, h3, 2 * u);
        a[u][3] = codes_to_bf16x2(h2, h3, 2 * u + 1);
      }
#pragma unroll
      for (int jn = 0; jn < MTN; ++jn) {
        uint32_t b[2];
        ldmatrix_x2(b, xs + swizzle<8>(8 * jn + (lane & 7),
                                       2 * ks + ((lane >> 3) & 1)));
        mma_bf16(acc[0][jn], a[0], b);
        mma_bf16(acc[1][jn], a[1], b);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the published partial

  // acc[u][jn]: c0 column 4g + 2u, x row 8jn + 2t; c1 row + 1; c2, c3
  // column + 1. Published as os[k group][x row][column], four columns a
  // float4.
#pragma unroll
  for (int jn = 0; jn < MTN; ++jn)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * jn + 2 * t + e;
      *reinterpret_cast<float4*>(os + (kgp * C::XR + m) * C::OPITCH +
                                 32 * cgp + 4 * g) =
          make_float4(acc[0][jn][e], acc[0][jn][2 + e], acc[1][jn][e],
                      acc[1][jn][2 + e]);
    }

  // The K splits of this column tile are one cluster: block ``rank`` sums
  // columns [rank BN / cs, ...) over the k groups and the cluster's
  // blocks, in rank order, through distributed shared memory, then scales
  // and casts.
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  cl.sync();
  const int cols = BN / cs, c0 = rank * cols;
  const float* src[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    src[r] = cl.map_shared_rank(os, r < cs ? r : 0);
  for (int idx = tid; idx < M * cols; idx += C::THREADS) {
    const int m = idx / cols, nl = c0 + idx % cols, n = n0 + nl;
    if (n >= N) continue;
    float v[MAX_CLUSTER][C::KG];  // every load in flight at once
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
#pragma unroll
      for (int kg = 0; kg < C::KG; ++kg)
        v[r][kg] = r < cs ? src[r][(kg * C::XR + m) * C::OPITCH + nl] : 0.0f;
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
#pragma unroll
      for (int kg = 0; kg < C::KG; ++kg) sum += v[r][kg];
    y[(size_t)m * N + n] = __float2bfloat16(sum * __ldg(scale + n));
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

template <int BN, int MTN>
int launch(const void* x, const void* w, const void* scale, void* y, int M,
           int K, int N, int splits, int kchunk, cudaStream_t stream) {
  using C = Cfg<BN, MTN>;
  auto* k = kernel<BN, MTN>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, 1, splits);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k, (const __nv_bfloat16*)x,
                           (const int8_t*)w, (const float*)scale,
                           (__nv_bfloat16*)y, M, K, N, kchunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BN>
int by_rows(const void* x, const void* w, const void* scale, void* y, int M,
            int K, int N, int splits, int kchunk, cudaStream_t st) {
  if (M <= 8) return launch<BN, 1>(x, w, scale, y, M, K, N, splits, kchunk, st);
  if (M <= 16)
    return launch<BN, 2>(x, w, scale, y, M, K, N, splits, kchunk, st);
  return launch<BN, 4>(x, w, scale, y, M, K, N, splits, kchunk, st);
}

}  // namespace decode

// bfloat16 x at prefill (M > 32) on Hopper's warpgroup products, as
// y^T = w^T x^T: a block is one warpgroup computing 64 output columns for
// 128 rows of x. The int8 weight is the A operand, converted to bf16 in
// registers; the x tile is the B operand, read by ``wgmma`` straight from
// the swizzled shared ring through a descriptor.
namespace prefill {

constexpr int BN = 64, BM = 128, BK = 64, STAGES = 3, THREADS = 128;
constexpr int XBYTES = BM * BK * 2;  // 128 rows of 128 B, 1024-aligned
constexpr int WPITCH = BN + 16;  // bytes per weight row (80): a quad's
                                 // rows 2t fall in distinct banks
constexpr int WBYTES = BK * WPITCH;
constexpr int SMEM = 1024 + STAGES * (XBYTES + WBYTES);  // + alignment

__global__ void __launch_bounds__(THREADS)
kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
       const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
       float* __restrict__ partial, int M, int K, int N, int kchunk) {
  extern __shared__ uint4 wg_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(wg_smem) +
                      ((1024 - (smem_addr(wg_smem) & 1023)) & 1023);
  unsigned char* wring = sm + STAGES * XBYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(K, k_begin + kchunk);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  // Tile j: x rows m0.. (8 chunks of 8 each, swizzled) and w rows k0..
  // (4 chunks of 16 columns each); zeros past M, N and the split's end (K
  // and N are multiples of 16, so a chunk is wholly inside or outside).
  auto load_tile = [&](int j) {
    uint4* xs = reinterpret_cast<uint4*>(sm + (j % STAGES) * XBYTES);
    unsigned char* ws = wring + (j % STAGES) * WBYTES;
    const int k0 = k_begin + j * BK;
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 3, ch = idx & 7;
      const int m = m0 + r, k = k0 + 8 * ch;
      const bool ok = m < M && k < k_end;
      cp_async16(xs + swizzle<8>(r, ch), x + (ok ? (size_t)m * K + k : 0),
                 ok);
    }
#pragma unroll
    for (int i = 0; i < BK * 4 / THREADS; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 2, ch = idx & 3;
      const int k = k0 + r, n = n0 + 16 * ch;
      const bool ok = k < k_end && n < N;
      cp_async16(ws + r * WPITCH + 16 * ch,
                 w + (ok ? (size_t)k * N + n : 0), ok);
    }
  };

  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(st);
    cp_async_commit();
  }
  // A fragments of a tile's 4 k-steps. Logical rows g and g + 8 of this
  // warp's 16 are weight columns 16 warp + 2g and + 1, so one 16-bit load
  // per k row (2t, 2t + 1, 2t + 8, 2t + 9) gives both.
  uint32_t a[BK / 16][4];
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<STAGES - 2>();
    fence_async_shared();
    __syncthreads();  // tile j landed; every product of tile j - 1 done
    if (j + STAGES - 1 < n_tiles) load_tile(j + STAGES - 1);
    cp_async_commit();
    const uint32_t xs = smem_addr(sm + (j % STAGES) * XBYTES);
    const unsigned char* ws = wring + (j % STAGES) * WBYTES;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const unsigned char* p =
          ws + (16 * ks + 2 * t) * WPITCH + 16 * warp + 2 * g;
      uint32_t h[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)  // rows 2t, 2t + 1, 2t + 8, 2t + 9
        h[r] = *reinterpret_cast<const uint16_t*>(
                   p + ((r & 1) + 8 * (r >> 1)) * WPITCH) ^ 0x8080u;
      a[ks][0] = codes_to_bf16x2(h[0], h[1], 0);
      a[ks][1] = codes_to_bf16x2(h[0], h[1], 1);
      a[ks][2] = codes_to_bf16x2(h[2], h[3], 0);
      a[ks][3] = codes_to_bf16x2(h[2], h[3], 1);
    }
    // every A register is written before the group starts: ptxas then
    // runs the four products back to back
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_n128(acc, a[ks], desc_sw128(xs + 32 * ks));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_reg(a[ks][e]);
  }
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) fence_reg(acc[i]);
  cp_async_wait<0>();

  // acc[4i + e]: logical row g (e < 2: weight column c) or g + 8 (column
  // c + 1), x row 8i + 2t + (e & 1)
  const int c = n0 + 16 * warp + 2 * g;
  if (c >= N) return;
  const bool split = gridDim.z > 1;
  const float s0 = __ldg(scale + c), s1 = __ldg(scale + c + 1);
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * i + 2 * t + e;
      if (m >= M) continue;
      const float v0 = acc[4 * i + e], v1 = acc[4 * i + 2 + e];
      if (split)
        *reinterpret_cast<float2*>(
            partial + ((size_t)blockIdx.z * M + m) * N + c) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(y + (size_t)m * N + c) =
            pack_bf16(v0 * s0, v1 * s1);
    }
}

}  // namespace prefill

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
// [z * kchunk, min(K, (z + 1) * kchunk)); kchunk is a multiple of the
// tile depth (32 at bm 16, 64 at bm 128). bm: rows of x per block, 128
// (the bf16 prefill tile, 64 columns, M > 32) in bf16; 16 in f32.
extern "C" int int8_matmul_bf16(const void* x, const void* w,
                                const void* scale, void* y, void* partial,
                                int M, int K, int N, int bm, int splits,
                                int kchunk, void* stream) {
  if (K % 16 || N % 16 || splits < 1 || bm != prefill::BM ||
      kchunk % prefill::BK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto* yp = (__nv_bfloat16*)y;
  const cudaError_t err = cudaFuncSetAttribute(
      prefill::kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      prefill::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + prefill::BN - 1) / prefill::BN,
                  (M + prefill::BM - 1) / prefill::BM, splits);
  prefill::kernel<<<grid, prefill::THREADS, prefill::SMEM, st>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w, (const float*)scale, yp,
      (float*)partial, M, K, N, kchunk);
  return finish((const float*)partial, (const float*)scale, yp, M, N,
                splits, st);
}

// The bf16 decode tile, M <= 32: bn output columns per block (32, 64 or
// 128), ``splits`` K splits per column tile (a power of two up to 8, one
// cluster), split z covering K rows [z * kchunk, ...), kchunk a multiple
// of 64 (``int8_matmul.decode_plan``). One launch: the splits are summed
// inside it.
extern "C" int int8_matmul_decode_bf16(const void* x, const void* w,
                                       const void* scale, void* y, int M,
                                       int K, int N, int bn, int splits,
                                       int kchunk, void* stream) {
  if (M < 1 || M > 32 || K % 16 || N % 16 || kchunk < decode::BK ||
      kchunk % decode::BK || splits < 1 || splits > decode::MAX_CLUSTER ||
      (splits & (splits - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (bn) {
    case 32:
      return decode::by_rows<32>(x, w, scale, y, M, K, N, splits, kchunk, st);
    case 64:
      return decode::by_rows<64>(x, w, scale, y, M, K, N, splits, kchunk, st);
    case 128:
      return decode::by_rows<128>(x, w, scale, y, M, K, N, splits, kchunk,
                                  st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

