// Paged decode attention over int8 pools for Hopper (sm_90a), the port of
// the Pallas TPU kernel
// ``repro/kernels/decode_attention.py::paged_decode_attention_int8`` (TPU
// kernel 4). The K/V pools hold int8 codes (P, ps, KVH, D) and one float32
// scale per (slot, kv head) in scale pools (P, ps, KVH, 1), addressed by
// the same page ids; both are read in the model layout through strides.
//
// What bounds it: the bytes of the valid K/V rows, D + 4 per (slot, kv
// head) instead of 2 D, so about half the bf16 kernel's bound. bfloat16 q
// takes the one-launch twin-order kernel of ``decode_sm90.cuh``: codes by
// 16-byte ``cp.async`` and each row's scale by a 4-byte one into a ring,
// then a conversion pass into the bf16 tile the dot products read. float32
// q takes the three launches of ``paged_decode.cuh`` (a tile of 32 rows,
// 16 codes per 16-byte load plus one scale load per row).
//
// Numerics: each element is dequantized as ``round_to<T>(code * scale)``
// (one float32 product, rounded to q's type) before its dot, exactly as
// the twin ``layers.paged_decode_attention_int8`` builds the cache it
// attends; the Pallas body keeps float32 and skips that rounding, which
// differs in bfloat16 (about 8e-3 away; the bf16 kernel is held to 1e-3).
// The softmax and P V are the model-dtype kernels'.
#include "decode_sm90.cuh"

namespace {

struct Int8Row {
  const int8_t* v;  // D codes, or nullptr past the edge (loaded as zeros)
  const float* s;   // their scale
};

// A tile of ROWS cache rows of D int8 codes and their scales, copied by a
// block of THREADS threads in 16-byte loads; ``store`` writes the
// dequantized rows code * scale as float32, the float32 twin's cache (see
// TileLoader for the load/store split).
template <int ROWS, int D, int THREADS>
struct Int8TileLoader {
  static constexpr int VEC = 16;
  static constexpr int PER_ROW = D / VEC;
  static constexpr int TOTAL = ROWS * PER_ROW;
  static constexpr int N = (TOTAL + THREADS - 1) / THREADS;
  uint4 buf[N];
  float sc[N];

  template <typename RowAt>
  __device__ __forceinline__ void load(RowAt row_at) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      buf[i] = make_uint4(0u, 0u, 0u, 0u);
      sc[i] = 0.0f;
      if (idx < TOTAL) {
        const Int8Row r = row_at(idx / PER_ROW);
        if (r.v != nullptr) {
          buf[i] = __ldg(
              reinterpret_cast<const uint4*>(r.v + (idx % PER_ROW) * VEC));
          sc[i] = __ldg(r.s);
        }
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
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          dst[j * pitch + d0 + e] = int8_code(buf[i], e) * sc[i];
      }
    }
  }
};

// An int8 page pool (P, ps, KVH, D) and its scale pool (P, ps, KVH, 1),
// each read through its own strides.
struct Int8Pool {
  using Row = Int8Row;
  template <int ROWS, int D, int THREADS>
  using Tile = Int8TileLoader<ROWS, D, THREADS>;
  static constexpr bool kRing = false;
  const int8_t* base;
  const float* scale;
  long long sp, ss, sh;  // value strides
  long long qp, qs, qh;  // scale strides
  __device__ __forceinline__ static Row none() {
    return Int8Row{nullptr, nullptr};
  }
  __device__ __forceinline__ Row row(int page, int off, int c) const {
    return Int8Row{base + (long long)page * sp + (long long)off * ss +
                       (long long)c * sh,
                   scale + (long long)page * qp + (long long)off * qs +
                       (long long)c * qh};
  }
};

}  // namespace

// q and o are float32; kp/vp int8 pools and ks/vs their float32 scale
// pools (strides sp/ss/sh and qp/qs/qh, in elements); the scratch is that
// of paged_decode_attention_f32.
extern "C" int paged_decode_attention_int8_f32(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* pos, void* o,
    void* scores, void* stats, void* partial, int B, int S, int H, int KVH,
    int D, int n_pages, int ps, long long sp, long long ss, long long sh,
    long long qp, long long qs, long long qh, int nsplit, float scale,
    void* stream) {
  const Int8Pool k{(const int8_t*)kp, (const float*)ks, sp, ss, sh,
                   qp, qs, qh};
  const Int8Pool v{(const int8_t*)vp, (const float*)vs, sp, ss, sh,
                   qp, qs, qh};
  return paged::dispatch(q, k, v, (const int*)table, (const int*)pos, o,
                         (float*)scores, (float*)stats, (float*)partial, B, S,
                         H, KVH, D, n_pages, ps, nsplit, scale, stream);
}

// q and o bfloat16: one launch, no scratch, the plan of
// paged_decode_attention_bf16.
extern "C" int paged_decode_attention_int8_bf16(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* table, const void* pos, void* o, int B,
    int S, int H, int KVH, int D, int n_pages, int ps, long long sp,
    long long ss, long long sh, long long qp, long long qs, long long qh,
    int nsplit, int keep, int stages, float scale, void* stream) {
  const Int8Pool k{(const int8_t*)kp, (const float*)ks, sp, ss, sh,
                   qp, qs, qh};
  const Int8Pool v{(const int8_t*)vp, (const float*)vs, sp, ss, sh,
                   qp, qs, qh};
  return sm90::dispatch_twin(q, k, v, (const int*)table, (const int*)pos, o,
                             B, S, H, KVH, D, n_pages, ps, nsplit, keep,
                             stages, scale, stream);
}

// Twin-order blocks one SM holds for a call of the plan over int8 pools,
// as the runtime counts them; ``decode_attention.twin_blocks_per_sm``
// promises at most as many.
extern "C" int paged_decode_int8_twin_blocks_per_sm(int D, int R, int W,
                                                    int nsplit, int keep,
                                                    int stages) {
  return sm90::twin_blocks_per_sm<Int8Pool>(
      D, R,
      sm90::twin_smem(true, D, R, sm90::tiles_per_split(W, nsplit), keep,
                      stages));
}
