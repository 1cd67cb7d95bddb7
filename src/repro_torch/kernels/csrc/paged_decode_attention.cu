// Paged decode attention for Hopper (sm_90a), the port of the Pallas TPU
// kernel ``repro/kernels/decode_attention.py::paged_decode_attention``
// (TPU kernel 2): pools in the model dtype (float32 or bfloat16). The
// design, what bounds it and the numerics are in ``paged_decode.cuh``.
#include "paged_decode.cuh"

namespace {

// A page pool (P, ps, KVH, D) of T, read through its strides; a tile of
// its rows is copied with 16-byte loads (TileLoader).
template <typename T>
struct PlainPool {
  using Row = const T*;
  template <int ROWS, int D, int THREADS>
  using Tile = TileLoader<T, ROWS, D, THREADS>;
  static constexpr bool kRing = false;
  const T* base;
  long long sp, ss, sh;
  __device__ __forceinline__ static Row none() { return nullptr; }
  __device__ __forceinline__ Row row(int page, int off, int c) const {
    return base + (long long)page * sp + (long long)off * ss +
           (long long)c * sh;
  }
};

template <typename T>
int run(const void* q, const void* kp, const void* vp, const void* table,
        const void* pos, void* o, void* scores, void* stats, void* partial,
        int B, int S, int H, int KVH, int D, int n_pages, int ps,
        long long sp, long long ss, long long sh, int nsplit, float scale,
        void* stream) {
  const PlainPool<T> k{(const T*)kp, sp, ss, sh};
  const PlainPool<T> v{(const T*)vp, sp, ss, sh};
  return paged::dispatch<T>(q, k, v, (const int*)table, (const int*)pos, o,
                            (float*)scores, (float*)stats, (float*)partial,
                            B, S, H, KVH, D, n_pages, ps, nsplit, scale,
                            stream);
}

}  // namespace

// scores: (B, KVH, G*S, wpad) float32, stats: (B, KVH, nsplit, G*S, 2)
// float32 and partial: (B, KVH, nsplit, G*S, D) float32 are scratch the
// wrapper allocates; wpad = n_pages * ps rounded up to 32.
extern "C" int paged_decode_attention_f32(
    const void* q, const void* kp, const void* vp, const void* table,
    const void* pos, void* o, void* scores, void* stats, void* partial,
    int B, int S, int H, int KVH, int D, int n_pages, int ps, long long sp,
    long long ss, long long sh, int nsplit, float scale, void* stream) {
  return run<float>(q, kp, vp, table, pos, o, scores, stats, partial, B, S,
                    H, KVH, D, n_pages, ps, sp, ss, sh, nsplit, scale,
                    stream);
}

extern "C" int paged_decode_attention_bf16(
    const void* q, const void* kp, const void* vp, const void* table,
    const void* pos, void* o, void* scores, void* stats, void* partial,
    int B, int S, int H, int KVH, int D, int n_pages, int ps, long long sp,
    long long ss, long long sh, int nsplit, float scale, void* stream) {
  return run<__nv_bfloat16>(q, kp, vp, table, pos, o, scores, stats,
                            partial, B, S, H, KVH, D, n_pages, ps, sp, ss,
                            sh, nsplit, scale, stream);
}
