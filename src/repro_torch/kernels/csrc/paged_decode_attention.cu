// Paged decode attention for Hopper (sm_90a), the port of the Pallas TPU
// kernel ``repro/kernels/decode_attention.py::paged_decode_attention``
// (TPU kernel 2): pools in the model dtype. bfloat16 pools take the
// one-launch twin-order kernel of ``decode_sm90.cuh``; float32 pools the
// three launches of ``paged_decode.cuh`` (for the 2e-5 gate and the
// CUDA == CPU float32 streams). The designs, what bounds them and the
// numerics are in those headers.
#include "decode_sm90.cuh"

namespace {

// A page pool (P, ps, KVH, D) of T, read through its strides; the
// three-launch kernels copy a tile of its rows with 16-byte loads
// (TileLoader), the one-launch kernel takes each row's address.
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

}  // namespace

// scores: (B, KVH, G*S, wpad) float32, stats: (B, KVH, nsplit, G*S, 2)
// float32 and partial: (B, KVH, nsplit, G*S, D) float32 are scratch the
// wrapper allocates; wpad = n_pages * ps rounded up to 32.
extern "C" int paged_decode_attention_f32(
    const void* q, const void* kp, const void* vp, const void* table,
    const void* pos, void* o, void* scores, void* stats, void* partial,
    int B, int S, int H, int KVH, int D, int n_pages, int ps, long long sp,
    long long ss, long long sh, int nsplit, float scale, void* stream) {
  const PlainPool<float> k{(const float*)kp, sp, ss, sh};
  const PlainPool<float> v{(const float*)vp, sp, ss, sh};
  return paged::dispatch(q, k, v, (const int*)table, (const int*)pos, o,
                         (float*)scores, (float*)stats, (float*)partial, B, S,
                         H, KVH, D, n_pages, ps, nsplit, scale, stream);
}

// One launch, no scratch: the plan (nsplit splits of one cluster, scores
// kept in shared memory or recomputed, ring slots) is
// ``decode_attention.paged_plan_sm90``'s.
extern "C" int paged_decode_attention_bf16(
    const void* q, const void* kp, const void* vp, const void* table,
    const void* pos, void* o, int B, int S, int H, int KVH, int D,
    int n_pages, int ps, long long sp, long long ss, long long sh,
    int nsplit, int keep, int stages, float scale, void* stream) {
  using T = __nv_bfloat16;
  const PlainPool<T> k{(const T*)kp, sp, ss, sh};
  const PlainPool<T> v{(const T*)vp, sp, ss, sh};
  return sm90::dispatch_twin(q, k, v, (const int*)table, (const int*)pos, o,
                             B, S, H, KVH, D, n_pages, ps, nsplit, keep,
                             stages, scale, stream);
}

// The twin-order kernel's shared memory in bytes for a call of the plan
// (codes: int8 pools), as it launches it; ``decode_attention.sm90_smem``
// computes the same in Python.
extern "C" int paged_decode_sm90_smem(int D, int R, int W, int nsplit,
                                      int keep, int stages, int codes) {
  return sm90::twin_smem(codes != 0, D, R, sm90::tiles_per_split(W, nsplit),
                         keep, stages);
}

// Twin-order blocks one SM holds for a call of the plan over bf16 pools,
// as the runtime counts them; ``decode_attention.twin_blocks_per_sm``
// promises at most as many.
extern "C" int paged_decode_twin_blocks_per_sm(int D, int R, int W,
                                               int nsplit, int keep,
                                               int stages) {
  return sm90::twin_blocks_per_sm<PlainPool<__nv_bfloat16>>(
      D, R,
      sm90::twin_smem(false, D, R, sm90::tiles_per_split(W, nsplit), keep,
                      stages));
}
