// Decode attention over a rolling cache for Hopper (sm_90a), the port of
// the Pallas TPU kernel ``repro/kernels/decode_attention.py::
// decode_attention`` (TPU kernel 6), which serves the local-attention
// blocks of hybrid archs and dense archs without pages.
//
// A ring holds W cache rows per decode slot in the model layout
// (B, W, KVH, D): row t of slot b, kv head c lives at
// ``base + b*sb + t*ss + c*sh`` (the strides the wrapper passes), with no
// page table. Query s of S sees min(pos - (S-1) + s, W) rows; once a slot
// has written W tokens every row is valid, whatever order the ring's
// writes left them in (attention is a sum over rows).
//
// The Pallas kernel runs an online softmax over 256-wide blocks; this one
// is a third instantiation of the split-context machinery in
// ``paged_decode.cuh`` (a ring is one page of W rows per slot), so its
// numerics are those of the plain version ``plain.decode_attention``: the
// row's global max and sum, probabilities rounded to q's type before P V.
// What bounds it is the same as there: the bytes of the valid K/V rows
// (recurrentgemma: 8 slots x 2048 rows x 1 kv head x 256 x 2 B x 2 = 16.8
// MB per layer in bf16), read once for the G = 16 query heads sharing the
// kv head, with each slot's ring split over enough blocks to fill the card.
#include "paged_decode.cuh"

namespace {

// A ring (B, W, KVH, D) of T read through its strides; a tile of its rows
// is copied with 16-byte loads (TileLoader).
template <typename T>
struct RingPool {
  using Row = const T*;
  template <int ROWS, int D, int THREADS>
  using Tile = TileLoader<T, ROWS, D, THREADS>;
  static constexpr bool kRing = true;
  const T* base;
  long long sb, ss, sh;
  __device__ __forceinline__ static Row none() { return nullptr; }
  __device__ __forceinline__ Row ring_row(int b, int t, int c) const {
    return base + (long long)b * sb + (long long)t * ss + (long long)c * sh;
  }
};

template <typename T>
int run(const void* q, const void* kc, const void* vc, const void* pos,
        void* o, void* scores, void* stats, void* partial, int B, int S,
        int H, int KVH, int D, int W, long long sb, long long ss,
        long long sh, int nsplit, float scale, void* stream) {
  const RingPool<T> k{(const T*)kc, sb, ss, sh};
  const RingPool<T> v{(const T*)vc, sb, ss, sh};
  return paged::dispatch<T>(q, k, v, nullptr, (const int*)pos, o,
                            (float*)scores, (float*)stats, (float*)partial,
                            B, S, H, KVH, D, /*n_pages=*/1, /*ps=*/W, nsplit,
                            scale, stream);
}

}  // namespace

// scores: (B, KVH, G*S, wpad) float32, stats: (B, KVH, nsplit, G*S, 2)
// float32 and partial: (B, KVH, nsplit, G*S, D) float32 are scratch the
// wrapper allocates; wpad = W rounded up to 32.
extern "C" int decode_attention_f32(
    const void* q, const void* kc, const void* vc, const void* pos, void* o,
    void* scores, void* stats, void* partial, int B, int S, int H, int KVH,
    int D, int W, long long sb, long long ss, long long sh, int nsplit,
    float scale, void* stream) {
  return run<float>(q, kc, vc, pos, o, scores, stats, partial, B, S, H, KVH,
                    D, W, sb, ss, sh, nsplit, scale, stream);
}

extern "C" int decode_attention_bf16(
    const void* q, const void* kc, const void* vc, const void* pos, void* o,
    void* scores, void* stats, void* partial, int B, int S, int H, int KVH,
    int D, int W, long long sb, long long ss, long long sh, int nsplit,
    float scale, void* stream) {
  return run<__nv_bfloat16>(q, kc, vc, pos, o, scores, stats, partial, B, S,
                            H, KVH, D, W, sb, ss, sh, nsplit, scale, stream);
}
