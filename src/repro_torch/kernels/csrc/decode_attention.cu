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
// What bounds it: the bytes of the valid K/V rows (recurrentgemma: 8
// slots x 2048 rows x 1 kv head x 256 x 2 B x 2 = 16.8 MB per layer in
// bf16), read once for the G = 16 query heads sharing the kv head, with
// each slot's ring split over enough blocks to fill the card.
//
// bfloat16 (``decode_attention_bf16``) runs the one-pass kernel of
// ``decode_sm90.cuh`` on the tensor cores: an online softmax like the
// Pallas kernel's, P = exp(s - m) rounded to bf16 before normalization,
// the splits merged through a thread-block cluster's shared memory in one
// launch. float32 (``decode_attention_f32``) is an instantiation of the
// three-launch machinery of ``paged_decode.cuh`` (a ring is one page of W
// rows per slot), whose numerics are those of the plain version
// ``plain.decode_attention``: the row's global max and sum, normalized
// probabilities rounded to q's type before P V, in float32 FMAs (the 2e-5
// gate and the CUDA == CPU float32 streams need float32 arithmetic).
#include "decode_sm90.cuh"

namespace {

// A ring (B, W, KVH, D) of T read through its strides: the three-launch
// kernels copy a tile of its rows with 16-byte loads (TileLoader), the
// one-pass kernel takes each row's address (``paged::SlotRows``).
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

}  // namespace

// scores: (B, KVH, G*S, wpad) float32, stats: (B, KVH, nsplit, G*S, 2)
// float32 and partial: (B, KVH, nsplit, G*S, D) float32 are scratch the
// wrapper allocates; wpad = W rounded up to 32.
extern "C" int decode_attention_f32(
    const void* q, const void* kc, const void* vc, const void* pos, void* o,
    void* scores, void* stats, void* partial, int B, int S, int H, int KVH,
    int D, int W, long long sb, long long ss, long long sh, int nsplit,
    float scale, void* stream) {
  const RingPool<float> k{(const float*)kc, sb, ss, sh};
  const RingPool<float> v{(const float*)vc, sb, ss, sh};
  return paged::dispatch(q, k, v, nullptr, (const int*)pos, o, (float*)scores,
                         (float*)stats, (float*)partial, B, S, H, KVH, D,
                         /*n_pages=*/1, /*ps=*/W, nsplit, scale, stream);
}

// nsplit splits per (slot, kv head), one thread-block cluster: a power
// of two up to 8 (``decode_attention.n_splits_sm90``).
extern "C" int decode_attention_bf16(
    const void* q, const void* kc, const void* vc, const void* pos, void* o,
    int B, int S, int H, int KVH, int D, int W, long long sb, long long ss,
    long long sh, int nsplit, float scale, void* stream) {
  using T = __nv_bfloat16;
  const RingPool<T> k{(const T*)kc, sb, ss, sh};
  const RingPool<T> v{(const T*)vc, sb, ss, sh};
  return sm90::dispatch(q, k, v, (const int*)pos, o, B, S, H, KVH, D, W,
                        nsplit, scale, stream);
}
