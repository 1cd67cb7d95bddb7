// The decode sampling tail for Hopper (sm_90a), the port of the Pallas TPU
// kernel ``repro/kernels/topk_sample.py::topk_sample`` (TPU kernel 3).
//
// Two entry points share one radix select over the order-isomorphic
// uint32 image of float32 (``mapped_bits``):
//
// * ``sample_tokens`` — what the serving engine calls every decode tick,
//   reproducing the model's twin ``layers.sample_tokens``: greedy rows take
//   the argmax (lowest index on ties); stochastic rows divide by
//   max(T, 1e-6), keep the top-k (the k-th largest image, ties kept), take
//   the softmax of the whole row, cut the nucleus (the largest threshold t
//   with sum(w where image >= t) >= top_p * sum(w)) and draw by inverse
//   CDF with one uniform per row against min(u * total, nextafter(total,
//   0)).
// * ``topk_sample`` — the Pallas kernel's own semantics: x = logits/T + 0,
//   keep x >= kth, Gumbel argmax with the caller's (B, V) uniforms.
//
// A row is served by a cluster of CL thread blocks of 512 threads on
// neighbouring SMs (8; or 16, a non-portable size, where 8 blocks cannot
// keep the weights and at most 8 rows share the card: 8 rows busy 128
// SMs); block r keeps the slice [r * chunk, (r + 1) * chunk) of the row's
// scaled logits in its shared memory, so the row is read from device
// memory once, and where it fits (STORE_W) the slice's softmax weights
// beside it, so the passes after the denominator do not compute
// expf(x - m) / z again. A value the cluster must agree on is
// published by each block in its own shared memory, one ``cluster.sync()``
// (a "round"), then read from every block in rank order, so every block
// gets the same bits. Two publication slots of each kind alternate: a
// slot is rewritten only after the next round's barrier, which no block
// passes before every block has read it.
//
// What bounds it: not bytes (one read of the row, 0.5-2.5 us for B 8) but
// the chain of rounds, each a barrier across the cluster and a block-wide
// reduction. The first port ran about 70 of them (32 one-bit rounds of a
// count radix, 32 of a mass radix, 6 more); this design runs 4 to 12:
//
// * the top-k threshold by 8-bit digits: 4 rounds, each a 256-bin integer
//   histogram of the candidates' next digit (shared-memory atomics,
//   aggregated per warp with ``__match_any_sync``; integer sums are exact
//   in any order), summed across the cluster; a suffix scan of the bins
//   picks the digit. The row's max travels with the first round.
// * one round for the softmax denominator (float64) and each block's count
//   of kept values.
// * where at most CAP values are kept (a top-k row, or V <= CAP): the
//   kept values are compacted in index order (an integer prefix across
//   threads and ranks) into rank 0's shared memory, one round, and rank 0
//   alone finds the nucleus threshold and draws, with block barriers only.
//   Thread j holds candidate j and sums, in float64 in index order, the
//   weights of the candidates whose image is >= its own: the largest image
//   whose sum reaches the target is the threshold (the mass radix's answer
//   over the same sums, since that sum is monotone in the image).
// * elsewhere (no top-k, or more than CAP kept) and top_p < 1: the mass
//   radix by 4-bit digits, 8 rounds; each thread sums its values' weights
//   into 16 float64 bins (in a fixed order), each warp reduces them by
//   halving exchanges (16 shuffles, not 80), the block in a fixed tree and
//   the cluster in rank order.
// * the draw over the whole row: 2 rounds (block totals and the block that
//   holds the last kept value, then the first index past the threshold,
//   gathered by an integer atomicMin into rank 0).
//
// Every sum over the row (the softmax denominator, the nucleus mass, the
// prefix sum) runs in float64, as in the plain version, and none depends
// on scheduling (no float atomics), so a repeat call gives the same bits.
// A float32 sum depends on its order, which cannot follow PyTorch's
// reductions (at 256000 logits, 1 draw in 128 differed); in float64 the
// order moves it by about 1e-16, and the weights themselves stay float32
// and equal. The total the draw scales is the cumulative sum at the last
// kept value exactly as the search computes it there, as the twin's c[-1]
// is its own cumulative sum, so the draw always lands on a kept value.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CAP = 512;  // kept values the one-block nucleus takes
constexpr int NONE = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;
// rows by path, counted in ``path_rows``
enum Path { GREEDY = 0, CANDIDATES = 1, MASS_RADIX = 2, WHOLE_ROW = 3 };

struct Shared {
  // publication slots (two of each kind), read by the cluster
  int hist[2][256];
  double bins[2][16];
  double pd[2][2];
  int pi[2];
  float pf[2];
  int first;  // rank 0's: the drawn index, by atomicMin from every block
  // block-local
  int cnt[256];
  int scan8[8];
  double gbin[16];
  double red16[WARPS][16];
  double red[33];  // reduction scratch, any type of up to 8 bytes
  float cx[CAP];   // rank 0's: the kept values in index order
  int ci[CAP];     // and their indices
  float cw[CAP];
  unsigned cm[CAP];
  float mx;
  double z, tail, prefix, total;
  int koff, nkept, digit, above;
};

__device__ __forceinline__ unsigned mapped_bits(float x) {
  if (x == 0.0f) x = 0.0f;  // -0.0 -> +0.0, the reference's ``x + 0.0``
  const unsigned u = __float_as_uint(x);
  return (u >> 31) == 0 ? (u | 0x80000000u) : ~u;
}

// Block-wide reduction in a fixed tree (xor butterflies, lane 0 of each
// warp, then warp 0): every thread must call it and gets lane 0's result.
template <typename T, typename Op>
__device__ T block_reduce(T v, Shared& sh, T id, Op op) {
  T* red = reinterpret_cast<T*>(sh.red);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    T x = lane < WARPS ? red[lane] : id;
    for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(FULL, x, o));
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const T r = red[32];
  __syncthreads();
  return r;
}

struct Plus {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};
struct Min {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a < b ? a : b; }
};

// Inclusive prefix sum over the block in thread order (Kogge-Stone in each
// warp, then over the warp totals); ``total`` gets the block's sum.
template <typename T>
__device__ T block_scan(T v, Shared& sh, T& total) {
  T* red = reinterpret_cast<T*>(sh.red);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  T inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) red[w] = inc;
  __syncthreads();
  if (w == 0) {
    T x = lane < WARPS ? red[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    red[lane] = x;  // inclusive warp totals
  }
  __syncthreads();
  const T r = (w > 0 ? red[w - 1] : T(0)) + inc;
  total = red[WARPS - 1];
  __syncthreads();
  return r;
}

// The exclusive form: the sum of the threads before this one (the
// warp's own part shifted by one lane, not ``inclusive - v``).
template <typename T>
__device__ T block_scan_exclusive(T v, Shared& sh, T& total) {
  T* red = reinterpret_cast<T*>(sh.red);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  T inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  T ex = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) ex = T(0);
  if (lane == 31) red[w] = inc;
  __syncthreads();
  if (w == 0) {
    T x = lane < WARPS ? red[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    red[lane] = x;
  }
  __syncthreads();
  const T r = w > 0 ? red[w - 1] + ex : ex;
  total = red[WARPS - 1];
  __syncthreads();
  return r;
}

// This thread's contiguous run [lo, hi) of the block's n values, for the
// passes that need index order. The run length is odd, so a warp's 32
// runs start in 32 different shared-memory banks.
__device__ __forceinline__ void run_of(int n, int& lo, int& hi) {
  const int per = ((n + THREADS - 1) / THREADS) | 1;
  lo = min((int)threadIdx.x * per, n);
  hi = min(lo + per, n);
}

// The k-th largest image over the row (1 <= kk <= V): the largest t with
// count(image >= t) >= kk, by 8-bit digits, most significant first, one
// round each. The block's max ``lmax`` travels with the first round; the
// row's max comes back in ``mx``.
template <int CL>
__device__ unsigned radix_count(const float* xs, int n, int kk, Shared& sh,
                                cg::cluster_group& cl, int& par, float lmax,
                                float& mx) {
  const int tid = threadIdx.x, lane = tid & 31;
  unsigned P = 0;
  int above = 0;  // values whose higher digits exceed P's
  for (int d = 0; d < 4; ++d) {
    const int shift = 24 - 8 * d;
    const unsigned hi = d == 0 ? 0u : (FULL << (shift + 8));
    int* h = sh.hist[par];  // zeroed at the start or by the last round
    for (int i0 = 0; i0 < n; i0 += THREADS) {
      const int i = i0 + tid;
      unsigned key = FULL;
      if (i < n) {
        const unsigned u = mapped_bits(xs[i]);
        if ((u & hi) == P) key = (u >> shift) & 255u;
      }
      const unsigned same = __match_any_sync(FULL, key);
      if (key != FULL && lane == __ffs(same) - 1)
        atomicAdd(&h[key], __popc(same));
    }
    if (d == 0 && tid == 0) sh.pf[par] = lmax;
    cl.sync();
    int v = 0;
    if (tid < 256) {
      const int j = 255 - tid;  // thread order runs from the top digit
      for (int r = 0; r < CL; ++r) v += cl.map_shared_rank(h, r)[j];
      sh.hist[par ^ 1][tid] = 0;  // every block has read it (last round)
    }
    if (d == 0 && tid == 0) {
      float m = -INFINITY;
      for (int r = 0; r < CL; ++r)
        m = fmaxf(m, *cl.map_shared_rank(&sh.pf[par], r));
      sh.mx = m;
    }
    // suffix sums of the 256 bins: thread tid < 256 holds digit 255 - tid
    int inc = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += y;
    }
    if (tid < 256 && lane == 31) sh.scan8[tid >> 5] = inc;
    __syncthreads();
    if (tid < 256) {
      int s = inc;  // count of images with this prefix and digit >= j
      for (int w = 0; w < (tid >> 5); ++w) s += sh.scan8[w];
      if (above + s >= kk && above + s - v < kk) {
        sh.digit = 255 - tid;
        sh.above = above + s - v;
      }
    }
    __syncthreads();
    P |= (unsigned)sh.digit << shift;
    above = sh.above;
    par ^= 1;
  }
  mx = sh.mx;
  return P;
}

// The warp's sums of 16 bins, in a fixed pattern: four halving exchanges
// (each lane keeps half of its bins and adds its partner's copy of them,
// 8 + 4 + 2 + 1 shuffles) leave lane l with one bin summed over 16 lanes,
// and one more exchange with lane l ^ 1 completes it (a + b and b + a are
// the same bits). 16 shuffles of a double, where a butterfly per bin took
// 80. Bit 4 of l picked the upper 8 bins, bit 3 the upper 4 of those, and
// so on: even lane l writes bin 8 b4 + 4 b3 + 2 b2 + b1 of its bits.
__device__ __forceinline__ void warp_bins(const double (&acc)[16],
                                          double* out) {
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  double v8[8], v4[4], v2[2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v8[j] = (b4 ? acc[j + 8] : acc[j]) +
            __shfl_xor_sync(FULL, b4 ? acc[j] : acc[j + 8], 16);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v4[j] = (b3 ? v8[j + 4] : v8[j]) +
            __shfl_xor_sync(FULL, b3 ? v8[j] : v8[j + 4], 8);
#pragma unroll
  for (int j = 0; j < 2; ++j)
    v2[j] = (b2 ? v4[j + 2] : v4[j]) +
            __shfl_xor_sync(FULL, b2 ? v4[j] : v4[j + 2], 4);
  double v = (b1 ? v2[1] : v2[0]) + __shfl_xor_sync(FULL, b1 ? v2[0] : v2[1], 2);
  v += __shfl_xor_sync(FULL, v, 1);
  if ((lane & 1) == 0) out[8 * b4 + 4 * b3 + 2 * b2 + b1] = v;
}

// The nucleus threshold over the whole row (rows without a candidate
// set): the largest t with sum(w where image >= t) >= target, target =
// top_p * sum(w), by 4-bit digits, one round each. ``w(i)`` is the
// weight of the block's value i (0 outside the top-k).
template <int CL, typename Weight>
__device__ unsigned mass_radix(const float* xs, int n, unsigned kth,
                               float p, Weight w, Shared& sh,
                               cg::cluster_group& cl, int& par) {
  const int tid = threadIdx.x, wp = tid >> 5;
  unsigned P = 0;
  double A = 0.0, target = 0.0;  // A: the mass above P's prefix
  for (int d = 0; d < 8; ++d) {
    const int shift = 28 - 4 * d;
    const unsigned hi = d == 0 ? 0u : (FULL << (shift + 4));
    double acc[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) acc[q] = 0.0;
    for (int i = tid; i < n; i += THREADS) {
      const unsigned u = mapped_bits(xs[i]);
      if ((u & hi) == P && u >= kth) {
        const double wv = (double)w(i);
        const unsigned dg = (u >> shift) & 15u;
#pragma unroll
        for (int q = 0; q < 16; ++q) acc[q] += dg == (unsigned)q ? wv : 0.0;
      }
    }
    warp_bins(acc, sh.red16[wp]);
    __syncthreads();
    if (tid < 16) {
      double s = 0.0;
      for (int k = 0; k < WARPS; ++k) s += sh.red16[k][tid];
      sh.bins[par][tid] = s;
    }
    cl.sync();
    if (tid < 16) {
      double g = 0.0;
      for (int r = 0; r < CL; ++r) g += cl.map_shared_rank(sh.bins[par], r)[tid];
      sh.gbin[tid] = g;
    }
    __syncthreads();
    // every thread makes the same choice from the same bits
    if (d == 0) {
      double t = 0.0;
      for (int q = 15; q >= 0; --q) t += sh.gbin[q];
      target = (double)fminf(fmaxf(p, 1e-30f), 1.0f) * t;
    }
    int sel = -1;
    double a_new = A, sfx = 0.0, above0 = 0.0;
    for (int q = 15; q >= 0; --q) {
      if (q == 0) above0 = sfx;
      const double s2 = sfx + sh.gbin[q];
      if (sel < 0 && A + s2 >= target) {
        sel = q;
        a_new = A + sfx;
      }
      sfx = s2;
    }
    if (sel < 0) {  // rounding: the last round's choice already holds
      sel = 0;
      a_new = A + above0;
    }
    P |= (unsigned)sel << shift;
    A = a_new;
    par ^= 1;
  }
  return P;
}

// Scaled logits of this block's slice into shared memory (16-byte loads
// where the slice is aligned); returns this thread's max of them.
template <bool PLUS_ZERO>
__device__ float load_slice(const float* row, float* xs, int n, float temp) {
  float m = -INFINITY;
  auto scale = [&](float v) {
    const float s = PLUS_ZERO ? v / temp + 0.0f : v / temp;
    m = fmaxf(m, s);
    return s;
  };
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    float4* x4 = reinterpret_cast<float4*>(xs);
    const int n4 = n / 4;
#pragma unroll 4
    for (int q = threadIdx.x; q < n4; q += THREADS) {
      float4 v = __ldg(r4 + q);
      v.x = scale(v.x);
      v.y = scale(v.y);
      v.z = scale(v.z);
      v.w = scale(v.w);
      x4[q] = v;
    }
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < n; i += THREADS) xs[i] = scale(row[i]);
  __syncthreads();
  return m;
}

// STORE_W: the block's weights are kept in shared memory beside its
// logits (where both fit), so the passes after the softmax denominator read
// them instead of computing expf(x - m) / z again.
template <int CL, bool STORE_W>
__global__ void __launch_bounds__(THREADS)
sample_tokens_kernel(const float* __restrict__ logits,
                     const unsigned char* __restrict__ greedy,
                     const float* __restrict__ temperature,
                     const int* __restrict__ top_k,
                     const float* __restrict__ top_p,
                     const float* __restrict__ uniform, int* __restrict__ out,
                     int* __restrict__ path_rows, int V, int chunk) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);  // [chunk] this block's slice
  float* ws = xs + chunk;  // [chunk] its weights, where STORE_W
  __shared__ Shared sh;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / CL, tid = threadIdx.x;
  const int base = min(rank * chunk, V);
  const int n = min(base + chunk, V) - base;
  const float* row = logits + (size_t)b * V + base;
  int par = 0;
  if (tid < 256) sh.hist[0][tid] = sh.hist[1][tid] = 0;
  if (tid == 0) sh.first = NONE;

  if (greedy[b]) {
    float bv = -INFINITY;
    int bi = NONE;
    for (int i = tid; i < n; i += THREADS) argmax_pair(bv, bi, row[i], base + i);
    bi = block_argmax(bv, bi, reinterpret_cast<float*>(sh.red),
                      reinterpret_cast<int*>(sh.red) + 33);
    if (tid == 0) {
      sh.pi[0] = bi;
      sh.pf[0] = bi == NONE ? -INFINITY : row[bi - base];
    }
    cl.sync();
    if (rank == 0 && tid == 0) {
      float v = -INFINITY;
      int t = NONE;
      for (int r = 0; r < CL; ++r)
        argmax_pair(v, t, *cl.map_shared_rank(&sh.pf[0], r),
                    *cl.map_shared_rank(&sh.pi[0], r));
      out[b] = t < V ? t : 0;
      atomicAdd(path_rows + GREEDY, 1);
    }
    cl.sync();  // no block leaves while rank 0 reads its shared memory
    return;
  }

  const float temp = fmaxf(temperature[b], 1e-6f);
  const float lmax = block_reduce(load_slice<false>(row, xs, n, temp), sh,
                                  -INFINITY, Max());

  // top-k: the k-th largest image (rows without a cut keep everything)
  const int k = top_k[b];
  const int kk = k > 0 ? min(k, V) : 0;
  unsigned kth = 0u;
  float mx;
  if (kk > 0) {
    kth = radix_count<CL>(xs, n, kk, sh, cl, par, lmax, mx);
  } else {
    if (tid == 0) sh.pf[par] = lmax;
    cl.sync();
    if (tid == 0) {
      float m = -INFINITY;
      for (int r = 0; r < CL; ++r)
        m = fmaxf(m, *cl.map_shared_rank(&sh.pf[par], r));
      sh.mx = m;
    }
    __syncthreads();
    mx = sh.mx;
    par ^= 1;
  }

  // the softmax denominator over the WHOLE row, and the kept counts
  double zs = 0.0;
  int kc = 0;
  for (int i = tid; i < n; i += THREADS) {
    const float e = expf(xs[i] - mx);
    zs += (double)e;
    kc += mapped_bits(xs[i]) >= kth;
    if (STORE_W) ws[i] = e;
  }
  zs = block_reduce(zs, sh, 0.0, Plus());
  kc = block_reduce(kc, sh, 0, Plus());
  if (tid == 0) {
    sh.pd[par][0] = zs;
    sh.pi[par] = kc;
  }
  cl.sync();
  if (tid == 0) {
    double zz = 0.0;
    int off = 0, all = 0;
    for (int r = 0; r < CL; ++r) {
      zz += *cl.map_shared_rank(&sh.pd[par][0], r);
      const int c = *cl.map_shared_rank(&sh.pi[par], r);
      off += r < rank ? c : 0;
      all += c;
    }
    sh.z = zz;
    sh.koff = off;
    sh.nkept = all;
  }
  __syncthreads();
  const float z = (float)sh.z;
  const int nkept = sh.nkept;
  par ^= 1;
  auto weight = [&](float xv) -> float {
    return mapped_bits(xv) >= kth ? expf(xv - mx) / z : 0.0f;
  };
  const float p = top_p[b];

  if (nkept <= CAP) {
    // -- the kept values, in index order, into rank 0 --------------------
    int lo, hi, unused;
    run_of(n, lo, hi);
    int c = 0;
    for (int i = lo; i < hi; ++i) c += mapped_bits(xs[i]) >= kth;
    int pos = sh.koff + block_scan_exclusive(c, sh, unused);
    float* dx = cl.map_shared_rank(sh.cx, 0);
    int* di = cl.map_shared_rank(sh.ci, 0);
    for (int i = lo; i < hi; ++i) {
      if (mapped_bits(xs[i]) >= kth) {
        dx[pos] = xs[i];
        di[pos] = base + i;
        ++pos;
      }
    }
    cl.sync();
    if (rank != 0) return;  // nothing reads another block from here on

    const int j = tid;
    const bool has = j < nkept;
    const float xj = has ? sh.cx[j] : 0.0f;
    const unsigned mj = mapped_bits(xj);
    const float wj = has ? expf(xj - mx) / z : 0.0f;
    if (has) {
      sh.cw[j] = wj;
      sh.cm[j] = mj;
    }
    unsigned pth = 0u;
    if (p < 1.0f) {
      const double target =
          (double)fminf(fmaxf(p, 1e-30f), 1.0f) *
          block_reduce(has ? (double)wj : 0.0, sh, 0.0, Plus());
      // the mass at or above this candidate's image, in index order (four
      // interleaved sums, the same for every candidate: monotone in mj)
      double f0 = 0.0, f1 = 0.0, f2 = 0.0, f3 = 0.0;
      if (has) {
        int i = 0;
        for (; i + 4 <= nkept; i += 4) {
          f0 += sh.cm[i] >= mj ? (double)sh.cw[i] : 0.0;
          f1 += sh.cm[i + 1] >= mj ? (double)sh.cw[i + 1] : 0.0;
          f2 += sh.cm[i + 2] >= mj ? (double)sh.cw[i + 2] : 0.0;
          f3 += sh.cm[i + 3] >= mj ? (double)sh.cw[i + 3] : 0.0;
        }
        for (; i < nkept; ++i) f0 += sh.cm[i] >= mj ? (double)sh.cw[i] : 0.0;
      }
      const double f = (f0 + f1) + (f2 + f3);
      pth = block_reduce(has && f >= target ? mj : 0u, sh, 0u, Max());
    }
    const bool keep = has && mj >= pth && wj > 0.0f;
    double unused_total;
    const double cj = block_scan(keep ? (double)wj : 0.0, sh, unused_total);
    const int last = block_reduce(keep ? j : -1, sh, -1, Max());
    if (j == last) sh.total = cj;
    __syncthreads();
    const double total = last >= 0 ? sh.total : 0.0;
    const double thresh =
        fmin((double)uniform[b] * total, nextafter(total, 0.0));
    const int first = block_reduce(keep && cj > thresh ? j : NONE, sh,
                                   NONE, Min());
    if (tid == 0) {
      out[b] = first != NONE ? sh.ci[first] : 0;
      atomicAdd(path_rows + CANDIDATES, 1);
    }
    return;
  }

  // -- the whole row: nucleus by the mass radix, then the draw -------------
  if (STORE_W) {  // each thread its own values, as the pass above
    for (int i = tid; i < n; i += THREADS)
      ws[i] = mapped_bits(xs[i]) >= kth ? ws[i] / z : 0.0f;
    __syncthreads();
  }
  auto weight_at = [&](int i) -> float {
    return STORE_W ? ws[i] : weight(xs[i]);
  };
  const unsigned pth =
      p < 1.0f ? mass_radix<CL>(xs, n, kth, p, weight_at, sh, cl, par) : 0u;
  auto kw = [&](int i) -> float {
    return mapped_bits(xs[i]) >= pth ? weight_at(i) : 0.0f;
  };
  // the cumulative sum at value i of this block is prefix + inner_i, inner
  // the thread's running sum from its exclusive offset in the block
  int lo, hi;
  run_of(n, lo, hi);
  double local = 0.0;
  bool any = false;
  for (int i = lo; i < hi; ++i) {
    const float wv = kw(i);
    local += wv;
    any |= wv > 0.0f;
  }
  double block_total;
  const double excl = block_scan_exclusive(local, sh, block_total);
  const int last = block_reduce(any ? tid : -1, sh, -1, Max());
  if (tid == last) {
    double inner = excl;
    for (int i = lo; i < hi; ++i) inner += kw(i);
    sh.tail = inner;
  }
  __syncthreads();
  if (tid == 0) {
    sh.pd[par][0] = block_total;
    sh.pd[par][1] = last >= 0 ? sh.tail : 0.0;
    sh.pi[par] = last >= 0;
  }
  cl.sync();
  if (tid == 0) {
    // total: the cumulative sum at the row's last kept value, as the block
    // that holds it computes it there
    double pre = 0.0, mine = 0.0, total = 0.0;
    for (int r = 0; r < CL; ++r) {
      if (r == rank) mine = pre;
      if (*cl.map_shared_rank(&sh.pi[par], r))
        total = pre + *cl.map_shared_rank(&sh.pd[par][1], r);
      pre += *cl.map_shared_rank(&sh.pd[par][0], r);
    }
    sh.prefix = mine;
    sh.total = total;
  }
  __syncthreads();
  par ^= 1;
  const double prefix = sh.prefix, total = sh.total;
  const double thresh =
      fmin((double)uniform[b] * total, nextafter(total, 0.0));
  int first = NONE;
  double inner = excl;
  for (int i = lo; i < hi; ++i) {
    const float wv = kw(i);
    inner += wv;
    if (wv > 0.0f && prefix + inner > thresh) {
      first = base + i;
      break;
    }
  }
  first = block_reduce(first, sh, NONE, Min());
  if (tid == 0) atomicMin(cl.map_shared_rank(&sh.first, 0), first);
  cl.sync();
  if (rank == 0 && tid == 0) {
    out[b] = sh.first < V ? sh.first : 0;
    atomicAdd(path_rows + (p < 1.0f ? MASS_RADIX : WHOLE_ROW), 1);
  }
}

template <int CL>
__global__ void __launch_bounds__(THREADS)
topk_sample_kernel(const float* __restrict__ logits,
                   const int* __restrict__ top_k,
                   const float* __restrict__ temperature,
                   const float* __restrict__ uniform, int* __restrict__ out,
                   int V, int chunk) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);
  __shared__ Shared sh;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int b = blockIdx.x / CL, tid = threadIdx.x;
  const int base = min(rank * chunk, V);
  const int n = min(base + chunk, V) - base;
  const float* u = uniform + (size_t)b * V + base;
  int par = 0;
  if (tid < 256) sh.hist[0][tid] = sh.hist[1][tid] = 0;
  load_slice<true>(logits + (size_t)b * V + base, xs, n, temperature[b]);
  // the largest t with count(image >= t) >= k: none is >= 0xffffffff
  // for k <= 0, and every value is kept for k >= V
  const int k = top_k[b];
  float mx;
  const unsigned kth =
      k <= 0 ? FULL
             : k >= V ? 0u
                      : radix_count<CL>(xs, n, k, sh, cl, par, -INFINITY, mx);
  auto score = [&](int i) -> float {
    const float x = xs[i];
    return mapped_bits(x) >= kth ? x - logf(-logf(fmaxf(u[i], 1e-12f)))
                                 : REPRO_NEG;
  };
  float bv = -INFINITY;
  int bi = NONE;
  for (int i = tid; i < n; i += THREADS) argmax_pair(bv, bi, score(i), base + i);
  bi = block_argmax(bv, bi, reinterpret_cast<float*>(sh.red),
                    reinterpret_cast<int*>(sh.red) + 33);
  if (tid == 0) {
    sh.pi[par] = bi;
    sh.pf[par] = bi == NONE ? -INFINITY : score(bi - base);
  }
  cl.sync();
  if (rank == 0 && tid == 0) {
    float v = -INFINITY;
    int t = NONE;
    for (int r = 0; r < CL; ++r)
      argmax_pair(v, t, *cl.map_shared_rank(&sh.pf[par], r),
                  *cl.map_shared_rank(&sh.pi[par], r));
    out[b] = t < V ? t : 0;
  }
  cl.sync();
}

int chunk_of(int V, int CL) { return ((V + CL - 1) / CL + 3) / 4 * 4; }

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int B, int V, int CL, int arrays,
           cudaStream_t stream, Args... args) {
  const int chunk = chunk_of(V, CL);
  const size_t smem = sizeof(float) * (size_t)chunk * arrays;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && CL > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args..., V, chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// cluster: blocks per row, 8 or 16; store_w: keep the weights beside the
// logits (twice the dynamic shared memory); path_rows: 4 int counters
// (rows by path: greedy, candidates, mass radix, whole row), added to per
// row.
extern "C" int sample_tokens_f32(const void* logits, const void* greedy,
                                 const void* temperature, const void* top_k,
                                 const void* top_p, const void* uniform,
                                 void* out, void* path_rows, int B, int V,
                                 int cluster, int store_w, void* stream) {
  const auto st = (cudaStream_t)stream;
  auto go = [&](auto kernel, int cl) {
    return launch(kernel, B, V, cl, store_w ? 2 : 1, st,
                  (const float*)logits,
                  (const unsigned char*)greedy, (const float*)temperature,
                  (const int*)top_k, (const float*)top_p,
                  (const float*)uniform, (int*)out, (int*)path_rows);
  };
  if (cluster == 8)
    return store_w ? go(sample_tokens_kernel<8, true>, 8)
                   : go(sample_tokens_kernel<8, false>, 8);
  if (cluster == 16)
    return store_w ? go(sample_tokens_kernel<16, true>, 16)
                   : go(sample_tokens_kernel<16, false>, 16);
  return (int)cudaErrorInvalidValue;
}

extern "C" int topk_sample_f32(const void* logits, const void* top_k,
                               const void* temperature, const void* uniform,
                               void* out, int B, int V, int cluster,
                               void* stream) {
  const auto st = (cudaStream_t)stream;
  auto go = [&](auto kernel, int cl) {
    return launch(kernel, B, V, cl, 1, st, (const float*)logits,
                  (const int*)top_k, (const float*)temperature,
                  (const float*)uniform, (int*)out);
  };
  if (cluster == 8) return go(topk_sample_kernel<8>, 8);
  if (cluster == 16) return go(topk_sample_kernel<16>, 16);
  return (int)cudaErrorInvalidValue;
}

// The static shared memory of ``sample_tokens`` at this cluster size, in
// bytes (the wrapper's limit on the vocabulary adds it to the slice), or
// minus a CUDA error.
extern "C" int sample_tokens_static_smem(int cluster) {
  cudaFuncAttributes a;
  const cudaError_t err =
      cluster == 16 ? cudaFuncGetAttributes(&a, sample_tokens_kernel<16, true>)
                    : cudaFuncGetAttributes(&a, sample_tokens_kernel<8, true>);
  return err == cudaSuccess ? (int)a.sharedSizeBytes : -(int)err;
}

// How many clusters of this size, each block holding a slice of a
// vocabulary of V (and its weights, where store_w), the card can run at
// once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int sample_tokens_max_clusters(int V, int cluster, int store_w) {
  auto count = [&](auto kernel) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes =
        sizeof(float) * (size_t)chunk_of(V, cluster) * (store_w ? 2 : 1);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cfg.dynamicSmemBytes);
    if (err == cudaSuccess && cluster > 8)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return err == cudaSuccess ? n : -(int)err;
  };
  if (cluster == 8)
    return store_w ? count(sample_tokens_kernel<8, true>)
                   : count(sample_tokens_kernel<8, false>);
  if (cluster == 16)
    return store_w ? count(sample_tokens_kernel<16, true>)
                   : count(sample_tokens_kernel<16, false>);
  return -(int)cudaErrorInvalidValue;
}
