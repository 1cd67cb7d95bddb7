// The decode sampling tail for Hopper (sm_90a), the port of the Pallas TPU
// kernel ``repro/kernels/topk_sample.py::topk_sample`` (TPU kernel 3).
//
// Two entry points share one radix-select device function over the
// order-isomorphic uint32 image of float32:
//
// * ``sample_tokens`` — what the serving engine calls every decode tick,
//   reproducing the model's twin ``layers.sample_tokens``: greedy rows take
//   the argmax (lowest index on ties); stochastic rows divide by
//   max(T, 1e-6), keep the top-k by a 32-round count radix over the logit
//   bits, take the softmax of the whole row, cut the nucleus by a 32-round
//   mass radix over the restricted weights, and draw by inverse CDF with
//   one uniform per row against min(u * total, nextafter(total, 0)).
// * ``topk_sample`` — the Pallas kernel's own semantics: x = logits/T + 0,
//   keep x >= kth, Gumbel argmax with the caller's (B, V) uniforms.
//
// A row is served by a cluster of CLUSTER = 8 thread blocks (the portable
// cluster size; 1024 threads each) on neighbouring SMs. Block r of the
// cluster keeps the contiguous slice [r * chunk, (r + 1) * chunk) of the
// row's scaled logits in its own shared memory, chunk = ceil(V / 8): a
// recurrentgemma row (V = 256000, 1,024,000 B) is 128,000 B per block,
// and granite's 49152 is 24,576 B. Every block-wide reduction of a radix
// round is then combined across the cluster through distributed shared
// memory: each block publishes its partial in its own shared memory, one
// ``cluster.sync()``, and every block reads the 8 partials in rank order
// (so all 8 get the same value, deterministically). Two publication slots
// alternate, so one barrier per reduction suffices: a slot is rewritten
// only after the next reduction's barrier, which no block passes before
// every block has read the slot. The kernel reads each logit once from
// device memory; the 64 radix rounds and the prefix sum stay on chip.
//
// Every sum over the row (the softmax denominator, the nucleus mass, the
// prefix sum) runs in float64, as in the plain version: a float32 sum
// depends on its order, which cannot follow PyTorch's reductions (at
// 256000 logits, 1 draw in 128 differed); in float64 the order moves it
// by about 1e-16, and the weights themselves stay float32 and equal.
//
// What bounds it: the serial rounds (each a block-wide reduction and a
// cluster barrier), not bytes: B rows occupy 8 B of the 132 SMs.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int CLUSTER = 8;
constexpr int NONE = 0x7fffffff;

// Block-wide float64 sum; every thread gets it. ``red`` holds 33 doubles.
__device__ double block_sum_f64(double v, double* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[w] = v;
  __syncthreads();
  if (w == 0) {
    double x = lane < nw ? red[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const double r = red[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ unsigned mapped_bits(float x) {
  if (x == 0.0f) x = 0.0f;  // -0.0 -> +0.0, the reference's ``x + 0.0``
  const unsigned u = __float_as_uint(x);
  return (u >> 31) == 0 ? (u | 0x80000000u) : ~u;
}

// Reductions over the row a cluster serves. Every thread of every block
// of the cluster must call each one, in the same order.
struct RowCluster {
  cg::cluster_group cl;
  float* xf;   // this block's publication slots, __shared__ float[2],
  int* xi;     // __shared__ int[2]
  double* xd;  // and __shared__ double[2]
  float* redf;  // block reduction scratch, __shared__ [33]
  int* redi;
  double* redd;
  int par;    // the slot of the next reduction

  __device__ __forceinline__ void publish() {
    cl.sync();
  }

  __device__ double sum(double v) {
    v = block_sum_f64(v, redd);
    if (threadIdx.x == 0) xd[par] = v;
    publish();
    double s = 0.0;
    for (int r = 0; r < CLUSTER; ++r) s += *cl.map_shared_rank(xd + par, r);
    par ^= 1;
    return s;
  }

  __device__ float max(float v) {
    v = block_max(v, redf);
    if (threadIdx.x == 0) xf[par] = v;
    publish();
    float m = -INFINITY;
    for (int r = 0; r < CLUSTER; ++r)
      m = fmaxf(m, *cl.map_shared_rank(xf + par, r));
    par ^= 1;
    return m;
  }

  __device__ int sum_int(int v) {
    v = block_sum_int(v, redi);
    if (threadIdx.x == 0) xi[par] = v;
    publish();
    int s = 0;
    for (int r = 0; r < CLUSTER; ++r) s += *cl.map_shared_rank(xi + par, r);
    par ^= 1;
    return s;
  }

  __device__ int min_int(int v) {
    v = block_min_int(v, redi);
    if (threadIdx.x == 0) xi[par] = v;
    publish();
    int m = NONE;
    for (int r = 0; r < CLUSTER; ++r)
      m = min(m, *cl.map_shared_rank(xi + par, r));
    par ^= 1;
    return m;
  }

  // Sum of the values of the ranks before this block's (rank order).
  __device__ double exclusive_sum(double v) {
    if (threadIdx.x == 0) xd[par] = v;
    publish();
    double s = 0.0;
    const int me = (int)cl.block_rank();
    for (int r = 0; r < me; ++r) s += *cl.map_shared_rank(xd + par, r);
    par ^= 1;
    return s;
  }

  // The value thread 0 of block ``src`` publishes (a broadcast).
  __device__ double from_rank(double v, int src) {
    if (threadIdx.x == 0) xd[par] = v;
    publish();
    const double r = *cl.map_shared_rank(xd + par, src);
    par ^= 1;
    return r;
  }

  // (value, index) argmax over the row, lowest index on ties: ``v`` and
  // ``i`` are this thread's best, ``value_of(i)`` the value at an index
  // this block owns.
  template <typename ValueOf>
  __device__ int argmax(float v, int i, ValueOf value_of) {
    const int bi = block_argmax(v, i, redf, redi);
    if (threadIdx.x == 0) {
      xi[par] = bi;
      xf[par] = bi == NONE ? -INFINITY : value_of(bi);
    }
    publish();
    float bv = -INFINITY;
    int best = NONE;
    for (int r = 0; r < CLUSTER; ++r)
      argmax_pair(bv, best, *cl.map_shared_rank(xf + par, r),
                  *cl.map_shared_rank(xi + par, r));
    par ^= 1;
    return best;
  }

  // No block may leave while another can still read its shared memory.
  __device__ __forceinline__ void finish() { cl.sync(); }
};

// The largest t with count(mapped >= t) >= k over the whole row, built
// MSB-first; ``xs`` holds this block's n logits.
__device__ unsigned radix_count(const float* xs, int n, int k,
                                RowCluster& rc) {
  unsigned t = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned cand = t | (1u << bit);
    int cnt = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      cnt += mapped_bits(xs[i]) >= cand;
    if (rc.sum_int(cnt) >= k) t = cand;
  }
  return t;
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
sample_tokens_kernel(const float* __restrict__ logits,
                     const unsigned char* __restrict__ greedy,
                     const float* __restrict__ temperature,
                     const int* __restrict__ top_k,
                     const float* __restrict__ top_p,
                     const float* __restrict__ uniform, int* __restrict__ out,
                     int V, int chunk) {
  extern __shared__ float xs[];  // [chunk] this block's slice of the row
  __shared__ float redf[33];
  __shared__ int redi[33];
  __shared__ double redd[33];
  __shared__ float xf[2];
  __shared__ int xi[2];
  __shared__ double xd[2];
  __shared__ double tot;
  RowCluster rc{cg::this_cluster(), xf, xi, xd, redf, redi, redd, 0};
  const int rank = (int)rc.cl.block_rank();
  const int b = blockIdx.x / CLUSTER, tid = threadIdx.x;
  const int base = min(rank * chunk, V);
  const int n = min(base + chunk, V) - base;  // this block's slice
  const float* row = logits + (size_t)b * V + base;

  if (greedy[b]) {
    float bv = -INFINITY;
    int bi = NONE;
    for (int i = tid; i < n; i += blockDim.x)
      argmax_pair(bv, bi, row[i], base + i);
    const int tok = rc.argmax(bv, bi, [&](int g) { return row[g - base]; });
    if (rank == 0 && tid == 0) out[b] = tok;
    rc.finish();
    return;
  }

  const float temp = fmaxf(temperature[b], 1e-6f);
  for (int i = tid; i < n; i += blockDim.x) xs[i] = row[i] / temp;
  __syncthreads();

  // top-k: the k-th largest logit (rows without a cut keep everything)
  const int k = top_k[b];
  const unsigned kth = k > 0 ? radix_count(xs, n, min(k, V), rc) : 0u;

  // softmax over the WHOLE row; weights zero outside the top-k
  float mx = -INFINITY;
  for (int i = tid; i < n; i += blockDim.x) mx = fmaxf(mx, xs[i]);
  mx = rc.max(mx);
  double zsum = 0.0;
  for (int i = tid; i < n; i += blockDim.x) zsum += expf(xs[i] - mx);
  const float z = (float)rc.sum(zsum);
  auto weight = [&](int i) -> float {
    return mapped_bits(xs[i]) >= kth ? expf(xs[i] - mx) / z : 0.0f;
  };

  // top-p: the largest threshold whose tail keeps top_p of the mass
  const float p = top_p[b];
  unsigned pth = 0u;
  if (p < 1.0f) {
    double wsum = 0.0;
    for (int i = tid; i < n; i += blockDim.x) wsum += weight(i);
    const double target =
        (double)fminf(fmaxf(p, 1e-30f), 1.0f) * rc.sum(wsum);
    for (int bit = 31; bit >= 0; --bit) {
      const unsigned cand = pth | (1u << bit);
      double acc = 0.0;
      for (int i = tid; i < n; i += blockDim.x)
        if (mapped_bits(xs[i]) >= cand) acc += weight(i);
      if (rc.sum(acc) >= target) pth = cand;
    }
  }

  // inverse CDF: each thread owns a contiguous run of the block's slice,
  // so the cumulative sum is its run's running sum on top of an exclusive
  // scan over the block's threads, on top of the earlier blocks' totals
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * per, n), hi = min(lo + per, n);
  auto kept = [&](int i) -> float {
    return mapped_bits(xs[i]) >= pth ? weight(i) : 0.0f;
  };
  double local = 0.0;
  for (int i = lo; i < hi; ++i) local += kept(i);
  // exclusive scan of ``local`` across the block
  const int lane = tid & 31, w = tid >> 5;
  const int nw = blockDim.x >> 5;
  double inc = local;
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) redd[w] = inc;
  __syncthreads();
  if (w == 0) {
    double x = lane < nw ? redd[lane] : 0.0;
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    redd[lane] = x;  // inclusive warp totals
  }
  __syncthreads();
  const double block_total = redd[nw - 1];
  const double in_block = (w > 0 ? redd[w - 1] : 0.0) + (inc - local);
  __syncthreads();
  const double prefix = rc.exclusive_sum(block_total) + in_block;
  // total = the cumulative sum at the row's last index, as the twin's
  // c[-1]: the running sum of the thread that owns it
  const int last = (V - 1) / chunk;  // the block that owns index V - 1
  double run = prefix;
  for (int i = lo; i < hi; ++i) run += kept(i);
  if (lo < hi && hi == n) tot = run;
  __syncthreads();
  const double total = rc.from_rank(rank == last ? tot : 0.0, last);
  const double thresh =
      fmin((double)uniform[b] * total, nextafter(total, 0.0));
  int first = NONE;
  run = prefix;
  for (int i = lo; i < hi; ++i) {
    run += kept(i);
    if (run > thresh) {
      first = base + i;
      break;
    }
  }
  first = rc.min_int(first);
  if (rank == 0 && tid == 0) out[b] = first < V ? first : 0;
  rc.finish();
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
topk_sample_kernel(const float* __restrict__ logits,
                   const int* __restrict__ top_k,
                   const float* __restrict__ temperature,
                   const float* __restrict__ uniform, int* __restrict__ out,
                   int V, int chunk) {
  extern __shared__ float xs[];  // [chunk] this block's slice of the row
  __shared__ float redf[33];
  __shared__ int redi[33];
  __shared__ float xf[2];
  __shared__ int xi[2];
  RowCluster rc{cg::this_cluster(), xf, xi, nullptr, redf, redi, nullptr,
                0};
  const int rank = (int)rc.cl.block_rank();
  const int b = blockIdx.x / CLUSTER, tid = threadIdx.x;
  const int base = min(rank * chunk, V);
  const int n = min(base + chunk, V) - base;
  const float* row = logits + (size_t)b * V + base;
  const float* u = uniform + (size_t)b * V + base;
  const float temp = temperature[b];
  for (int i = tid; i < n; i += blockDim.x) xs[i] = row[i] / temp + 0.0f;
  __syncthreads();
  const unsigned kth = radix_count(xs, n, top_k[b], rc);
  auto score = [&](int i) -> float {
    const float x = xs[i];
    return mapped_bits(x) >= kth ? x - logf(-logf(fmaxf(u[i], 1e-12f)))
                                 : REPRO_NEG;
  };
  float bv = -INFINITY;
  int bi = NONE;
  for (int i = tid; i < n; i += blockDim.x)
    argmax_pair(bv, bi, score(i), base + i);
  const int tok = rc.argmax(bv, bi, [&](int g) { return score(g - base); });
  if (rank == 0 && tid == 0) out[b] = tok;
  rc.finish();
}

template <typename Kernel>
int prepare(Kernel kernel, int V, int& chunk, size_t& smem) {
  chunk = (V + CLUSTER - 1) / CLUSTER;
  smem = sizeof(float) * (size_t)chunk;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int sample_tokens_f32(const void* logits, const void* greedy,
                                 const void* temperature, const void* top_k,
                                 const void* top_p, const void* uniform,
                                 void* out, int B, int V, void* stream) {
  int chunk;
  size_t smem;
  const int err = prepare(sample_tokens_kernel, V, chunk, smem);
  if (err != 0) return err;
  sample_tokens_kernel<<<B * CLUSTER, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const unsigned char*)greedy,
      (const float*)temperature, (const int*)top_k, (const float*)top_p,
      (const float*)uniform, (int*)out, V, chunk);
  return (int)cudaGetLastError();
}

extern "C" int topk_sample_f32(const void* logits, const void* top_k,
                               const void* temperature, const void* uniform,
                               void* out, int B, int V, void* stream) {
  int chunk;
  size_t smem;
  const int err = prepare(topk_sample_kernel, V, chunk, smem);
  if (err != 0) return err;
  topk_sample_kernel<<<B * CLUSTER, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const int*)top_k, (const float*)temperature,
      (const float*)uniform, (int*)out, V, chunk);
  return (int)cudaGetLastError();
}
