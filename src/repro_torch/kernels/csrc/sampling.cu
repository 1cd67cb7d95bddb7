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
// One block of 1024 threads per row. The row's scaled logits stay in
// shared memory (a granite row is 49152 * 4 B = 196,608 B, inside one
// block's 227 KB), so the 64 radix rounds and the prefix sum never go
// back to device memory: the kernel reads each logit once. What bounds it
// is the block's serial rounds (each a block-wide reduction), not bytes:
// B rows occupy only B of the 132 SMs.
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;

__device__ __forceinline__ unsigned mapped_bits(float x) {
  if (x == 0.0f) x = 0.0f;  // -0.0 -> +0.0, the reference's ``x + 0.0``
  const unsigned u = __float_as_uint(x);
  return (u >> 31) == 0 ? (u | 0x80000000u) : ~u;
}

// The largest t with count(mapped >= t) >= k, built MSB-first.
__device__ unsigned radix_count(const float* xs, int V, int k, int* redi) {
  unsigned t = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned cand = t | (1u << bit);
    int cnt = 0;
    for (int i = threadIdx.x; i < V; i += blockDim.x)
      cnt += mapped_bits(xs[i]) >= cand;
    cnt = block_sum_int(cnt, redi);
    if (cnt >= k) t = cand;
  }
  return t;
}

__global__ void __launch_bounds__(THREADS)
sample_tokens_kernel(const float* __restrict__ logits,
                     const unsigned char* __restrict__ greedy,
                     const float* __restrict__ temperature,
                     const int* __restrict__ top_k,
                     const float* __restrict__ top_p,
                     const float* __restrict__ uniform, int* __restrict__ out,
                     int V) {
  extern __shared__ float xs[];  // [V]
  __shared__ float redf[33];
  __shared__ int redi[33];
  __shared__ float tot;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* row = logits + (size_t)b * V;

  if (greedy[b]) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int i = tid; i < V; i += blockDim.x) argmax_pair(bv, bi, row[i], i);
    const int tok = block_argmax(bv, bi, redf, redi);
    if (tid == 0) out[b] = tok;
    return;
  }

  const float temp = fmaxf(temperature[b], 1e-6f);
  for (int i = tid; i < V; i += blockDim.x) xs[i] = row[i] / temp;
  __syncthreads();

  // top-k: the k-th largest logit (rows without a cut keep everything)
  const int k = top_k[b];
  const unsigned kth = k > 0 ? radix_count(xs, V, min(k, V), redi) : 0u;

  // softmax over the WHOLE row; weights zero outside the top-k
  float mx = -INFINITY;
  for (int i = tid; i < V; i += blockDim.x) mx = fmaxf(mx, xs[i]);
  mx = block_max(mx, redf);
  float z = 0.0f;
  for (int i = tid; i < V; i += blockDim.x) z += expf(xs[i] - mx);
  z = block_sum(z, redf);
  auto weight = [&](int i) -> float {
    return mapped_bits(xs[i]) >= kth ? expf(xs[i] - mx) / z : 0.0f;
  };

  // top-p: the largest threshold whose tail keeps top_p of the mass
  const float p = top_p[b];
  unsigned pth = 0u;
  if (p < 1.0f) {
    float wsum = 0.0f;
    for (int i = tid; i < V; i += blockDim.x) wsum += weight(i);
    const float target = fminf(fmaxf(p, 1e-30f), 1.0f) * block_sum(wsum, redf);
    for (int bit = 31; bit >= 0; --bit) {
      const unsigned cand = pth | (1u << bit);
      float acc = 0.0f;
      for (int i = tid; i < V; i += blockDim.x)
        if (mapped_bits(xs[i]) >= cand) acc += weight(i);
      acc = block_sum(acc, redf);
      if (acc >= target) pth = cand;
    }
  }

  // inverse CDF: each thread owns a contiguous chunk, so the cumulative
  // sum is its chunk's running sum on top of an exclusive block scan
  const int chunk = (V + blockDim.x - 1) / blockDim.x;
  const int lo = min(tid * chunk, V), hi = min(lo + chunk, V);
  auto kept = [&](int i) -> float {
    return mapped_bits(xs[i]) >= pth ? weight(i) : 0.0f;
  };
  float local = 0.0f;
  for (int i = lo; i < hi; ++i) local += kept(i);
  // exclusive scan of ``local`` across the block
  const int lane = tid & 31, w = tid >> 5;
  float inc = local;
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) redf[w] = inc;
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    float x = lane < nw ? redf[lane] : 0.0f;
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    redf[lane] = x;  // inclusive warp totals
  }
  __syncthreads();
  const float prefix = (w > 0 ? redf[w - 1] : 0.0f) + (inc - local);
  __syncthreads();
  // total = the cumulative sum at the last index, as the twin's c[-1]
  float run = prefix;
  for (int i = lo; i < hi; ++i) run += kept(i);
  if (lo < hi && hi == V) tot = run;
  __syncthreads();
  const float total = tot;
  const float thresh = fminf(uniform[b] * total, nextafterf(total, 0.0f));
  int first = V;
  run = prefix;
  for (int i = lo; i < hi; ++i) {
    run += kept(i);
    if (run > thresh) {
      first = i;
      break;
    }
  }
  first = block_min_int(first, redi);
  if (tid == 0) out[b] = first < V ? first : 0;
}

__global__ void __launch_bounds__(THREADS)
topk_sample_kernel(const float* __restrict__ logits,
                   const int* __restrict__ top_k,
                   const float* __restrict__ temperature,
                   const float* __restrict__ uniform, int* __restrict__ out,
                   int V) {
  extern __shared__ float xs[];  // [V]
  __shared__ float redf[33];
  __shared__ int redi[33];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* row = logits + (size_t)b * V;
  const float* u = uniform + (size_t)b * V;
  const float temp = temperature[b];
  for (int i = tid; i < V; i += blockDim.x) xs[i] = row[i] / temp + 0.0f;
  __syncthreads();
  const unsigned kth = radix_count(xs, V, top_k[b], redi);
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int i = tid; i < V; i += blockDim.x) {
    const float x = xs[i];
    const float zi = mapped_bits(x) >= kth
                         ? x - logf(-logf(fmaxf(u[i], 1e-12f)))
                         : REPRO_NEG;
    argmax_pair(bv, bi, zi, i);
  }
  const int tok = block_argmax(bv, bi, redf, redi);
  if (tid == 0) out[b] = tok;
}

}  // namespace

extern "C" int sample_tokens_f32(const void* logits, const void* greedy,
                                 const void* temperature, const void* top_k,
                                 const void* top_p, const void* uniform,
                                 void* out, int B, int V, void* stream) {
  const size_t smem = sizeof(float) * (size_t)V;
  cudaError_t err = cudaFuncSetAttribute(
      sample_tokens_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  sample_tokens_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const unsigned char*)greedy,
      (const float*)temperature, (const int*)top_k, (const float*)top_p,
      (const float*)uniform, (int*)out, V);
  return (int)cudaGetLastError();
}

extern "C" int topk_sample_f32(const void* logits, const void* top_k,
                               const void* temperature, const void* uniform,
                               void* out, int B, int V, void* stream) {
  const size_t smem = sizeof(float) * (size_t)V;
  cudaError_t err = cudaFuncSetAttribute(
      topk_sample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_sample_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)logits, (const int*)top_k, (const float*)temperature,
      (const float*)uniform, (int*)out, V);
  return (int)cudaGetLastError();
}
