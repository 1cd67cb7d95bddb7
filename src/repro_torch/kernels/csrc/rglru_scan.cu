// RG-LRU linear recurrence for Hopper (sm_90a), the port of the Pallas TPU
// kernel ``repro/kernels/rglru_scan.py::rglru_scan_kernel`` (TPU kernel 7).
//
// Computes h_t = a_t * h_{t-1} + x_t over a, x (B, S, L) float32 from
// h0 (B, L), writing every h_t to y (B, S, L) and the last to hT (B, L).
// The Pallas kernel keeps h in VMEM and walks time in order over channel
// blocks; here one thread owns one channel of one row and keeps h in a
// register, walking t = 0 .. S-1. Neighbouring threads own neighbouring
// channels, so every load of a_t, x_t and store of h_t is coalesced
// across a warp (128 bytes). Any S is taken (the Pallas kernel needs
// S % block_t == 0; the engine's prompts have exact lengths).
//
// What bounds it: three float32 streams of B*S*L (read a and x, write y),
// 3 * B*S*L * 4 bytes over the device memory rate; two FLOPs per element.
// The loads do not depend on h, so a thread issues the next UNROLL steps'
// loads before it computes the current ones (the dependent chain is one
// multiply and one add per step). At B = 1, L = 4096 only 64 blocks of 64
// threads exist, so the bytes in flight, not the rate, set its time.
//
// Numerics: ``a * h`` and ``+ x`` are rounded separately (no fused
// multiply-add), as the plain version ``plain.rglru_scan`` computes them,
// so the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 16;

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ x,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ hT, int S, int L) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (l >= L) return;
  const size_t base = (size_t)b * S * L + l;
  float h = h0[(size_t)b * L + l];

  // the next UNROLL steps' loads, issued before the current steps run
  float an[UNROLL], xn[UNROLL];
#pragma unroll
  for (int i = 0; i < UNROLL; ++i) {
    const size_t at = base + (size_t)i * L;
    an[i] = i < S ? __ldg(a + at) : 0.0f;
    xn[i] = i < S ? __ldg(x + at) : 0.0f;
  }
  for (int t0 = 0; t0 < S; t0 += UNROLL) {
    float ac[UNROLL], xc[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      ac[i] = an[i];
      xc[i] = xn[i];
    }
    const int tn = t0 + UNROLL;
    if (tn < S) {
#pragma unroll
      for (int i = 0; i < UNROLL; ++i) {
        const size_t at = base + (size_t)(tn + i) * L;
        an[i] = tn + i < S ? __ldg(a + at) : 0.0f;
        xn[i] = tn + i < S ? __ldg(x + at) : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      if (t0 + i < S) {
        h = __fadd_rn(__fmul_rn(ac[i], h), xc[i]);
        y[base + (size_t)(t0 + i) * L] = h;
      }
    }
  }
  hT[(size_t)b * L + l] = h;
}

}  // namespace

extern "C" int rglru_scan_f32(const void* a, const void* x, const void* h0,
                              void* y, void* hT, int B, int S, int L,
                              void* stream) {
  if (B < 1 || S < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((L + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)x, (const float*)h0, (float*)y,
      (float*)hT, S, L);
  return (int)cudaGetLastError();
}
