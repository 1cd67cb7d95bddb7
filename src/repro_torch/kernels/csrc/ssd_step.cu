// One decode step of the Mamba-2 SSD mixer for Hopper (sm_90a). It replaces
// no TPU kernel: the reference computes the step in plain jnp (the ``s == 1``
// branch of ``repro/models/ssm.py::apply_ssd``), and the port computed it in
// a chain of about twenty PyTorch ops that passed over the float32 state
// about nine times a layer.
//
// Per slot b and head h, over the state S (P, N) float32:
//   dt = softplus(dt_raw + dt_bias), in the reference's logaddexp(x, 0) form
//   dA = exp(dt * -exp(A_log))
//   S <- S * dA + (x * dt) outer B
//   y[p] = sum_n S[p, n] C[n] + D x[p]
// with x (P), B, C (N) and dt_raw read at their row strides out of the
// mixer's lanes in the model dtype, dt_bias, A_log and D float32, and y
// written in the model dtype.
//
// What bounds it: bytes. The state is read once and written once,
// 2 * B*H*P*N * 4 bytes (268 MB at mamba2-1.3b's 64 slots, 64 heads of 64,
// state 128: 0.080 ms at 3.35 TB/s); the lanes and y add B * (2 H*P + 2 N
// + H) elements, under 0.2% of that. About 5 FLOPs an element of the state,
// far below the card's ratio of operations to bytes.
//
// The design: a block owns ``rows`` rows of one (b, h) tile (the whole tile
// of 32 KiB at P 64, N 128: 256 threads, 8 chunks each). A thread owns up
// to PER 16-byte chunks of it, all in the same four columns of their rows,
// and starts every chunk's load before it uses any, so the block has its
// whole share of the tile in flight at once. A row's N/4 chunks lie in
// adjacent lanes of one warp (N/4 divides 32), and y[p] is their sum by
// warp shuffles. The state's loads and stores carry the streaming hint:
// the next read of a layer's state comes after 47 other layers' states have
// passed through the 50 MB L2. The step may run in place (state_out ==
// state_in): each element is read and then written by the same thread.
//
// Numerics: as the plain version ``plain.ssd_step``, the decay's multiply,
// the outer product's multiply and their add are rounded separately (no
// fused multiply-add), as its separate ops are; y's sum over N goes in
// another order (a warp tree), within 2e-5 of it.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;  // at most, a block

template <typename T, int PER>
__global__ void __launch_bounds__(THREADS)
ssd_step_kernel(const float* state_in, float* state_out,
                const T* __restrict__ x, const T* __restrict__ Bl,
                const T* __restrict__ Cl, const T* __restrict__ dt,
                const float* __restrict__ dt_bias,
                const float* __restrict__ A_log,
                const float* __restrict__ Dh, T* __restrict__ y,
                long long x_row, long long b_row, long long c_row,
                long long dt_row, int H, int P, int N, int rows) {
  const int tid = threadIdx.x, threads = blockDim.x;
  const int g = N >> 2, lg = __ffs(g) - 1;  // chunks in a row, log2
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int row0 = blockIdx.y * rows;
  const int chunks = min(rows, P - row0) * g;
  const size_t tile = ((size_t)bh * P + row0) * N;
  const float4* src = reinterpret_cast<const float4*>(state_in + tile);
  float4* dst = reinterpret_cast<float4*>(state_out + tile);

  float4 s[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * threads;
    if (idx < chunks) s[i] = __ldcs(src + idx);
  }
  // this thread's columns, the same in each of its rows (threads % g == 0)
  const int c = tid & (g - 1);
  float bn[4], cn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bn[k] = to_f32<T>(Bl[b * b_row + 4 * c + k]);
    cn[k] = to_f32<T>(Cl[b * c_row + 4 * c + k]);
  }
  const T* xh = x + b * x_row + (size_t)h * P + row0;
  float xr[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * threads;
    xr[i] = idx < chunks ? to_f32<T>(xh[idx >> lg]) : 0.0f;
  }
  const float raw = __fadd_rn(to_f32<T>(dt[b * dt_row + h]), dt_bias[h]);
  const float dtv = __fadd_rn(fmaxf(raw, 0.0f), log1pf(expf(-fabsf(raw))));
  const float dA = expf(__fmul_rn(dtv, -expf(A_log[h])));
  const float d = Dh[h];

  T* yh = y + (size_t)bh * P + row0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * threads;
    float acc = 0.0f;
    if (idx < chunks) {
      const float xin = __fmul_rn(xr[i], dtv);
      float4 v = s[i];
      v.x = __fadd_rn(__fmul_rn(v.x, dA), __fmul_rn(xin, bn[0]));
      v.y = __fadd_rn(__fmul_rn(v.y, dA), __fmul_rn(xin, bn[1]));
      v.z = __fadd_rn(__fmul_rn(v.z, dA), __fmul_rn(xin, bn[2]));
      v.w = __fadd_rn(__fmul_rn(v.w, dA), __fmul_rn(xin, bn[3]));
      __stcs(dst + idx, v);
      acc = fmaf(v.w, cn[3], fmaf(v.z, cn[2], fmaf(v.y, cn[1], v.x * cn[0])));
    }
    // the row's g lanes, aligned at g within the warp
    for (int o = g >> 1; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (idx < chunks && c == 0)
      yh[idx >> lg] = from_f32<T>(__fadd_rn(acc, __fmul_rn(d, xr[i])));
  }
}

template <typename T, int PER>
int launch(const void* s_in, void* s_out, const void* x, const void* Bl,
           const void* Cl, const void* dt, const void* dt_bias,
           const void* A_log, const void* D, void* y, long long x_row,
           long long b_row, long long c_row, long long dt_row, int B, int H,
           int P, int N, int rows, int threads, cudaStream_t stream) {
  const dim3 grid(B * H, (P + rows - 1) / rows);
  ssd_step_kernel<T, PER><<<grid, threads, 0, stream>>>(
      (const float*)s_in, (float*)s_out, (const T*)x, (const T*)Bl,
      (const T*)Cl, (const T*)dt, (const float*)dt_bias,
      (const float*)A_log, (const float*)D, (T*)y, x_row, b_row, c_row,
      dt_row, H, P, N, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* s_in, void* s_out, const void* x, const void* Bl,
             const void* Cl, const void* dt, const void* dt_bias,
             const void* A_log, const void* D, void* y, long long x_row,
             long long b_row, long long c_row, long long dt_row, int B,
             int H, int P, int N, int rows, int threads, int per,
             void* stream) {
  const int g = N / 4;
  // the plan's invariants (``kernels/ssd_step.py::step_plan``)
  if (B < 1 || H < 1 || P < 1 || N % 4 != 0 || g < 1 || g > 32 ||
      (g & (g - 1)) != 0 || threads < 32 || threads > THREADS ||
      threads % 32 != 0 || rows < 1 || rows > P ||
      (long long)rows * g > (long long)threads * per ||
      ((uintptr_t)s_in | (uintptr_t)s_out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define SSD_ARGS s_in, s_out, x, Bl, Cl, dt, dt_bias, A_log, D, y, x_row, \
    b_row, c_row, dt_row, B, H, P, N, rows, threads, st
  switch (per) {
    case 1: return launch<T, 1>(SSD_ARGS);
    case 2: return launch<T, 2>(SSD_ARGS);
    case 4: return launch<T, 4>(SSD_ARGS);
    case 8: return launch<T, 8>(SSD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SSD_ARGS
}

}  // namespace

// state_out may be state_in (in place). x, B, C, dt: the lanes, x_row ..
// dt_row their row strides in elements; y (B, H, P) contiguous.
extern "C" int ssd_step_f32(const void* s_in, void* s_out, const void* x,
                            const void* Bl, const void* Cl, const void* dt,
                            const void* dt_bias, const void* A_log,
                            const void* D, void* y, long long x_row,
                            long long b_row, long long c_row,
                            long long dt_row, int B, int H, int P, int N,
                            int rows, int threads, int per, void* stream) {
  return dispatch<float>(s_in, s_out, x, Bl, Cl, dt, dt_bias, A_log, D, y,
                         x_row, b_row, c_row, dt_row, B, H, P, N, rows,
                         threads, per, stream);
}

extern "C" int ssd_step_bf16(const void* s_in, void* s_out, const void* x,
                             const void* Bl, const void* Cl, const void* dt,
                             const void* dt_bias, const void* A_log,
                             const void* D, void* y, long long x_row,
                             long long b_row, long long c_row,
                             long long dt_row, int B, int H, int P, int N,
                             int rows, int threads, int per, void* stream) {
  return dispatch<__nv_bfloat16>(s_in, s_out, x, Bl, Cl, dt, dt_bias, A_log,
                                 D, y, x_row, b_row, c_row, dt_row, B, H, P,
                                 N, rows, threads, per, stream);
}
