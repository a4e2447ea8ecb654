// K8: the Mamba1 (S6) selective scan, forward.
//
// Replaces: the JAX package's Pallas kernel `mamba1_scan_pallas`
// (src/repro/kernels/mamba_scan.py, body `_scan_kernel`).
//
// Contract (kernels/mamba_scan.py `mamba1_scan_ref`): for every batch b and
// channel d, with a float32 state h of N entries starting at h0[b, d] (0
// when h0 is null),
//   h_l = exp(δ_l·A[d]) ∘ h_{l-1} + (δ_l·x_l)·B_l,   y_l = Σ_n h_l[n]·C_l[n]
// for l = 0 .. L-1, and h_last[b, d] = h_{L-1} when h_last is not null.
// x, δ (B, L, D) and B, C (B, L, N) share one dtype T (float32 or
// bfloat16), A (D, N) is float32, y (B, L, D) has the dtype Y (T, or
// float32 for bf16 inputs), h0 and h_last are (B, D, N) float32, row-major.
// The state is float32 throughout; exp is `expf`, not the faster `__expf`,
// so the float32 comparison with the plain version stays tight. nvcc fuses
// the state update and the running sum over N into multiply-adds, so the
// bits differ from the plain version's (and from a decode step's, which is
// plain ops) in the last place; keeping every product and sum rounded on
// its own made the kernel 19-24 % slower (tools/ssm_decode_ab.py).
//
// What bounds it on an H100: memory. Each step reads x and δ and writes y
// once a channel, and B and C once a batch row; the state never leaves the
// chip. At falcon-mamba-7b's width (D = 8192, N = 16) the least time is
// 2·B·L·D·size(T) + B·L·D·size(Y) + 2·B·L·N·size(T) + D·N·4 bytes, plus
// B·D·N·4 for each of h0 and h_last that is given, over 3.35 TB/s.
//
// What the design does about it: one thread a (b, d) channel with its N
// state entries in registers (N <= 16, the compiled maximum), 64 channels a
// block. The block walks L in chunks of 64 steps: it stages the chunk's x
// and δ (coalesced over channels) and B_l, C_l (shared by every channel of
// the batch row) in shared memory, then each thread runs the chunk's
// recurrence from there and writes y coalesced. The TPU kernel's
// (BD, N)-wide vector step becomes N scalar steps a thread. A thread reads
// its channel's N entries of h0 before the walk and writes h_last after it
// (64 B a thread at N = 16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels a block
constexpr int kChunk = 64;     // steps staged at once
constexpr int kMaxN = 16;      // the largest state the kernel is built for

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, typename Y>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const T* __restrict__ bv, const T* __restrict__ cv,
            const float* __restrict__ A, const float* __restrict__ h0,
            Y* __restrict__ y, float* __restrict__ h_last, int L, int D,
            int N) {
  __shared__ float xs[kChunk][kThreads];
  __shared__ float ds[kChunk][kThreads];
  __shared__ float bs[kChunk][kMaxN];
  __shared__ float cs[kChunk][kMaxN];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kThreads;
  const int d = d0 + threadIdx.x;
  const bool live = d < D;
  const int64_t hrow = ((int64_t)b * D + d) * N;   // this channel's state
  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = (live && n < N) ? A[(int64_t)d * N + n] : 0.f;
    h[n] = (h0 != nullptr && live && n < N) ? h0[hrow + n] : 0.f;
  }
  const int64_t row0 = (int64_t)b * L;
  for (int l0 = 0; l0 < L; l0 += kChunk) {
    const int len = min(kChunk, L - l0);
    __syncthreads();                         // the last chunk has been read
    for (int i = threadIdx.x; i < len * N; i += kThreads) {
      const int l = i / N, n = i % N;
      const int64_t at = (row0 + l0 + l) * N + n;
      bs[l][n] = to_f(bv[at]);
      cs[l][n] = to_f(cv[at]);
    }
    for (int l = 0; l < len; ++l) {
      const int64_t at = (row0 + l0 + l) * D + d;
      xs[l][threadIdx.x] = live ? to_f(x[at]) : 0.f;
      ds[l][threadIdx.x] = live ? to_f(dt[at]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    for (int l = 0; l < len; ++l) {
      const float dtv = ds[l][threadIdx.x];
      const float dx = dtv * xs[l][threadIdx.x];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < N) {
          const float da = expf(dtv * a[n]);
          h[n] = da * h[n] + dx * bs[l][n];
          acc += h[n] * cs[l][n];
        }
      }
      store(y + (row0 + l0 + l) * D + d, acc);
    }
  }
  if (h_last != nullptr && live) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) h_last[hrow + n] = h[n];
  }
}

template <typename T, typename Y>
void launch(const dim3& grid, cudaStream_t s, const void* x, const void* dt,
            const void* bv, const void* cv, const void* A, const void* h0,
            void* y, void* h_last, int L, int D, int N) {
  scan_kernel<T, Y><<<grid, kThreads, 0, s>>>(
      (const T*)x, (const T*)dt, (const T*)bv, (const T*)cv, (const float*)A,
      (const float*)h0, (Y*)y, (float*)h_last, L, D, N);
}

}  // namespace

// bf16 = 1: x, δ, B and C are __nv_bfloat16, else float; y_f32 = 1: y is
// float, else x's type. h0 and h_last may be null. The wrapper has checked
// shapes and 1 <= N <= 16.
extern "C" int mamba1_scan_launch(const void* x, const void* dt,
                                  const void* bv, const void* cv,
                                  const void* A, const void* h0, void* y,
                                  void* h_last, int B, int L, int D, int N,
                                  int bf16, int y_f32, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || L == 0 || D == 0) return 0;
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  const dim3 grid((D + kThreads - 1) / kThreads, B);
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16 && y_f32)
    launch<__nv_bfloat16, float>(grid, s, x, dt, bv, cv, A, h0, y, h_last, L,
                                 D, N);
  else if (bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(grid, s, x, dt, bv, cv, A, h0, y,
                                         h_last, L, D, N);
  else
    launch<float, float>(grid, s, x, dt, bv, cv, A, h0, y, h_last, L, D, N);
  return (int)cudaGetLastError();
}
