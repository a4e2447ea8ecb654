// K8b: the backward of K8's Mamba1 (S6) selective scan.
//
// Replaces: no TPU kernel. The JAX package's `mamba1_scan_pallas` is
// forward-only (src/repro/kernels/mamba_scan.py); it trains through jnp's
// chunked scan. The port's training path runs K8 in every ssm layer on
// the card, so its gradient is a kernel too: `kernels/ops.py` wraps K8 in
// a torch.autograd.Function whose backward launches this one.
//
// Contract (kernels/mamba_scan.py `mamba1_scan_bwd_ref`): the forward is
//   h_l = exp(δ_l·A[d]) ∘ h_{l-1} + (δ_l·x_l)·B_l,   y_l = Σ_n h_l[n]·C_l[n]
// from h_{-1} = h0 (0 when null). Given dy (B, L, D) and dh_last (the
// gradient of h_{L-1}, 0 when null) it returns dx and dδ (B, L, D) in the
// inputs' dtype T, dB and dC (B, L, N) and dA (D, N) as float32 sums, and
// dh0 (B, D, N) float32 when asked. A reverse sweep over L carries the
// gradient g of the state:
//   g += dy_l·C_l;  dC_l += dy_l·h_l;  dB_l += g·(δ_l·x_l)
//   e = Σ_n g·B_l (the gradient of δ_l·x_l);  dx_l = e·δ_l
//   u = g·exp(δ_l·A)·h_{l-1} (the gradient of δ_l·A);  dδ_l = Σ_n u·A + e·x_l
//   dA += u·δ_l;  g = g·exp(δ_l·A)
// and dh0 = g at the end. dB and dC sum over D, dA over B and L: each
// block adds its part with float32 atomics, so their sums are taken in
// an order that changes from run to run (allclose, not bit-equal, to the
// plain version). Everything else is float32 in one thread a channel.
//
// The states. The sweep needs h_l and h_{l-1} in reverse order. A first
// forward pass in the same launch stores the state before every chunk of
// kSteps (8) steps to a float32 scratch (B, chunks, 16, D); the reverse pass
// recomputes a chunk's kSteps states from it into shared memory
// ([step][n][channel], conflict-free) and walks them backwards. The state
// recurrence rounds every product and sum on its own, as K8 and
// `scan_step` do.
//
// What bounds it on an H100: the exps. Each (b, l, d, n) takes exp(δ·A)
// three times (the first pass, the chunk's recompute, the reverse step),
// 3·2^30 at falcon-mamba-7b's layer (B 4, L 2048, D 8192, N 16): 0.77 ms
// at the SFU's 16 a clock an SM, above its ~27 FLOP a (b, l, d, n)
// (0.43 ms) and its bytes.
//
// What the design does about it, as a first simple kernel: one thread a
// channel holds its 16 states, decays and gradients in registers (N < 16
// is padded with zero decays, B and C, whose states stay 0); a block is 64
// channels of one batch row, B and C of a chunk staged in shared memory
// (35 KB a block with the chunk's states: six blocks an SM).
// dB and dC of a step leave a warp by a transposed butterfly (31 shuffles
// put the warp's sum of value i in lane i), are summed over the block's
// warps in shared memory after the chunk, and are added to the output with
// one atomicAdd an (l, n) a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 16;              // the largest state built for
constexpr int kChannels = 64;          // channels (threads) a block
constexpr int kWarps = kChannels / 32;
constexpr int kSteps = 8;              // steps a chunk
static_assert(kChannels % 32 == 0, "whole warps");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Args {
  const void* x;
  const void* dt;
  const void* bv;
  const void* cv;
  const float* A;
  const float* h0;        // or null
  const void* dy;
  const float* dh_last;   // or null
  void* dx;
  void* ddt;
  float* dB;              // zeroed by the wrapper
  float* dC;              // zeroed by the wrapper
  float* dA;              // zeroed by the wrapper
  float* dh0;             // or null
  float* ckpt;            // (B, chunks, 16, D) scratch
  int L, D, N, chunks;
};

__host__ __device__ constexpr int smem_floats() {
  return kSteps * kMaxN * kChannels + kSteps * 2 * kMaxN +
         kWarps * kSteps * 32;
}

// B and C of steps l0 .. l0 + len - 1 of batch row `row0` as float32,
// bc[t][0][n] = B, bc[t][1][n] = C, 0 for n >= N and t >= len
template <typename T>
__device__ __forceinline__ void load_bc(float* bc, const T* __restrict__ bv,
                                        const T* __restrict__ cv,
                                        int64_t row0, int l0, int len,
                                        int N) {
  for (int i = threadIdx.x; i < kSteps * 2 * kMaxN; i += kChannels) {
    const int t = i / (2 * kMaxN), n = i % kMaxN;
    const T* src = (i / kMaxN) % 2 ? cv : bv;
    bc[i] = t < len && n < N ? to_f(src[(row0 + l0 + t) * N + n]) : 0.f;
  }
}

// one level of warp_transpose_sum: a lane keeps the half of its W values
// that its bit W selects and adds its partner's copy of them
template <int W>
__device__ __forceinline__ void transpose_level(float (&v)[32], int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// lane i of the warp ends with v[0] = Σ over the warp's lanes of v[i]
// (31 shuffles, every index known at compile time: v stays in registers)
__device__ __forceinline__ void warp_transpose_sum(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
  transpose_level<16>(v, lane);
  transpose_level<8>(v, lane);
  transpose_level<4>(v, lane);
  transpose_level<2>(v, lane);
  transpose_level<1>(v, lane);
}

template <typename T, typename Y>
__global__ void __launch_bounds__(kChannels)
scan_bwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* hs = smem;                              // [kSteps][kMaxN][kChannels]
  float* bc = hs + kSteps * kMaxN * kChannels;   // [kSteps][2][kMaxN]
  float* red = bc + kSteps * 2 * kMaxN;          // [kWarps][kSteps][32]
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  const T* bv = static_cast<const T*>(a.bv);
  const T* cv = static_cast<const T*>(a.cv);
  const Y* dy = static_cast<const Y*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  T* ddt = static_cast<T*>(a.ddt);
  const int b = blockIdx.y;
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c / 32;
  const int d = blockIdx.x * kChannels + c;
  const bool live = d < a.D;
  const int D = a.D, N = a.N, L = a.L;
  const int64_t row0 = (int64_t)b * L;
  const int64_t hrow = ((int64_t)b * D + d) * N;  // this channel's state

  float av[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    const bool own = live && n < N;
    av[n] = own ? a.A[(int64_t)d * N + n] : 0.f;
    h[n] = own && a.h0 != nullptr ? a.h0[hrow + n] : 0.f;
  }

  // pass 1: forward, the state before every chunk to the scratch
  for (int ch = 0; ch < a.chunks; ++ch) {
    const int l0 = ch * kSteps, len = min(kSteps, L - l0);
    __syncthreads();
    load_bc(bc, bv, cv, row0, l0, len, N);
    __syncthreads();
    if (live) {
#pragma unroll
      for (int n = 0; n < kMaxN; ++n)
        a.ckpt[(((int64_t)b * a.chunks + ch) * kMaxN + n) * D + d] = h[n];
    }
    for (int t = 0; t < len; ++t) {
      const int64_t at = (row0 + l0 + t) * D + d;
      const float dv = live ? to_f(dt[at]) : 0.f;
      const float dxv = __fmul_rn(dv, live ? to_f(x[at]) : 0.f);
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        const float da = expf(__fmul_rn(dv, av[n]));
        h[n] = __fadd_rn(__fmul_rn(da, h[n]),
                         __fmul_rn(dxv, bc[t * 2 * kMaxN + n]));
      }
    }
  }

  // pass 2: the reverse sweep, a chunk at a time from the last
  float g[kMaxN], dA_acc[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    const bool own = live && n < N;
    g[n] = own && a.dh_last != nullptr ? a.dh_last[hrow + n] : 0.f;
    dA_acc[n] = 0.f;
  }
  for (int ch = a.chunks - 1; ch >= 0; --ch) {
    const int l0 = ch * kSteps, len = min(kSteps, L - l0);
    __syncthreads();                 // the last chunk's bc and red are read
    load_bc(bc, bv, cv, row0, l0, len, N);
    __syncthreads();
    float hc[kMaxN];                 // the state before the chunk
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      hc[n] = live ? a.ckpt[(((int64_t)b * a.chunks + ch) * kMaxN + n) * D
                            + d]
                   : 0.f;
      h[n] = hc[n];
    }
    for (int t = 0; t < len; ++t) {  // the chunk's states, recomputed
      const int64_t at = (row0 + l0 + t) * D + d;
      const float dv = live ? to_f(dt[at]) : 0.f;
      const float dxv = __fmul_rn(dv, live ? to_f(x[at]) : 0.f);
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        const float da = expf(__fmul_rn(dv, av[n]));
        h[n] = __fadd_rn(__fmul_rn(da, h[n]),
                         __fmul_rn(dxv, bc[t * 2 * kMaxN + n]));
        hs[(t * kMaxN + n) * kChannels + c] = h[n];
      }
    }
    for (int t = len - 1; t >= 0; --t) {
      const int64_t at = (row0 + l0 + t) * D + d;
      const float dv = live ? to_f(dt[at]) : 0.f;
      const float xv = live ? to_f(x[at]) : 0.f;
      const float dyv = live ? to_f(dy[at]) : 0.f;
      const float dxv = __fmul_rn(dv, xv);
      float vals[2 * kMaxN];         // this channel's dB (n), dC (16 + n)
      float e = 0.f, du = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        const float bn = bc[t * 2 * kMaxN + n];
        const float cn = bc[t * 2 * kMaxN + kMaxN + n];
        const float ht = hs[(t * kMaxN + n) * kChannels + c];
        const float hp = t > 0 ? hs[((t - 1) * kMaxN + n) * kChannels + c]
                               : hc[n];
        g[n] = fmaf(dyv, cn, g[n]);
        vals[kMaxN + n] = dyv * ht;
        vals[n] = g[n] * dxv;
        e = fmaf(g[n], bn, e);
        const float gd = g[n] * expf(__fmul_rn(dv, av[n]));
        const float u = gd * hp;
        du = fmaf(u, av[n], du);
        dA_acc[n] = fmaf(u, dv, dA_acc[n]);
        g[n] = gd;
      }
      if (live) {
        dx[at] = from_f<T>(e * dv);
        ddt[at] = from_f<T>(fmaf(e, xv, du));
      }
      warp_transpose_sum(vals);
      red[(warp * kSteps + t) * 32 + lane] = vals[0];
    }
    __syncthreads();
    // the chunk's dB and dC: the block's sum, one atomicAdd an (l, n)
    for (int i = c; i < len * 32; i += kChannels) {
      const int t = i / 32, j = i % 32, n = j % kMaxN;
      if (n >= N) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[(w * kSteps + t) * 32 + j];
      float* dst = j < kMaxN ? a.dB : a.dC;
      atomicAdd(dst + (row0 + l0 + t) * N + n, sum);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      if (n >= N) continue;
      atomicAdd(a.dA + (int64_t)d * N + n, dA_acc[n]);
      if (a.dh0 != nullptr) a.dh0[hrow + n] = g[n];
    }
  }
}

template <typename T, typename Y>
cudaError_t launch(const Args& a, int B, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)smem_floats();
  const auto kern = scan_bwd_kernel<T, Y>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.D + kChannels - 1) / kChannels, B);
  kern<<<grid, kChannels, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// bf16 = 1: x, δ, B, C, dx and dδ are __nv_bfloat16, else float; dy_f32
// = 1: dy is float, else x's type. h0, dh_last and dh0 may be null. ckpt
// holds B · ceil(L / steps) · 16 · D floats (mamba1_scan_bwd_steps). The
// wrapper has checked shapes and 1 <= N <= 16 and zeroed dB, dC and dA.
extern "C" int mamba1_scan_bwd_launch(
    const void* x, const void* dt, const void* bv, const void* cv,
    const void* A, const void* h0, const void* dy, const void* dh_last,
    void* dx, void* ddt, void* dB, void* dC, void* dA, void* dh0, void* ckpt,
    int B, int L, int D, int N, int bf16, int dy_f32, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || L == 0 || D == 0) return 0;
  if (N < 1 || N > kMaxN) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.dt = dt;
  a.bv = bv;
  a.cv = cv;
  a.A = static_cast<const float*>(A);
  a.h0 = static_cast<const float*>(h0);
  a.dy = dy;
  a.dh_last = static_cast<const float*>(dh_last);
  a.dx = dx;
  a.ddt = ddt;
  a.dB = static_cast<float*>(dB);
  a.dC = static_cast<float*>(dC);
  a.dA = static_cast<float*>(dA);
  a.dh0 = static_cast<float*>(dh0);
  a.ckpt = static_cast<float*>(ckpt);
  a.L = L;
  a.D = D;
  a.N = N;
  a.chunks = (L + kSteps - 1) / kSteps;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16 && dy_f32) err = launch<__nv_bfloat16, float>(a, B, s);
  else if (bf16) err = launch<__nv_bfloat16, __nv_bfloat16>(a, B, s);
  else err = launch<float, float>(a, B, s);
  return (int)err;
}

// the steps a chunk of the scratch, which the wrapper allocates
extern "C" int mamba1_scan_bwd_steps() { return kSteps; }
