// K8: the Mamba1 (S6) selective scan, forward, for Hopper.
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
// bfloat16), A (D, N) is float32, 1 <= N <= 16, y (B, L, D) has the dtype
// Y (T, or float32 for bf16 inputs), h0 and h_last are (B, D, N) float32,
// row-major. The state is float32 throughout.
//
// What bounds it on an H100: the exps. Every (b, l, d, n) takes one
// exp(δ·A[d, n]); no two share it, since each (d, n) has its own decay.
// The SFU gives 16 exp2 a clock an SM, so at falcon-mamba-7b's prefill
// layer (B 4, L 2048, D 8192, N 16: 2^30 exps) the least time is
// 2^30 / (16 · 132 · 1.98 GHz) = 0.257 ms, above the bytes (0.161 ms) and
// the 6 FLOP a (b, l, d, n) (0.097 ms). `expf` is the accurate one, as in
// torch.exp: besides MUFU.EX2 it costs about seven instructions of range
// reduction and scaling, so in practice the kernel is bound by the issue
// rate of about 15.6 instructions a (b, l, d, n) (12 of them FP32, the
// accurate exp's six among them). No tensor cores: Mamba2's
// chunked matrix form needs one scalar decay a head; here every (d, n)
// decays on its own, so the work is exps and FP32 operations.
//
// The layout. A channel's N states are spread over kLanes lanes of one
// warp: lane j holds the states n ≡ j (mod kLanes), kOwn = 16 / kLanes of
// them, in registers, with their decays A[d, n]. A block holds kChannels
// channels of one batch row (kLanes · kChannels threads); at B 4 × D 8192
// the 256 blocks of 2 × 128 are resident at once, two an SM. Every state
// carries one dependent multiply-add a step; the exps of the next steps
// do not wait on it, and the step loop is unrolled so that several are in
// flight. Two lanes a channel measured fastest (tools/k8_layouts.py):
// more lanes add shuffles and shared loads a step (21.5 instructions a
// (l, n) at 8 lanes, 31 at 16), one lane leaves too few warps and spills
// its 16 states' loop.
//
// The staged loads. The block walks L in chunks of kSteps steps. A ring of
// kStages raw chunks in shared memory (x and δ for the block's channels, B
// and C of the batch row, in the inputs' dtype) is filled by cp.async,
// 16 bytes a copy, kStages − 1 chunks ahead of the walk, so the loads of
// the next chunk overlap the walk of this one. Before a chunk is walked
// the block converts it once: (δ, δ·x) as float2 a (step, channel), and B
// and C as float32 in the lanes' order (lane j's kOwn states contiguous,
// so a 16-byte shared load gives four of them), the entries n >= N as 0. y goes
// to shared memory and leaves after the chunk in 16-byte stores, full
// 128-byte lines of consecutive channels. Rows that are not 16-byte
// aligned (D or N · sizeof(T) not a multiple of 16) are staged by plain
// loads through the same buffers; the tails of L and D are masked here,
// and the wrapper does not pad.
//
// The arithmetic, exactly that of `scan_step` (plain float32 ops, each
// rounded on its own) on the card:
//   dx   = δ·x                                  rounded once a step
//   da   = expf(δ·a[n])                         δ·a rounded, accurate expf
//   h[n] = da·h[n] + dx·B[n]                    two products, then the sum
//   p[n] = h[n]·C[n]
//   y    = Σ_n p[n] as the pairwise tree p[n] += p[n + w], w = 8, 4, 2, 1
// (torch's sum over a last dim of 16 on the card pairs the same way). Where
// bits are easily lost:
//   - contraction: nvcc fuses a product into the next add unless the
//     product is `__fmul_rn` and the add `__fadd_rn`; every step op is
//     written with them, so no flag is needed (no -fmad=false, no
//     --use_fast_math: `expf` stays the accurate one);
//   - the tree's pairing for another kLanes: lane j adds its own states
//     first for w = 8 .. kLanes (in k = (n - j) / kLanes, w / kLanes),
//     then `__shfl_down_sync` by kLanes / 2 .. 1: the same pairs as
//     w = 8 .. 1 over n;
//   - N < 16: the missing p[n] are 0 in the tree (the pad variant also
//     selects 0 for them, so a non-finite δ·x cannot reach y through a
//     pad);
//   - δ·x is rounded once and then multiplied by B[n], not δ·(x·B[n]).
// K8_FUSED = 1 builds h's update as one fmaf instead, for
// tools/ssm_decode_ab.py, which measures what the rounding costs and buys.
//
// K8_LANES, K8_CHANNELS, K8_STEPS and K8_STAGES set the layout at build
// time; tools/k8_layouts.py builds and times others.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef K8_LANES
#define K8_LANES 2
#endif
#ifndef K8_CHANNELS
#define K8_CHANNELS 128
#endif
#ifndef K8_STEPS
#define K8_STEPS 32
#endif
#ifndef K8_STAGES
#define K8_STAGES 2
#endif
#ifndef K8_UNROLL
#define K8_UNROLL 2
#endif
#ifndef K8_FUSED
#define K8_FUSED 0
#endif

namespace {

constexpr int kMaxN = 16;                // the largest state built for
constexpr int kLanes = K8_LANES;         // lanes a channel
constexpr int kChannels = K8_CHANNELS;   // channels a block
constexpr int kSteps = K8_STEPS;         // steps a chunk
constexpr int kStages = K8_STAGES;       // raw chunks in the ring
constexpr int kUnroll = K8_UNROLL;       // steps unrolled in the walk
constexpr int kThreads = kLanes * kChannels;
constexpr int kOwn = kMaxN / kLanes;     // states a lane holds
static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4 || kLanes == 8 ||
              kLanes == 16, "a channel's lanes divide 16 and a warp");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kChannels % 8 == 0, "a block's row is whole 16-byte pieces");
static_assert(kStages >= 2 && kStages <= 4, "a ring of 2 to 4 chunks");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename Y> __device__ __forceinline__ Y from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;          // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Shared memory, in bytes: the raw ring, (δ, δ·x), B and C in the lanes'
// order, y.
template <typename T> __host__ __device__ constexpr int raw_xd_bytes() {
  return kSteps * kChannels * (int)sizeof(T);
}
template <typename T> __host__ __device__ constexpr int raw_bc_bytes() {
  return kSteps * kMaxN * (int)sizeof(T);
}
template <typename T> __host__ __device__ constexpr int stage_bytes() {
  return 2 * raw_xd_bytes<T>() + 2 * raw_bc_bytes<T>();
}
__host__ __device__ constexpr int dd_bytes() { return kSteps * kChannels * 8; }
__host__ __device__ constexpr int bc_bytes() { return kSteps * 2 * kMaxN * 4; }
template <typename T, typename Y>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<T>() + dd_bytes() + bc_bytes() +
         kSteps * kChannels * (int)sizeof(Y);
}

// Chunk `l0` (rows l0 .. l0 + len - 1 of batch row b) into a raw stage:
// x and δ as [kSteps][kChannels], B and C as [kSteps · N] compact. With
// `vec`, 16-byte cp.async copies, zero-filled past L and D; else plain
// loads.
template <typename T>
__device__ __forceinline__ void load_chunk(
    char* stage, const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ bv, const T* __restrict__ cv, int64_t row0,
    int l0, int len, int d0, int D, int N, bool vec) {
  T* rx = reinterpret_cast<T*>(stage);
  T* rd = reinterpret_cast<T*>(stage + raw_xd_bytes<T>());
  T* rb = reinterpret_cast<T*>(stage + 2 * raw_xd_bytes<T>());
  T* rc = reinterpret_cast<T*>(stage + 2 * raw_xd_bytes<T>() +
                               raw_bc_bytes<T>());
  const int64_t bc0 = (row0 + l0) * N;
  if (vec) {
    constexpr int E = 16 / sizeof(T);            // elements a copy
    constexpr int P = kChannels / E;             // copies a row
    for (int i = threadIdx.x; i < 2 * kSteps * P; i += kThreads) {
      const int which = i / (kSteps * P), r = (i / P) % kSteps, q = i % P;
      const bool ok = r < len && d0 + q * E < D;
      const T* src = which ? dt : x;
      const int64_t at = ok ? (row0 + l0 + r) * D + d0 + q * E : 0;
      cp_async16((which ? rd : rx) + r * kChannels + q * E, src + at, ok);
    }
    const int pieces = kSteps * kMaxN / E;       // of each of B and C
    for (int i = threadIdx.x; i < 2 * pieces; i += kThreads) {
      const int which = i / pieces, q = i % pieces;
      const bool ok = q * E < len * N;
      const T* src = which ? cv : bv;
      cp_async16((which ? rc : rb) + q * E, src + (ok ? bc0 + q * E : 0),
                 ok);
    }
  } else {
    for (int i = threadIdx.x; i < len * kChannels; i += kThreads) {
      const int r = i / kChannels, c = i % kChannels;
      const bool ok = d0 + c < D;
      const int64_t at = (row0 + l0 + r) * D + d0 + c;
      rx[i] = ok ? x[at] : from_f<T>(0.f);
      rd[i] = ok ? dt[at] : from_f<T>(0.f);
    }
    for (int i = threadIdx.x; i < len * N; i += kThreads) {
      rb[i] = bv[bc0 + i];
      rc[i] = cv[bc0 + i];
    }
  }
}

// A raw stage into the walk's form: dd[l][c] = (δ, δ·x); bc[l][0][s] and
// bc[l][1][s] = B and C of state n = j + kLanes·k at slot s = j·kOwn + k,
// 0 for n >= N.
template <typename T>
__device__ __forceinline__ void convert(const char* stage, float2* dd,
                                        float* bc, int len, int N) {
  const T* rx = reinterpret_cast<const T*>(stage);
  const T* rd = reinterpret_cast<const T*>(stage + raw_xd_bytes<T>());
  const T* rb = reinterpret_cast<const T*>(stage + 2 * raw_xd_bytes<T>());
  const T* rc = reinterpret_cast<const T*>(stage + 2 * raw_xd_bytes<T>() +
                                           raw_bc_bytes<T>());
  for (int i = threadIdx.x; i < len * kChannels; i += kThreads) {
    const float dv = to_f(rd[i]);
    dd[i] = make_float2(dv, __fmul_rn(dv, to_f(rx[i])));
  }
  for (int i = threadIdx.x; i < len * 2 * kMaxN; i += kThreads) {
    const int l = i / (2 * kMaxN), s = i % kMaxN;
    const int n = s / kOwn + kLanes * (s % kOwn);
    const T* src = (i / kMaxN) % 2 ? rc : rb;
    bc[i] = n < N ? to_f(src[l * N + n]) : 0.f;
  }
}

// y of the chunk's `len` rows from shared memory to y[row0 + l0 + r, d0 ..].
template <typename Y>
__device__ __forceinline__ void store_y(const Y* ys, Y* __restrict__ y,
                                        int64_t row0, int l0, int len,
                                        int d0, int D, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(Y);
    constexpr int P = kChannels / E;
    for (int i = threadIdx.x; i < len * P; i += kThreads) {
      const int r = i / P, q = i % P;
      if (d0 + q * E < D)
        *reinterpret_cast<uint4*>(y + (row0 + l0 + r) * D + d0 + q * E) =
            *reinterpret_cast<const uint4*>(ys + r * kChannels + q * E);
    }
  } else {
    for (int i = threadIdx.x; i < len * kChannels; i += kThreads) {
      const int r = i / kChannels, c = i % kChannels;
      if (d0 + c < D) y[(row0 + l0 + r) * D + d0 + c] = ys[i];
    }
  }
}

template <int K>
__device__ __forceinline__ void load_own(float (&v)[K], const float* p) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

// kPad: N < 16, so some lanes hold states n >= N, whose p is selected 0.
template <typename T, typename Y, bool kPad>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const T* __restrict__ bv, const T* __restrict__ cv,
            const float* __restrict__ A, const float* __restrict__ h0,
            Y* __restrict__ y, float* __restrict__ h_last, int L, int D,
            int N, int vec) {
  extern __shared__ __align__(16) char smem[];
  float2* dd = reinterpret_cast<float2*>(smem + kStages * stage_bytes<T>());
  float* bc = reinterpret_cast<float*>(smem + kStages * stage_bytes<T>() +
                                       dd_bytes());
  Y* ys = reinterpret_cast<Y*>(smem + kStages * stage_bytes<T>() +
                               dd_bytes() + bc_bytes());
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int ch = threadIdx.x / kLanes, j = threadIdx.x % kLanes;
  const int d = d0 + ch;
  const int64_t hrow = ((int64_t)b * D + d) * N;   // this channel's state
  float a[kOwn], h[kOwn];
  bool own[kOwn];                                  // n < N and d < D
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int n = j + kLanes * k;
    own[k] = n < N && d < D;
    a[k] = own[k] ? A[(int64_t)d * N + n] : 0.f;
    h[k] = (h0 != nullptr && own[k]) ? h0[hrow + n] : 0.f;
  }
  const int64_t row0 = (int64_t)b * L;
  const int chunks = (L + kSteps - 1) / kSteps;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks)
      load_chunk(smem + s * stage_bytes<T>(), x, dt, bv, cv, row0,
                 s * kSteps, min(kSteps, L - s * kSteps), d0, D, N, vec);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    const int l0 = c * kSteps, len = min(kSteps, L - l0);
    cp_async_wait<kStages - 2>();
    __syncthreads();             // chunk c staged; chunk c - 1 walked
    if (c > 0) store_y(ys, y, row0, l0 - kSteps, kSteps, d0, D, vec);
    const int next = c + kStages - 1;
    if (next < chunks)
      load_chunk(smem + (next % kStages) * stage_bytes<T>(), x, dt, bv, cv,
                 row0, next * kSteps, min(kSteps, L - next * kSteps), d0, D,
                 N, vec);
    cp_async_commit();
    convert<T>(smem + (c % kStages) * stage_bytes<T>(), dd, bc, len, N);
    __syncthreads();             // converted; the last y stored
#pragma unroll (kUnroll)
    for (int l = 0; l < len; ++l) {
      const float2 v = dd[l * kChannels + ch];     // (δ, δ·x)
      float bq[kOwn], cq[kOwn], p[kOwn];
      load_own(bq, bc + l * 2 * kMaxN + j * kOwn);
      load_own(cq, bc + l * 2 * kMaxN + kMaxN + j * kOwn);
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        const float da = expf(__fmul_rn(v.x, a[k]));
#if K8_FUSED
        h[k] = fmaf(da, h[k], __fmul_rn(v.y, bq[k]));
#else
        h[k] = __fadd_rn(__fmul_rn(da, h[k]), __fmul_rn(v.y, bq[k]));
#endif
        p[k] = __fmul_rn(h[k], cq[k]);
        if (kPad && !own[k]) p[k] = 0.f;
      }
#pragma unroll
      for (int w = kOwn / 2; w >= 1; w /= 2) {       // n-pairs 8 .. kLanes
#pragma unroll
        for (int k = 0; k < w; ++k) p[k] = __fadd_rn(p[k], p[k + w]);
      }
      float s = p[0];
#pragma unroll
      for (int w = kLanes / 2; w >= 1; w /= 2)       // n-pairs kLanes/2 .. 1
        s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, w));
      if (j == 0) ys[l * kChannels + ch] = from_f<Y>(s);
    }
  }
  __syncthreads();
  store_y(ys, y, row0, (chunks - 1) * kSteps, L - (chunks - 1) * kSteps, d0,
          D, vec);
  if (h_last != nullptr) {
#pragma unroll
    for (int k = 0; k < kOwn; ++k)
      if (own[k]) h_last[hrow + j + kLanes * k] = h[k];
  }
}

template <typename T, typename Y, bool kPad>
cudaError_t launch(const dim3& grid, cudaStream_t s, const void* x,
                   const void* dt, const void* bv, const void* cv,
                   const void* A, const void* h0, void* y, void* h_last,
                   int L, int D, int N, int vec) {
  constexpr int smem = smem_bytes<T, Y>();
  const auto kern = scan_kernel<T, Y, kPad>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, kThreads, smem, s>>>(
      (const T*)x, (const T*)dt, (const T*)bv, (const T*)cv, (const float*)A,
      (const float*)h0, (Y*)y, (float*)h_last, L, D, N, vec);
  return cudaGetLastError();
}

template <typename T, typename Y>
cudaError_t launch_n(const dim3& grid, cudaStream_t s, const void* x,
                     const void* dt, const void* bv, const void* cv,
                     const void* A, const void* h0, void* y, void* h_last,
                     int L, int D, int N, int vec) {
  if (N == kMaxN)
    return launch<T, Y, false>(grid, s, x, dt, bv, cv, A, h0, y, h_last, L,
                               D, N, vec);
  return launch<T, Y, true>(grid, s, x, dt, bv, cv, A, h0, y, h_last, L, D,
                            N, vec);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

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
  const dim3 grid((D + kChannels - 1) / kChannels, B);
  const cudaStream_t s = (cudaStream_t)stream;
  const int size = bf16 ? 2 : 4;
  const int vec = (int64_t)D * size % 16 == 0 && N * size % 16 == 0 &&
                  aligned16(x) && aligned16(dt) && aligned16(bv) &&
                  aligned16(cv) && aligned16(y);
  if (bf16 && y_f32)
    err = launch_n<__nv_bfloat16, float>(grid, s, x, dt, bv, cv, A, h0, y,
                                         h_last, L, D, N, vec);
  else if (bf16)
    err = launch_n<__nv_bfloat16, __nv_bfloat16>(grid, s, x, dt, bv, cv, A,
                                                 h0, y, h_last, L, D, N, vec);
  else
    err = launch_n<float, float>(grid, s, x, dt, bv, cv, A, h0, y, h_last, L,
                                 D, N, vec);
  return (int)err;
}

// The layout this library was built with: lanes a channel, channels a
// block, steps a chunk, raw chunks in the ring, steps unrolled, fused (1)
// or rounded (0) arithmetic.
extern "C" void mamba1_scan_layout(int* out) {
  out[0] = kLanes;
  out[1] = kChannels;
  out[2] = kSteps;
  out[3] = kStages;
  out[4] = kUnroll;
  out[5] = K8_FUSED;
}
