// K8b: the backward of K8's Mamba1 (S6) selective scan, for Hopper.
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
// inputs' dtype T, dB and dC (B, L, N) in T (float32 sums, rounded once),
// dA (D, N) float32 and dh0 (B, D, N) float32 when asked. A reverse sweep
// over L carries the gradient g of the state:
//   g += dy_l·C_l;  dC_l += dy_l·h_l;  dB_l += g·(δ_l·x_l)
//   e = Σ_n g·B_l (the gradient of δ_l·x_l);  dx_l = e·δ_l
//   u = g·exp(δ_l·A)·h_{l-1} (the gradient of δ_l·A);  dδ_l = Σ_n u·A + e·x_l
//   dA += u·δ_l;  g = g·exp(δ_l·A)
// and dh0 = g at the end. Everything is float32. Every sum is taken in a
// fixed order and nothing is added by atomics, so two calls on the same
// inputs give the same bits in all six outputs (allclose, not bit-equal,
// to the plain version, which sums in torch's orders).
//
// What bounds it on an H100. The gradient needs one exp(δ·A) and about 19
// FLOP a (b, l, d, n) (chip_smoke.k8b_ops): 0.31 ms at falcon-mamba-7b's
// training layer (B 4, L 2048, D 8192, N 16). In practice it is bound by
// the issue rate and latency: every (d, n) decays on its own, so there are
// no tensor cores to use (K8's header says why), and the kernel recomputes
// the forward recurrence twice to keep the states it stores few. No `ncu`
// runs on the card's machine; tools/k8b_layouts.py reads the SASS
// instructions of each pass's step loop instead: about 38 a (b, l, d, n)
// in the shipped layout, issued at about 57 % of the SMs' rate (2.15 ms,
// PERF.md §6).
//
// The passes, in one launch a (channel block, batch row):
//   1. forward over L, storing the state before every chunk of kSteps
//      steps to a float32 scratch (B, chunks, D, 16);
//   2. the chunks from the last: recompute the chunk's states from its
//      stored one, keeping each step's state AND its decay exp(δ·A) in
//      shared memory, then walk the chunk backwards reading both. So
//      exp(δ·A) is taken twice a (b, l, d, n) (passes 1 and 2's
//      recompute), not three times. In registers the chunk's states and
//      decays would take 2 · kSteps · kOwn more a thread, over the cap of
//      128 that four blocks an SM leave; 8 steps a chunk at two blocks an
//      SM (two waves) measured slower.
// A second, small launch sums the partial dB, dC and dA (below).
//
// The layout, as K8's (csrc/mamba_scan.cu): a channel's 16 states are
// spread over kLanes lanes of one warp; lane j holds the states
// n ≡ j (mod kLanes), kOwn = 16 / kLanes of them, with their decays, g
// and dA sums, in registers. A block is kChannels channels of one batch
// row (kLanes · kChannels threads); the shipped 2 × 64 makes 512 blocks
// at falcon-mamba-7b's layer, all resident (four an SM, 16 warps, 128
// registers, no spills). Four lanes give 32 warps an SM but cap a thread
// at 64 registers and measured slower. e = Σ_n g·B and Σ_n u·A are summed
// over a channel's lanes by log2(kLanes) shuffles. N < 16 is padded with
// zero decays, B and C, whose states and gradients stay 0. A thread's
// states in shared memory and the scratch are vectors of four floats,
// every thread's first vector before any thread's second, so that the
// 16-byte accesses of a warp are contiguous (no bank conflicts).
//
// The staged loads. A ring of kStages raw chunks in shared memory (x, δ
// and, in pass 2, dy for the block's channels; B and, in pass 2, C of the
// batch row, in their own dtypes) is filled by cp.async, 16 bytes a copy,
// kStages − 1 chunks ahead of the walk. The tail of L is zero-filled (δ =
// x = dy = B = C = 0: a step that leaves h, g and dA as they are), so every
// step loop runs kSteps steps. Once a chunk has landed it is converted
// once for the block: (δ, δ·x, x, dy) as a float4 a (step, channel), and
// B and C as float32 in the lanes' order (lane j's kOwn states
// contiguous: a 16-byte shared load gives four). Each pass's step loop
// reads shared memory only. dx and dδ go to shared memory and leave after
// the chunk in 16-byte stores. Rows that are not 16-byte aligned (D or
// N · sizeof(T) not a multiple of 16) are staged by plain loads through the
// same buffers, in an instantiation of their own.
//
// dB and dC without atomics. A step's dB and dC of a lane's kOwn states
// (2 · kOwn = 32 / kLanes values) are summed over the warp's 32 / kLanes
// channels by a transposed butterfly over the lane bits that name the
// channel (2 · kOwn − 1 shuffles: 15 at 2 lanes; its first level, which
// pairs a state's dB with its dC, is taken as each pair is made), after
// which lane (channel c, j) holds the warp's sum of value c. After each
// chunk the block sums its warps' values in shared memory in warp order
// and writes one float32 partial per (channel block, b, l, n) to the
// scratch. dA's partial is each thread's sum over L, one per (b, d, n).
// The second launch sums the partials over the channel blocks (dB, dC)
// and over B (dA), each in index order, and rounds dB and dC to T. It
// takes about 0.05 ms of the call (PERF.md §6), under the 0.1 ms that
// would have kept block-summed atomics instead.
//
// The arithmetic: the state recurrence is h = fmaf(da, h, (δ·x)·B) (one
// rounding fewer than K8's, which rounds as `scan_step`: the two passes
// here recompute the same states as each other, not K8's bits). The decay
// is `ex2.approx.ftz` of δ·(A·log2 e): two instructions where the
// accurate `expf` takes about eight. Every check of K8b holds at its
// tolerance with it, in float32 and in bf16 (tests/test_torch_cuda.py,
// chip_smoke.py's falcon-mamba-7b layer and its 2-layer float32 train step
// against the CPU), and the accurate `expf(δ·A)` measured 0.25 ms slower a
// call (PERF.md §6).
//
// K8B_LANES, K8B_CHANNELS, K8B_STEPS and K8B_STAGES set the layout at
// build time; tools/k8b_layouts.py builds and times others, and
// `mamba_scan.k8b_layout()` reports what was built. The shipped layout is
// the fastest that tool measured holding every check (PERF.md §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#ifndef K8B_LANES
#define K8B_LANES 2
#endif
#ifndef K8B_CHANNELS
#define K8B_CHANNELS 64
#endif
#ifndef K8B_STEPS
#define K8B_STEPS 4
#endif
#ifndef K8B_STAGES
#define K8B_STAGES 3
#endif

namespace {

constexpr int kMaxN = 16;                 // the largest state built for
constexpr int kLanes = K8B_LANES;         // lanes a channel
constexpr int kChannels = K8B_CHANNELS;   // channels a block
constexpr int kSteps = K8B_STEPS;         // steps a chunk
constexpr int kStages = K8B_STAGES;       // raw chunks in the ring
constexpr int kThreads = kLanes * kChannels;
// blocks an SM that __launch_bounds__ asks registers for: 256 channels an
// SM, so that falcon-mamba-7b's B · D = 32,768 channels are all resident
// on 132 SMs (128 registers a thread at 2 lanes, 64 at 4)
constexpr int kBlocks = 256 / kChannels;
static_assert(kBlocks >= 1, "at most 256 channels a block");
constexpr int kWarps = kThreads / 32;
constexpr int kOwn = kMaxN / kLanes;      // states a lane holds
// a lane's states in shared memory and the scratch: kGroups vectors of
// kVec floats, group g of every thread before group g + 1 of any
constexpr int kVec = kOwn < 4 ? kOwn : 4;
constexpr int kGroups = kOwn / kVec;
static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4 || kLanes == 8 ||
              kLanes == 16, "a channel's lanes divide 16 and a warp");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
static_assert(kChannels % 8 == 0, "a block's row is whole 16-byte pieces");
static_assert(kStages >= 2 && kStages <= 4, "a ring of 2 to 4 chunks");
static_assert(kSteps >= 1 && kSteps <= 16, "1 to 16 steps a chunk");
constexpr int kSumThreads = 256;          // threads a block of the sums

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

// f(i) for this thread's share of the tasks i < kTotal, a compile-time
// count: unrolled, so the per-thread index math is shifts that the
// compiler can hoist out of the chunk loop.
template <int kTotal, typename F>
__device__ __forceinline__ void each_task(F&& f) {
#pragma unroll
  for (int u = 0; u < (kTotal + kThreads - 1) / kThreads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (kTotal % kThreads == 0 || i < kTotal) f(i);
  }
}

// exp(δ·A) from δ and A·log2 e.
__device__ __forceinline__ float decay(float dv, float as) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(dv, as)));
  return y;
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
  float* dh0;             // or null
  float* ckpt;            // (B, chunks, D, 16): the state before each chunk
  float* part;            // (channel blocks, B, L, 32): dB (n), dC (16 + n)
  float* part_a;          // (B, D, N): dA summed over L
  int L, D, N, chunks;
};

// Shared memory in bytes: the thread-private states and decays of a
// chunk, (δ, δ·x, x, dy) of a chunk as float4 a (step, channel), B and C
// as float32 in each slot order, the warps' dB and dC, dx and dδ of a
// chunk, and the ring of raw chunks.
template <typename T, typename Y> struct Smem {
  static constexpr int hs = (kSteps + 1) * kThreads * kOwn * 4;
  static constexpr int das = kSteps * kThreads * kOwn * 4;
  static constexpr int xdf = kSteps * kChannels * 16;
  static constexpr int bcf = kSteps * 2 * kMaxN * 4;
  static constexpr int red = kWarps * kSteps * 32 * 4;
  static constexpr int outs = 2 * kSteps * kChannels * (int)sizeof(T);
  static constexpr int xd = kSteps * kChannels * (int)sizeof(T);
  static constexpr int dy = kSteps * kChannels * (int)sizeof(Y);
  static constexpr int bc = kSteps * kMaxN * (int)sizeof(T);
  static constexpr int stage = 2 * xd + dy + 2 * bc;
  static constexpr int total =
      hs + das + xdf + bcf + red + outs + kStages * stage;
};

// A raw stage: x, δ [kSteps][kChannels], dy [kSteps][kChannels], B, C
// [kSteps · N] compact.
template <typename T, typename Y> struct Stage {
  T* x;
  T* d;
  Y* dy;
  T* b;
  T* c;
  __device__ __forceinline__ explicit Stage(char* p)
      : x(reinterpret_cast<T*>(p)),
        d(reinterpret_cast<T*>(p + Smem<T, Y>::xd)),
        dy(reinterpret_cast<Y*>(p + 2 * Smem<T, Y>::xd)),
        b(reinterpret_cast<T*>(p + 2 * Smem<T, Y>::xd + Smem<T, Y>::dy)),
        c(reinterpret_cast<T*>(p + 2 * Smem<T, Y>::xd + Smem<T, Y>::dy +
                               Smem<T, Y>::bc)) {}
};

// Chunk rows l0 .. l0 + len - 1 of batch row `row0` into stage `s`: x, δ
// and B; with `bwd` also dy and C. Rows past len, channels past D and
// B/C entries past len · N are zeros. kAligned: 16-byte cp.async copies
// (rows 16-byte aligned); else plain loads.
template <bool kAligned, typename T, typename Y>
__device__ __forceinline__ void load_chunk(
    const Stage<T, Y>& s, const T* __restrict__ x, const T* __restrict__ dt,
    const Y* __restrict__ dy, const T* __restrict__ bv,
    const T* __restrict__ cv, int64_t row0, int l0, int len, int d0, int D,
    int N, bool bwd) {
  const int64_t bc0 = (row0 + l0) * N;
  if constexpr (kAligned) {
    constexpr int E = 16 / sizeof(T), P = kChannels / E;
    each_task<2 * kSteps * P>([&](int i) {
      const int which = i / (kSteps * P), r = (i / P) % kSteps, q = i % P;
      const bool ok = r < len && d0 + q * E < D;
      const int64_t at = ok ? (row0 + l0 + r) * D + d0 + q * E : 0;
      cp_async16((which ? s.d : s.x) + r * kChannels + q * E,
                 (which ? dt : x) + at, ok);
    });
    if (bwd) {
      constexpr int EY = 16 / sizeof(Y), PY = kChannels / EY;
      each_task<kSteps * PY>([&](int i) {
        const int r = i / PY, q = i % PY;
        const bool ok = r < len && d0 + q * EY < D;
        const int64_t at = ok ? (row0 + l0 + r) * D + d0 + q * EY : 0;
        cp_async16(s.dy + r * kChannels + q * EY, dy + at, ok);
      });
    }
    constexpr int pieces = kSteps * kMaxN / E;   // of each of B and C
    each_task<2 * pieces>([&](int i) {
      const int which = i / pieces, q = i % pieces;
      const bool ok = q * E < len * N;
      if (bwd || !which)
        cp_async16((which ? s.c : s.b) + q * E,
                   (which ? cv : bv) + (ok ? bc0 + q * E : 0), ok);
    });
  } else {
    for (int i = threadIdx.x; i < kSteps * kChannels; i += kThreads) {
      const int r = i / kChannels, c = i % kChannels;
      const bool ok = r < len && d0 + c < D;
      const int64_t at = (row0 + l0 + r) * D + d0 + c;
      s.x[i] = ok ? x[at] : from_f<T>(0.f);
      s.d[i] = ok ? dt[at] : from_f<T>(0.f);
      if (bwd) s.dy[i] = ok ? dy[at] : from_f<Y>(0.f);
    }
    for (int i = threadIdx.x; i < kSteps * N; i += kThreads) {
      const bool ok = i < len * N;
      s.b[i] = ok ? bv[bc0 + i] : from_f<T>(0.f);
      if (bwd) s.c[i] = ok ? cv[bc0 + i] : from_f<T>(0.f);
    }
  }
}

// A landed stage into the walks' form: xdf[t][c] = (δ, δ·x, x, dy) (dy 0
// without `bwd`), bcf[t][0][s] = B and bcf[t][1][s] = C (with `bwd`) of
// state n = j + kLanes·k at slot s = j·kOwn + k (lane j's kOwn states
// contiguous), 0 for n >= N.
template <typename T, typename Y>
__device__ __forceinline__ void convert(const Stage<T, Y>& s, float4* xdf,
                                        float* bcf, int N, bool bwd) {
  each_task<kSteps * kChannels>([&](int i) {
    const float dv = to_f(s.d[i]), xv = to_f(s.x[i]);
    xdf[i] = make_float4(dv, __fmul_rn(dv, xv), xv,
                         bwd ? to_f(s.dy[i]) : 0.f);
  });
  each_task<kSteps * 2 * kMaxN>([&](int i) {
    const int t = i / (2 * kMaxN), w = (i / kMaxN) % 2, sl = i % kMaxN;
    if (w == 1 && !bwd) return;
    const int n = sl / kOwn + kLanes * (sl % kOwn);
    bcf[i] = n < N ? to_f((w ? s.c : s.b)[t * N + n]) : 0.f;
  });
}

// K floats from p in vectors of up to 4, vector i / 4 at p + (i / 4)·gap.
template <int K>
__device__ __forceinline__ void load_own(float (&v)[K], const float* p,
                                         int64_t gap = 4) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i / 4 * gap);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}

template <int K>
__device__ __forceinline__ void store_own(float* p, const float (&v)[K],
                                          int64_t gap = 4) {
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += 4)
      *reinterpret_cast<float4*>(p + i / 4 * gap) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// This thread's kOwn floats of slot `slot` of a thread-private array
// (group g of every thread before group g + 1: conflict-free 16-byte
// accesses); their vectors lie kThreads · kVec floats apart.
__device__ __forceinline__ float* own_slot(float* base, int slot) {
  return base + ((int64_t)slot * kGroups * kThreads + threadIdx.x) * kVec;
}
constexpr int kSlotGap = kThreads * kVec;

// The butterfly's first level, over lane bit 16 (the top bit of the
// channel's index in the warp): of a state's (dB, dC) a lane keeps the one
// its bit selects and adds its partner's copy of it.
__device__ __forceinline__ float fold_pair(float db, float dc, int lane) {
  const bool upper = (lane & 16) != 0;
  return (upper ? dc : db) +
         __shfl_xor_sync(0xffffffffu, upper ? db : dc, 16);
}

// The levels W .. 1 below it, over lane bits W · kLanes .. kLanes: a lane
// keeps the half of v[0 .. 2W) its bit selects and adds its partner's
// copy of it. Lane (c, j) ends with v[0] = the sum over the warp's
// channels (lanes j, j + kLanes, ...) of their value c.
template <int W, int K>
__device__ __forceinline__ void fold(float (&v)[K], int lane) {
  if constexpr (W >= 1) {
    const bool upper = (lane & (W * kLanes)) != 0;
#pragma unroll
    for (int i = 0; i < W; ++i)
      v[i] = (upper ? v[i + W] : v[i]) +
             __shfl_xor_sync(0xffffffffu, upper ? v[i] : v[i + W],
                             W * kLanes);
    fold<W / 2>(v, lane);
  }
}

// Sum over a channel's kLanes lanes (every lane gets the same bits).
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int m = 1; m < kLanes; m *= 2) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// The forward recurrence over a converted chunk from h; with kKeep each
// step's state and decay go to this thread's slots of hs (from slot 1)
// and das. bcm: this lane's B and C.
template <bool kKeep>
__device__ __forceinline__ void forward_chunk(
    const float4* xdf, const float* bcm, float* hs, float* das,
    const float (&as)[kOwn], float (&h)[kOwn], int cl) {
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    const float4 q = xdf[t * kChannels + cl];      // (δ, δ·x, x, dy)
    float bq[kOwn], da[kOwn];
    load_own(bq, bcm + t * 2 * kMaxN);
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      da[k] = decay(q.x, as[k]);
      h[k] = fmaf(da[k], h[k], __fmul_rn(q.y, bq[k]));
    }
    if constexpr (kKeep) {
      store_own(own_slot(hs, t + 1), h, kSlotGap);
      store_own(own_slot(das, t), da, kSlotGap);
    }
  }
}

// dx and dδ of a chunk's len rows from shared memory to their rows.
template <bool kAligned, typename T>
__device__ __forceinline__ void store_rows(const T* src, T* __restrict__ dst,
                                           int64_t row0, int l0, int len,
                                           int d0, int D) {
  if constexpr (kAligned) {
    constexpr int E = 16 / sizeof(T), P = kChannels / E;
    each_task<kSteps * P>([&](int i) {
      const int r = i / P, q = i % P;
      if (r < len && d0 + q * E < D)
        *reinterpret_cast<uint4*>(dst + (row0 + l0 + r) * D + d0 + q * E) =
            *reinterpret_cast<const uint4*>(src + r * kChannels + q * E);
    });
  } else {
    for (int i = threadIdx.x; i < len * kChannels; i += kThreads) {
      const int r = i / kChannels, c = i % kChannels;
      if (d0 + c < D) dst[(row0 + l0 + r) * D + d0 + c] = src[i];
    }
  }
}

template <typename T, typename Y, bool kAligned>
__global__ void __launch_bounds__(kThreads, kBlocks)
scan_bwd_kernel(Args a) {
  extern __shared__ __align__(16) char smem[];
  using S = Smem<T, Y>;
  float* hs = reinterpret_cast<float*>(smem);   // [kSteps+1][kThreads][kOwn]
  float* das = reinterpret_cast<float*>(smem + S::hs);
  float4* xdf = reinterpret_cast<float4*>(smem + S::hs + S::das);
  float* bcf = reinterpret_cast<float*>(smem + S::hs + S::das + S::xdf);
  float* red = bcf + S::bcf / 4;                // [kWarps][kSteps][32]
  T* odx = reinterpret_cast<T*>(red + S::red / 4);
  T* odd = odx + kSteps * kChannels;
  char* ring = reinterpret_cast<char*>(odd + kSteps * kChannels);
  const T* x = static_cast<const T*>(a.x);
  const T* dt = static_cast<const T*>(a.dt);
  const T* bv = static_cast<const T*>(a.bv);
  const T* cv = static_cast<const T*>(a.cv);
  const Y* dy = static_cast<const Y*>(a.dy);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cl = tid / kLanes, j = tid % kLanes;
  const int cw = lane / kLanes;     // the channel's index in the warp
  const int b = blockIdx.y, d0 = blockIdx.x * kChannels, d = d0 + cl;
  const int D = a.D, N = a.N, L = a.L, chunks = a.chunks;
  const bool live = d < D;
  const int64_t row0 = (int64_t)b * L;
  const int64_t hrow = ((int64_t)b * D + d) * N;     // this channel's state
  // this thread's states in the scratch: chunk c at + c · D · 16, its
  // vectors ck_gap apart (every thread's group g before group g + 1)
  float* ck = a.ckpt + (int64_t)b * chunks * D * kMaxN +
              ((int64_t)d * kLanes + j) * kVec;
  const int64_t ck_chunk = (int64_t)D * kMaxN, ck_gap = (int64_t)D * kLanes
                                                          * kVec;
  const float* bcm = bcf + j * kOwn;

  float as[kOwn], av[kOwn], h[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int n = j + kLanes * k;
    const bool own = live && n < N;
    av[k] = own ? a.A[(int64_t)d * N + n] : 0.f;
    as[k] = __fmul_rn(av[k], 1.4426950408889634f);  // A·log2 e
    h[k] = own && a.h0 != nullptr ? a.h0[hrow + n] : 0.f;
  }
  auto stage = [&](int i) { return Stage<T, Y>(ring + i * S::stage); };
  auto load = [&](int slot, int c, bool bwd) {
    load_chunk<kAligned>(stage(slot), x, dt, dy, bv, cv, row0, c * kSteps,
                     min(kSteps, L - c * kSteps), d0, D, N, bwd);
  };

  // pass 1: forward, the state before every chunk to the scratch
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, s, false);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // chunk c staged; chunk c - 1 walked
    const int next = c + kStages - 1;
    if (next < chunks) load(next % kStages, next, false);
    cp_async_commit();
    convert(stage(c % kStages), xdf, bcf, N, false);
    __syncthreads();
    if (live) store_own(ck + c * ck_chunk, h, ck_gap);
    forward_chunk<false>(xdf, bcm, hs, das, as, h, cl);
  }

  // pass 2: the chunks from the last, each recomputed then walked back
  cp_async_wait<0>();
  __syncthreads();                   // pass 1's last chunk walked
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks) load(s, chunks - 1 - s, true);
    cp_async_commit();
  }
  float g[kOwn], dA[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int n = j + kLanes * k;
    const bool own = live && n < N;
    g[k] = own && a.dh_last != nullptr ? a.dh_last[hrow + n] : 0.f;
    dA[k] = 0.f;
  }
  // where this lane's warp sum lands among a step's 32: dB n, dC 16 + n
  const int vslot = (cw < kOwn ? 0 : kMaxN) + j + kLanes * (cw % kOwn);
  // a walked chunk's dB/dC partials and dx/dδ rows, to device memory
  auto flush = [&](int c) {
    const int l0 = c * kSteps, len = min(kSteps, L - l0);
    float* part = a.part + (((int64_t)blockIdx.x * gridDim.y + b) * L + l0)
                               * 32;
    each_task<kSteps * 32>([&](int i) {
      const int t = i / 32, v = i % 32;
      float sum = red[t * 32 + v];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[(w * kSteps + t) * 32 + v];
      if (t < len) part[i] = sum;
    });
    store_rows<kAligned>(odx, static_cast<T*>(a.dx), row0, l0, len, d0, D);
    store_rows<kAligned>(odd, static_cast<T*>(a.ddt), row0, l0, len, d0, D);
  };
  for (int i = 0; i < chunks; ++i) {
    const int c = chunks - 1 - i;
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // chunk c staged; chunk c + 1 walked
    if (i > 0) flush(c + 1);
    const int next = i + kStages - 1;
    if (next < chunks) load(next % kStages, chunks - 1 - next, true);
    cp_async_commit();
    float hc[kOwn];                  // the state before the chunk
#pragma unroll
    for (int k = 0; k < kOwn; ++k) hc[k] = 0.f;
    if (live) load_own(hc, ck + c * ck_chunk, ck_gap);
    convert(stage(i % kStages), xdf, bcf, N, true);
    __syncthreads();                 // converted; red, odx, odd flushed
    store_own(own_slot(hs, 0), hc, kSlotGap);
#pragma unroll
    for (int k = 0; k < kOwn; ++k) h[k] = hc[k];
    forward_chunk<true>(xdf, bcm, hs, das, as, h, cl);
    // h is the chunk's last state; walk back from it
#pragma unroll
    for (int t = kSteps - 1; t >= 0; --t) {
      const float4 q = xdf[t * kChannels + cl];    // (δ, δ·x, x, dy)
      float bq[kOwn], cq[kOwn], hp[kOwn], da[kOwn], vals[kOwn];
      load_own(bq, bcm + t * 2 * kMaxN);
      load_own(cq, bcm + t * 2 * kMaxN + kMaxN);
      load_own(hp, own_slot(hs, t), kSlotGap);            // h_{t-1}
      load_own(da, own_slot(das, t), kSlotGap);
      float e = 0.f, du = 0.f;
#pragma unroll
      for (int k = 0; k < kOwn; ++k) {
        g[k] = fmaf(q.w, cq[k], g[k]);
        vals[k] = fold_pair(g[k] * q.y, q.w * h[k], lane);   // dB, dC
        e = fmaf(g[k], bq[k], e);
        const float gd = g[k] * da[k];
        const float u = gd * hp[k];
        du = fmaf(u, av[k], du);
        dA[k] = fmaf(u, q.x, dA[k]);
        g[k] = gd;
        h[k] = hp[k];
      }
      e = lanes_sum(e);
      du = lanes_sum(du);
      if (j == 0) {
        odx[t * kChannels + cl] = from_f<T>(e * q.x);
        odd[t * kChannels + cl] = from_f<T>(fmaf(e, q.z, du));
      }
      fold<kOwn / 2>(vals, lane);
      red[(warp * kSteps + t) * 32 + vslot] = vals[0];
    }
  }
  __syncthreads();
  flush(0);
  if (live) {
#pragma unroll
    for (int k = 0; k < kOwn; ++k) {
      const int n = j + kLanes * k;
      if (n >= N) continue;
      a.part_a[hrow + n] = dA[k];
      if (a.dh0 != nullptr) a.dh0[hrow + n] = g[k];
    }
  }
}

// The partials' sums, each in index order: dB[b, l, n] and dC over the
// channel blocks, rounded to T; dA[d, n] over the batch rows.
template <typename T>
__global__ void __launch_bounds__(kSumThreads)
scan_bwd_kernel_sum(const float* __restrict__ part,
                    const float* __restrict__ part_a, T* __restrict__ dB,
                    T* __restrict__ dC, float* __restrict__ dA, int B, int L,
                    int D, int N, int blocks) {
  const int64_t rows = (int64_t)B * L;
  const int64_t nbc = rows * 2 * N, total = nbc + (int64_t)D * N;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    if (i < nbc) {
      const int64_t r = i / (2 * N);
      const int w = (int)(i % (2 * N));
      const float* p = part + r * 32 + (w < N ? w : kMaxN + w - N);
      float sum = p[0];
#pragma unroll 8
      for (int k = 1; k < blocks; ++k) sum += p[k * rows * 32];
      if (w < N) dB[r * N + w] = from_f<T>(sum);
      else dC[r * N + w - N] = from_f<T>(sum);
    } else {
      const int64_t k = i - nbc;                 // d · N + n
      float sum = part_a[k];
      for (int bb = 1; bb < B; ++bb) sum += part_a[(int64_t)bb * D * N + k];
      dA[k] = sum;
    }
  }
}

int channel_blocks(int D) { return (D + kChannels - 1) / kChannels; }

int64_t ckpt_floats(int B, int L, int D) {
  return (int64_t)B * ((L + kSteps - 1) / kSteps) * D * kMaxN;
}

template <typename T, typename Y, bool kAligned>
cudaError_t configure() {
  const auto kern = scan_bwd_kernel<T, Y, kAligned>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T, Y>::total);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T, typename Y>
cudaError_t launch(const Args& a, bool vec, T* dB, T* dC, float* dA, int B,
                   cudaStream_t s) {
  cudaError_t err = vec ? configure<T, Y, true>() : configure<T, Y, false>();
  if (err != cudaSuccess) return err;
  const dim3 grid(channel_blocks(a.D), B);
  if (vec)
    scan_bwd_kernel<T, Y, true><<<grid, kThreads, Smem<T, Y>::total, s>>>(a);
  else
    scan_bwd_kernel<T, Y, false><<<grid, kThreads, Smem<T, Y>::total, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total = (int64_t)B * a.L * 2 * a.N + (int64_t)a.D * a.N;
  const dim3 sums((unsigned)((total + kSumThreads - 1) / kSumThreads));
  scan_bwd_kernel_sum<T><<<sums, kSumThreads, 0, s>>>(
      a.part, a.part_a, dB, dC, dA, B, a.L, a.D, a.N, channel_blocks(a.D));
  return cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// The float32 scratch a call takes: the states every chunk, the dB/dC
// partials of every channel block and dA's of every batch row.
extern "C" long long mamba1_scan_bwd_scratch(int B, int L, int D, int N) {
  return ckpt_floats(B, L, D) + (int64_t)channel_blocks(D) * B * L * 32 +
         (int64_t)B * D * N;
}

// bf16 = 1: x, δ, B, C, dx, dδ, dB and dC are __nv_bfloat16, else float;
// dy_f32 = 1: dy is float, else x's type. h0, dh_last and dh0 may be null.
// scratch holds mamba1_scan_bwd_scratch(B, L, D, N) floats. The wrapper
// has checked shapes and 1 <= N <= 16. Two launches: the scan, then the
// partials' sums into dB, dC and dA.
extern "C" int mamba1_scan_bwd_launch(
    const void* x, const void* dt, const void* bv, const void* cv,
    const void* A, const void* h0, const void* dy, const void* dh_last,
    void* dx, void* ddt, void* dB, void* dC, void* dA, void* dh0,
    void* scratch, int B, int L, int D, int N, int bf16, int dy_f32,
    int device, void* stream) {
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
  a.dh0 = static_cast<float*>(dh0);
  a.ckpt = static_cast<float*>(scratch);
  a.part = a.ckpt + ckpt_floats(B, L, D);
  a.part_a = a.part + (int64_t)channel_blocks(D) * B * L * 32;
  a.L = L;
  a.D = D;
  a.N = N;
  a.chunks = (L + kSteps - 1) / kSteps;
  const int size = bf16 ? 2 : 4;
  const bool vec = (int64_t)D * size % 16 == 0 && N * size % 16 == 0 &&
                   aligned16(x) && aligned16(dt) && aligned16(bv) &&
                   aligned16(cv) && aligned16(dy) && aligned16(dx) &&
                   aligned16(ddt);
  const cudaStream_t s = (cudaStream_t)stream;
  float* fA = static_cast<float*>(dA);
  if (bf16 && dy_f32)
    err = launch<__nv_bfloat16, float>(a, vec, (__nv_bfloat16*)dB,
                                       (__nv_bfloat16*)dC, fA, B, s);
  else if (bf16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(a, vec, (__nv_bfloat16*)dB,
                                               (__nv_bfloat16*)dC, fA, B, s);
  else
    err = launch<float, float>(a, vec, (float*)dB, (float*)dC, fA, B, s);
  return (int)err;
}

// The layout this library was built with: lanes a channel, channels a
// block, steps a chunk, raw chunks in the ring, the blocks an SM asked of
// __launch_bounds__; then, for the training
// path's instantiation (bf16 in, float32 dy, aligned rows), its shared
// memory bytes a block, registers a thread and resident blocks an SM (0
// and 0 when the runtime cannot say). Returns a CUDA error.
extern "C" int mamba1_scan_bwd_layout(int* out) {
  out[0] = kLanes;
  out[1] = kChannels;
  out[2] = kSteps;
  out[3] = kStages;
  out[4] = kBlocks;
  out[5] = Smem<__nv_bfloat16, float>::total;
  out[6] = out[7] = 0;
  const auto kern = scan_bwd_kernel<__nv_bfloat16, float, true>;
  cudaError_t err = configure<__nv_bfloat16, float, true>();
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  out[6] = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[7], kern, kThreads, Smem<__nv_bfloat16, float>::total);
}
