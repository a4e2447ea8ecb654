// K5: the compact exchange's pack — per mailbox row, the compaction plan,
// truncation at a slot budget, the value pack and the overflow flag — and
// K6, the same plan without values or budget.
//
// Replaces: the JAX package's Pallas kernels `outbox_pack_pallas` (K5) and
// `outbox_compact_plan_pallas` (K6), src/repro/kernels/outbox_compact.py,
// bodies `_pack_kernel` and `_compact_plan_kernel`.
//
// Contract (kernels/ref.py `outbox_pack_ref`, `outbox_compact_plan_ref`):
// for row r with active mask a (0/1 bytes: a torch.bool is one uint8) the
// packed position of active slot i is (inclusive prefix count of a at i)
// - 1. A slot is kept when its position is below limit[r]; then
// pinv[r, i] = position, sids[r, position] = i and pvals[r, position] =
// vals[r, i], copied, never multiplied, so an active ±inf survives. Every
// other pinv entry is PAD (-1); sids past min(count, limit) is PAD and
// pvals there the identity. counts[r] is the untruncated count and
// over[r] = count > limit. K6 writes pfwd (= sids), pinv and counts with
// no budget (limit = cap).
//
// What bounds it: memory, and at the main path's size (144 rows of 969
// slots) launch latency. Each row reads cap mask bytes (and cap values)
// and writes three (K6: two) cap-wide int32/float32 arrays once.
//
// What the design does about it: one block per row. The TPU kernel took
// the prefix sum as a product with a triangular matrix (Mosaic has no
// scan) and placed values by a one-hot contraction, O(cap²) a row; here
// the block walks the row in chunks of 256 slots with an inclusive scan:
// a warp scan by `__shfl_up_sync`, one pass over the eight warp totals in
// shared memory, and a running carry across chunks. Kept slots write their
// outputs directly; the tail past min(count, limit) is filled after the
// walk, so every output entry is written once. No CUB call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = -1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// VALS = true: K5 (limit, vals, pvals, over are used); false: K6.
template <bool VALS>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint8_t* __restrict__ active, const float* __restrict__ vals,
            const int* __restrict__ limit, float ident,
            float* __restrict__ pvals, int* __restrict__ sids,
            int* __restrict__ pinv, int* __restrict__ counts,
            int* __restrict__ over, int cap) {
  __shared__ int warp_off[kWarps];
  __shared__ int chunk_total;
  const int64_t base = (int64_t)blockIdx.x * cap;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lim = VALS ? limit[blockIdx.x] : cap;
  int carry = 0;  // active slots before this chunk; the same in every thread
  for (int c0 = 0; c0 < cap; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    const int a = (i < cap && active[base + i] != 0) ? 1 : 0;
    const int incl = warp_inclusive_scan(a, lane);
    if (lane == 31) warp_off[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < kWarps ? warp_off[lane] : 0;
      const int wi = warp_inclusive_scan(w, lane);
      if (lane < kWarps) warp_off[lane] = wi - w;  // exclusive warp offsets
      if (lane == kWarps - 1) chunk_total = wi;
    }
    __syncthreads();
    if (i < cap) {
      const int pos = carry + warp_off[warp] + incl - 1;
      const bool keep = a && pos < lim;
      pinv[base + i] = keep ? pos : kPad;
      if (keep) {
        sids[base + pos] = i;
        if (VALS) pvals[base + pos] = vals[base + i];
      }
    }
    carry += chunk_total;
    __syncthreads();  // warp_off and chunk_total are rewritten next chunk
  }
  const int filled = max(0, min(carry, lim));
  for (int j = filled + threadIdx.x; j < cap; j += kThreads) {
    sids[base + j] = kPad;
    if (VALS) pvals[base + j] = ident;
  }
  if (threadIdx.x == 0) {
    counts[blockIdx.x] = carry;
    if (VALS) over[blockIdx.x] = carry > lim ? 1 : 0;
  }
}

}  // namespace

extern "C" int outbox_pack_launch(const void* active, const void* vals,
                                  const void* limit, void* pvals, void* sids,
                                  void* pinv, void* counts, void* over,
                                  int rows, int cap, float ident, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  pack_kernel<true><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)active, (const float*)vals, (const int*)limit, ident,
      (float*)pvals, (int*)sids, (int*)pinv, (int*)counts, (int*)over, cap);
  return (int)cudaGetLastError();
}

extern "C" int outbox_compact_plan_launch(const void* active, void* pfwd,
                                          void* pinv, void* counts, int rows,
                                          int cap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  pack_kernel<false><<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)active, nullptr, nullptr, 0.0f, nullptr, (int*)pfwd,
      (int*)pinv, (int*)counts, nullptr, cap);
  return (int)cudaGetLastError();
}
