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
// What bounds it: memory in principle — each row reads cap mask bytes (and
// the kept values) and writes three (K6: two) cap-wide int32/float32 arrays
// once — but at the main path's size (144 rows of 969 slots, 1.8 MB) the
// bytes take 0.6 µs, so a launch is a chain of latencies: loads, barriers,
// scans, stores.
//
// What the design does about it: the chain is made as short as the scan
// allows. The TPU kernel took the prefix sum as a product with a triangular
// matrix (Mosaic has no scan) and placed values by a one-hot contraction,
// O(cap²) a row; here
// - pack_kernel: one block a row, for every cap. Thread t owns slots
//   tile + j·K5_THREADS + t for j < K5_SLOTS, so every load and every pinv
//   store of a warp is one coalesced run, with no alignment assumed (rows
//   start at r·cap). A thread issues all of a tile's mask loads (and, for
//   K5, its value loads) before any barrier: one round of loads a tile, and
//   at 969 slots one tile a row. A warp counts each j by `__ballot_sync` and
//   `__popc`; lane 0 puts the (j, warp) counts in shared memory, in slot
//   order, and after ONE `__syncthreads` every warp scans those counts
//   itself (a warp scan by `__shfl_up_sync`), so no second barrier hands
//   the offsets out. Kept slots then write pinv, sids and pvals, and the
//   same threads fill sids/pvals past min(count, limit). A longer row loops
//   over tiles with a running carry, the counts double-buffered so that
//   there is still one barrier a tile, and the next tile's mask loads go
//   out before the current tile's barrier. A thread loads the values of its
//   active slots once their mask bytes are in, still before the barrier.
//   No CUB call.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef K5_THREADS
#define K5_THREADS 256
#endif
#ifndef K5_SLOTS
#define K5_SLOTS 4
#endif

namespace {

constexpr int kPad = -1;
constexpr int kThreads = K5_THREADS;          // a row's threads
constexpr int kSlots = K5_SLOTS;              // a thread's slots a tile
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kSlots;
constexpr int kCounts = kWarps * kSlots;      // (j, warp) counts a tile
constexpr int kPerLane = (kCounts + 31) / 32; // of them a lane scans
static_assert(kThreads % 32 == 0 && kThreads >= 32 && kThreads <= 1024,
              "K5_THREADS: whole warps, at most 1024");
static_assert(kSlots >= 1 && kSlots <= 32, "K5_SLOTS: 1..32 (a bit mask)");

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The tile's mask bits of thread t: bit j is slot tile + j·kThreads + t.
// All loads are issued before the first is used.
__device__ __forceinline__ unsigned load_bits(const uint8_t* __restrict__ a,
                                              int tile, int t, int cap) {
  uint8_t m[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = tile + j * kThreads + t;
    m[j] = i < cap ? a[i] : 0;
  }
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) bits |= (m[j] != 0 ? 1u : 0u) << j;
  return bits;
}

// The values of thread t's active slots in the tile.
__device__ __forceinline__ void load_vals(const float* __restrict__ v_row,
                                          int tile, int t, unsigned bits,
                                          float* v) {
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int i = tile + j * kThreads + t;
    v[j] = ((bits >> j) & 1u) != 0 ? v_row[i] : 0.0f;
  }
}

// VALS = true: K5 (limit, vals, pvals, over are used); false: K6.
template <bool VALS>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const uint8_t* __restrict__ active, const float* __restrict__ vals,
            const int* __restrict__ limit, float ident,
            float* __restrict__ pvals, int* __restrict__ sids,
            int* __restrict__ pinv, int* __restrict__ counts,
            int* __restrict__ over, int cap) {
  __shared__ int tile_counts[2][kCounts];
  const int row = blockIdx.x;
  const int64_t base = (int64_t)row * cap;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const uint8_t* a_row = active + base;
  const float* v_row = VALS ? vals + base : nullptr;
  const int lim = VALS ? limit[row] : cap;
  unsigned bits = load_bits(a_row, 0, t, cap);
  float v[kSlots];
  if (VALS) load_vals(v_row, 0, t, bits, v);
  int carry = 0;  // active slots before this tile; the same in every thread
  int buf = 0;
  for (int tile = 0; tile < cap; tile += kTile) {
    int before[kSlots];  // active slots of this warp's j-run before lane
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const unsigned b = __ballot_sync(0xffffffffu, (bits >> j) & 1u);
      before[j] = __popc(b & below);
      if (lane == 0) tile_counts[buf][j * kWarps + warp] = __popc(b);
    }
    const int next = tile + kTile;
    unsigned next_bits = 0;
    if (next < cap) next_bits = load_bits(a_row, next, t, cap);
    __syncthreads();
    // Every warp scans the tile's counts (slot order: j, then warp). Lane
    // l holds counts l·kPerLane .. l·kPerLane + kPerLane - 1.
    int c[kPerLane];
    int sum = 0;
#pragma unroll
    for (int m = 0; m < kPerLane; ++m) {
      const int q = lane * kPerLane + m;
      c[m] = q < kCounts ? tile_counts[buf][q] : 0;
      sum += c[m];
    }
    const int incl = warp_inclusive_scan(sum, lane);
    const int tile_count = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int q = j * kWarps + warp;     // the same in the whole warp
      const int qm = q % kPerLane;
      int mine = incl - sum;               // exclusive prefix at count q
#pragma unroll
      for (int m = 0; m < kPerLane - 1; ++m)
        if (m < qm) mine += c[m];
      const int off = __shfl_sync(0xffffffffu, mine, q / kPerLane);
      const int i = tile + j * kThreads + t;
      if (i < cap) {
        const int pos = carry + off + before[j];
        const bool keep = ((bits >> j) & 1u) && pos < lim;
        pinv[base + i] = keep ? pos : kPad;
        if (keep) {
          sids[base + pos] = i;
          if (VALS) pvals[base + pos] = v[j];
        }
      }
    }
    carry += tile_count;
    // the next tile's values: its mask bytes have long been in
    if (next < cap) {
      bits = next_bits;
      if (VALS) load_vals(v_row, next, t, bits, v);
    }
    buf ^= 1;
  }
  const int filled = max(0, min(carry, lim));
  for (int p = filled + t; p < cap; p += kThreads) {
    sids[base + p] = kPad;
    if (VALS) pvals[base + p] = ident;
  }
  if (t == 0) {
    counts[row] = carry;
    if (VALS) over[row] = carry > lim ? 1 : 0;
  }
}

// The launch floor: a kernel that does nothing, on K5's grid.
__global__ void empty_kernel() {}

// Make `device` current only where it is not: the runtime call is skipped
// on the usual path, where the caller's device already is the tensors'.
cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

template <bool VALS>
int launch(const void* active, const void* vals, const void* limit,
           void* pvals, void* sids, void* pinv, void* counts, void* over,
           int rows, int cap, float ident, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  pack_kernel<VALS><<<rows, kThreads, 0, s>>>(
      (const uint8_t*)active, (const float*)vals, (const int*)limit, ident,
      (float*)pvals, (int*)sids, (int*)pinv, (int*)counts, (int*)over, cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int outbox_pack_launch(const void* active, const void* vals,
                                  const void* limit, void* pvals, void* sids,
                                  void* pinv, void* counts, void* over,
                                  int rows, int cap, float ident, int device,
                                  void* stream) {
  return launch<true>(active, vals, limit, pvals, sids, pinv, counts, over,
                      rows, cap, ident, device, stream);
}

extern "C" int outbox_compact_plan_launch(const void* active, void* pfwd,
                                          void* pinv, void* counts, int rows,
                                          int cap, int device, void* stream) {
  return launch<false>(active, nullptr, nullptr, nullptr, pfwd, pinv, counts,
                       nullptr, rows, cap, 0.0f, device, stream);
}

// An empty kernel on K5's grid: `rows` blocks of a row's threads.
extern "C" int outbox_launch_floor(int rows, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  empty_kernel<<<rows, kThreads, 0, s>>>();
  return (int)cudaGetLastError();
}

// out[2]: threads, slots.
extern "C" void outbox_pack_layout(int* out) {
  out[0] = kThreads;
  out[1] = kSlots;
}
