// K3: one fused superstep of a scalar idempotent-semiring program over flat
// (n = P·v_max) state: gated mailbox delivery, inbox ⊕-combine, the masked
// local fixpoint, the new send set and per-partition sweep counts.
// K4 (below K3): the resident narrow-phase loop, many relaxation rounds of
// one delivery and ONE masked sweep each, in one launch.
//
// Replaces: the JAX package's Pallas kernel `megastep_semiring_pallas`
// (src/repro/kernels/megastep.py, body `_megastep_kernel`). Outputs match
// it, and the plain `megastep_semiring_ref`, bit for bit:
//   x2 (n) f32, changed2 (n) bool, frontier_left (n) bool, liters (P) i32.
//
// What bounds it on an H100: memory, per sweep of the fixpoint. A sweep
// reads the PAD-filled adjacency once, n·D·4 B of nbr (plus n·D·4 B of wgt
// for min_plus), and n·(4+1) of state, and writes n·(4+1); the gathered x
// and frontier stay in the 50 MB L2 at the main path's size. The superstep costs that times its sweep
// count, which the data decides (road networks take hundreds of sweeps).
//
// What the design does about it: the TPU kernel ran grid=(1,) with the
// whole problem in VMEM; one SM's 227 KB cannot hold a road network, so
// this kernel spreads the rows over every SM. It is ONE cooperative launch
// per superstep with at most as many blocks as can be co-resident; rows are
// walked grid-stride and `grid.sync()` separates the phases, so the
// fixpoint loop never returns to the host. A row whose in-neighbours are all
// outside the frontier skips the x gather (the frontier pass reads 1 byte a
// lane), which is most rows once a region settles.
//
// Places where bit identity with the JAX kernel is easily lost:
//  * Sweeps are Jacobi: each reads (xc, fc) and writes (xn, fn) in separate
//    buffers, swapped after the barrier. Updating in place (Gauss-Seidel)
//    reaches the same fixpoint but changes liters, changed_hist and the
//    superstep count.
//  * The "any f" flags live in a ring of three (P+1)-int slots: sweep k
//    writes slot (k+1)%3 and clears slot (k+2)%3, the slot every block
//    finished reading before the previous barrier. With two slots a fast
//    block would clear a flag a slow block has not read yet.
//  * `act` follows ref.py's semiring_spmv_frontier_ref: a row with no active
//    in-neighbour yields the identity, not its recomputed value.
//  * The identities are ±inf and `x2 != xc` is a float compare; min/max are
//    plain compares (no NaN reaches them), and the only arithmetic on an
//    identity is inf + w in min_plus, which stays inf. `__fadd_rn` keeps
//    nvcc from contracting anything.
//  * Mutable buffers (xc, fc, flags) are read with `__ldcg` (L2, not the
//    non-coherent L1), so a row sees what other SMs wrote before the
//    barrier. Read-only inputs use `__ldg`.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxIt = 1 << 30;
constexpr int kMaxDevices = 64;

struct Args {
  const float* x;
  const uint8_t* changed;
  const uint8_t* frontier;
  const uint8_t* vmask;
  const int* nbr;  // flat state indices, PAD (-1) lanes kept
  const float* wgt;
  const int* lo_src;
  const uint8_t* lo_ok;
  const float* lo_w;
  const int* hub_src;
  const uint8_t* hub_ok;
  const float* hub_w;
  const int* hub_row;
  const uint8_t* hub_row_ok;
  float* x_out;
  uint8_t* ch_out;
  uint8_t* fr_out;
  int* liters;
  float* x_tmp;
  uint8_t* f_tmp;
  int* flags;  // 3 slots of (P+1): per-partition "any f", then global
  int* iters;  // K4 only: rounds run
  int n, d, m_lo, m_hi, num_parts, v_max, unroll, max_steps;
};

// a load of a buffer other blocks write during the launch goes through L2
// (CG); a read-only input may use the non-coherent path
template <bool CG, typename T>
__device__ __forceinline__ T ld(const T* p) {
  return CG ? __ldcg(p) : __ldg(p);
}

template <bool MINP>
__device__ __forceinline__ float ident() {
  return MINP ? INFINITY : -INFINITY;
}

template <bool MINP>
__device__ __forceinline__ float oplus(float a, float b) {
  return MINP ? (b < a ? b : a) : (b > a ? b : a);
}

// ⊕ over one feed row: lanes whose feed is valid AND whose source vertex is
// in the previous round's send set (``chs``); min_plus adds the edge weight
template <bool MINP, bool CG>
__device__ __forceinline__ float reduce_feeds(const float* xs,
                                              const uint8_t* chs,
                                              const int* src,
                                              const uint8_t* ok,
                                              const float* w, int64_t base,
                                              int m) {
  float acc = ident<MINP>();
  for (int k = 0; k < m; ++k) {
    const int64_t i = base + k;
    if (!__ldg(ok + i)) continue;
    const int s = __ldg(src + i);
    if (!ld<CG>(chs + s)) continue;
    float g = ld<CG>(xs + s);
    if (MINP) g = __fadd_rn(g, __ldg(w + i));
    acc = oplus<MINP>(acc, g);
  }
  return acc;
}

// the inbox of row v: its lo feed lanes and, where it has one, its hub row
// (each vertex has at most one hub feed row: a gather, no scatter)
template <bool MINP, bool CG>
__device__ __forceinline__ float inbox_of(const Args& a, int64_t v,
                                          const float* xs,
                                          const uint8_t* chs) {
  float inbox = reduce_feeds<MINP, CG>(xs, chs, a.lo_src, a.lo_ok, a.lo_w,
                                       v * a.m_lo, a.m_lo);
  if (__ldg(a.hub_row_ok + v)) {
    const int64_t r = __ldg(a.hub_row + v);
    inbox = oplus<MINP>(inbox, reduce_feeds<MINP, CG>(
        xs, chs, a.hub_src, a.hub_ok, a.hub_w, r * a.m_hi, a.m_hi));
  }
  return inbox;
}

__device__ __forceinline__ void mark(int* sflag, const Args& a, int64_t v) {
  sflag[v / a.v_max] = 1;
  sflag[a.num_parts] = 1;
}

__device__ __forceinline__ void clear_block_flags(int* sflag, int p1) {
  __syncthreads();
  for (int i = threadIdx.x; i < p1; i += blockDim.x) sflag[i] = 0;
  __syncthreads();
}

__device__ __forceinline__ void flush_block_flags(const int* sflag, int* g,
                                                  int p1) {
  __syncthreads();
  for (int i = threadIdx.x; i < p1; i += blockDim.x)
    if (sflag[i]) g[i] = 1;  // every writer stores 1: a benign race
}

// one Jacobi row update of the masked sweep (ref.py semiring_spmv_frontier_ref):
// row v's new value from (xc, fc); xv is set to xc[v]
template <bool MINP>
__device__ __forceinline__ float sweep_value(const Args& a, int64_t v,
                                             const float* xc,
                                             const uint8_t* fc, float& xv) {
  const int64_t base = v * a.d;
  bool act = false;
  for (int j = 0; j < a.d && !act; ++j) {
    const int s = __ldg(a.nbr + base + j);
    act = s >= 0 && __ldcg(fc + s);
  }
  xv = __ldcg(xc + v);
  if (!act) return xv;
  float y = ident<MINP>();
  for (int j = 0; j < a.d; ++j) {
    const int64_t i = base + j;
    const int s = __ldg(a.nbr + i);
    if (s < 0) continue;
    float g = __ldcg(xc + s);
    if (MINP) g = __fadd_rn(g, __ldg(a.wgt + i));
    y = oplus<MINP>(y, g);
  }
  return oplus<MINP>(xv, y);
}

template <bool MINP>
__device__ __forceinline__ void sweep_row(const Args& a, int64_t v,
                                          const float* xc, const uint8_t* fc,
                                          float* xn, uint8_t* fn,
                                          int* sflag) {
  float xv;
  const float x2 = sweep_value<MINP>(a, v, xc, fc, xv);
  const bool f2 = (x2 != xv) && __ldg(a.vmask + v);
  xn[v] = x2;
  fn[v] = f2;
  if (f2) mark(sflag, a, v);
}

template <bool MINP>
__global__ void __launch_bounds__(kThreads) megastep_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int sflag[];
  const int P = a.num_parts;
  const int p1 = P + 1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;

  // phases 1-2: delivery, inbox combine, the fixpoint's starting frontier
  clear_block_flags(sflag, p1);
  if (blockIdx.x == 0)
    for (int p = threadIdx.x; p < P; p += blockDim.x) a.liters[p] = 0;
  for (int64_t v = first; v < a.n; v += stride) {
    const float inbox = inbox_of<MINP, false>(a, v, a.x, a.changed);
    const float xv = __ldg(a.x + v);
    const float x1 = oplus<MINP>(xv, inbox);
    const bool f0 = __ldg(a.frontier + v) || ((x1 != xv) && __ldg(a.vmask + v));
    a.x_out[v] = x1;
    a.fr_out[v] = f0;
    if (f0) mark(sflag, a, v);
  }
  flush_block_flags(sflag, a.flags, p1);  // slot 0
  grid.sync();

  // phase 3: the masked local fixpoint (megastep.py's while_loop)
  float* xc = a.x_out;
  uint8_t* fc = a.fr_out;
  float* xn = a.x_tmp;
  uint8_t* fn = a.f_tmp;
  int slot = 0;
  for (int it = 0;; it += a.unroll) {
    const int* cur = a.flags + slot * p1;
    if (!__ldcg(cur + P) || it >= kMaxIt) break;  // same value grid-wide
    if (blockIdx.x == 0)
      for (int p = threadIdx.x; p < P; p += blockDim.x)
        a.liters[p] += a.unroll * (__ldcg(cur + p) != 0);
    for (int u = 0; u < a.unroll; ++u) {
      const int next = (slot + 1) % 3;
      if (blockIdx.x == 0) {
        int* stale = a.flags + ((slot + 2) % 3) * p1;
        for (int i = threadIdx.x; i < p1; i += blockDim.x) stale[i] = 0;
      }
      clear_block_flags(sflag, p1);
      for (int64_t v = first; v < a.n; v += stride)
        sweep_row<MINP>(a, v, xc, fc, xn, fn, sflag);
      flush_block_flags(sflag, a.flags + next * p1, p1);
      grid.sync();
      float* xt = xc; xc = xn; xn = xt;
      uint8_t* ft = fc; fc = fn; fn = ft;
      slot = next;
    }
  }

  // phase 4: outputs (each row reads and writes only itself: no barrier)
  for (int64_t v = first; v < a.n; v += stride) {
    const float x2 = __ldcg(xc + v);
    const uint8_t fl = __ldcg(fc + v);
    a.x_out[v] = x2;
    a.ch_out[v] = (x2 != __ldg(a.x + v)) && __ldg(a.vmask + v);
    a.fr_out[v] = fl;
  }
}

// ---------------------------------------------------------------------------
// K4: the resident narrow-phase loop. Up to max_steps relaxation rounds in
// ONE launch; each round delivers the previous round's news, ⊕-combines it,
// and runs ONE masked Jacobi sweep (chaotic relaxation: local consequences
// settle across rounds instead of per-superstep fixpoints). The loop ends
// when a round changes no vertex or at max_steps.
//
// Replaces: the JAX package's Pallas kernel `resident_megastep_pallas`
// (src/repro/kernels/megastep.py, body `_resident_kernel`). Outputs match
// it, and the plain `resident_megastep_ref`, bit for bit:
//   x2 (n) f32, changed2 (n) bool, frontier2 (n) bool, iters (1) i32,
//   liters (P) i32 (Σ over rounds of "partition had a frontier").
//
// What bounds it on an H100: memory, per round. A round reads the feed maps
// (n·m_lo·(4+1+4) B) and the adjacency (n·D·4, plus n·D·4 of wgt for
// min_plus), and reads and writes the state a few times; the rounds run one
// hop each, so a road network takes thousands. On the TPU the whole loop
// sat in VMEM behind a 4 MiB gate; here the state stays in HBM and L2.
//
// What the design does about it: K3's cooperative design. One launch with
// at most the co-resident blocks, rows grid-stride, grid.sync() after the
// delivery and after the sweep, so the rounds never return to the host.
//
// Buffers. The outputs hold the state across rounds: phase 0 copies the
// input state into them. Delivery reads x and changed at OTHER rows and
// writes x1 and the full frontier f into scratch (x_tmp, f_tmp); the sweep
// reads x1 and f at other rows and writes x2, changed2 and frontier2 over
// the state IN PLACE, one row per thread: after the delivery's barrier no
// thread reads the state at another row until the next round's delivery,
// which starts after the sweep's barrier. So two x buffers do what the
// TPU kernel's three loop values (xc, x1, x2) do.
//
// Flags. A ring of three (P+1)-int slots: round r writes slot r%3 —
// per-partition "any f" during the delivery (read by block 0 for liters
// after the barrier), "any changed" during the sweep (read by every block
// at the top of round r+1) — and block 0 clears slot (r+1)%3, whose last
// readers finished before round r-1's first barrier. One more int holds
// "any changed" of the input state, the condition of round 0.
template <bool MINP>
__global__ void __launch_bounds__(kThreads) resident_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int sflag[];
  const int P = a.num_parts;
  const int p1 = P + 1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int* init = a.flags + 3 * p1;

  // phase 0: the input state into the outputs; "any changed" of it
  clear_block_flags(sflag, p1);
  if (blockIdx.x == 0)
    for (int p = threadIdx.x; p < P; p += blockDim.x) a.liters[p] = 0;
  for (int64_t v = first; v < a.n; v += stride) {
    const uint8_t ch = __ldg(a.changed + v);
    a.x_out[v] = __ldg(a.x + v);
    a.ch_out[v] = ch;
    a.fr_out[v] = __ldg(a.frontier + v);
    if (ch) sflag[P] = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0 && sflag[P]) *init = 1;
  grid.sync();

  int it = 0;
  for (;; ++it) {
    const int go = it == 0 ? __ldcg(init)
                           : __ldcg(a.flags + ((it + 2) % 3) * p1 + P);
    if (!go || it >= a.max_steps) break;  // same value grid-wide
    int* cur = a.flags + (it % 3) * p1;
    if (blockIdx.x == 0) {
      int* nxt = a.flags + ((it + 1) % 3) * p1;
      for (int i = threadIdx.x; i < p1; i += blockDim.x) nxt[i] = 0;
    }

    // delivery from the state's send set, inbox ⊕-combine, the frontier
    clear_block_flags(sflag, p1);
    for (int64_t v = first; v < a.n; v += stride) {
      const float inbox = inbox_of<MINP, true>(a, v, a.x_out, a.ch_out);
      const float xv = __ldcg(a.x_out + v);
      const float x1 = oplus<MINP>(xv, inbox);
      const bool f = __ldcg(a.fr_out + v) ||
                     ((x1 != xv) && __ldg(a.vmask + v));
      a.x_tmp[v] = x1;
      a.f_tmp[v] = f;
      if (f) sflag[v / a.v_max] = 1;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P; i += blockDim.x)
      if (sflag[i]) cur[i] = 1;  // every writer stores 1: a benign race
    grid.sync();

    // one masked sweep over x1; changed2 = x2 != xc, frontier2 = x2 != x1
    if (blockIdx.x == 0)
      for (int p = threadIdx.x; p < P; p += blockDim.x)
        a.liters[p] += (__ldcg(cur + p) != 0);
    clear_block_flags(sflag, p1);
    for (int64_t v = first; v < a.n; v += stride) {
      float x1;
      const float x2 = sweep_value<MINP>(a, v, a.x_tmp, a.f_tmp, x1);
      const float xc = __ldcg(a.x_out + v);
      const bool vm = __ldg(a.vmask + v);
      const bool ch2 = (x2 != xc) && vm;
      a.x_out[v] = x2;
      a.ch_out[v] = ch2;
      a.fr_out[v] = (x2 != x1) && vm;
      if (ch2) sflag[P] = 1;
    }
    __syncthreads();
    if (threadIdx.x == 0 && sflag[P]) cur[P] = 1;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.iters = it;
}

// one cooperative launch of K3 (RESIDENT false) or K4 (RESIDENT true) with
// at most the co-resident blocks
template <bool MINP, bool RESIDENT>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  static int sms[kMaxDevices] = {0};
  static int per_sm[kMaxDevices] = {0};
  static size_t per_sm_smem[kMaxDevices] = {0};
  void* kernel = RESIDENT ? (void*)resident_kernel<MINP>
                          : (void*)megastep_kernel<MINP>;
  const size_t smem = sizeof(int) * (size_t)(a.num_parts + 1);
  cudaError_t err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
  }
  // occupancy depends on smem (P); recompute when it changes
  if (per_sm[device] == 0 || per_sm_smem[device] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[device],
                                                        kernel, kThreads,
                                                        smem);
    if (err != cudaSuccess) return err;
    per_sm_smem[device] = smem;
  }
  if (per_sm[device] < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t want = ((int64_t)a.n + kThreads - 1) / kThreads;
  int64_t blocks = (int64_t)per_sm[device] * sms[device];
  if (want < blocks) blocks = want;
  if (blocks < 1) blocks = 1;
  Args local = a;
  void* params[] = {(void*)&local};
  return cudaLaunchCooperativeKernel(kernel, dim3((unsigned)blocks),
                                     dim3(kThreads), params, smem, stream);
}

// the arguments both kernels share
Args make_args(const void* x, const void* changed, const void* frontier,
               const void* vmask, const void* nbr, const void* wgt,
               const void* lo_src, const void* lo_ok, const void* lo_w,
               const void* hub_src, const void* hub_ok, const void* hub_w,
               const void* hub_row, const void* hub_row_ok, void* x_out,
               void* ch_out, void* fr_out, void* liters, void* x_tmp,
               void* f_tmp, void* flags, int n, int d, int m_lo, int m_hi,
               int num_parts, int v_max) {
  Args a;
  a.x = (const float*)x;
  a.changed = (const uint8_t*)changed;
  a.frontier = (const uint8_t*)frontier;
  a.vmask = (const uint8_t*)vmask;
  a.nbr = (const int*)nbr;
  a.wgt = (const float*)wgt;
  a.lo_src = (const int*)lo_src;
  a.lo_ok = (const uint8_t*)lo_ok;
  a.lo_w = (const float*)lo_w;
  a.hub_src = (const int*)hub_src;
  a.hub_ok = (const uint8_t*)hub_ok;
  a.hub_w = (const float*)hub_w;
  a.hub_row = (const int*)hub_row;
  a.hub_row_ok = (const uint8_t*)hub_row_ok;
  a.x_out = (float*)x_out;
  a.ch_out = (uint8_t*)ch_out;
  a.fr_out = (uint8_t*)fr_out;
  a.liters = (int*)liters;
  a.x_tmp = (float*)x_tmp;
  a.f_tmp = (uint8_t*)f_tmp;
  a.flags = (int*)flags;
  a.iters = nullptr;
  a.n = n;
  a.d = d;
  a.m_lo = m_lo;
  a.m_hi = m_hi;
  a.num_parts = num_parts;
  a.v_max = v_max;
  a.unroll = 1;
  a.max_steps = 0;
  return a;
}

}  // namespace

extern "C" int megastep_semiring_launch(
    const void* x, const void* changed, const void* frontier,
    const void* vmask, const void* nbr, const void* wgt,
    const void* lo_src, const void* lo_ok, const void* lo_w,
    const void* hub_src, const void* hub_ok, const void* hub_w,
    const void* hub_row, const void* hub_row_ok, void* x_out, void* ch_out,
    void* fr_out, void* liters, void* x_tmp, void* f_tmp, void* flags, int n,
    int d, int m_lo, int m_hi, int num_parts, int v_max, int unroll,
    int min_plus, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(x, changed, frontier, vmask, nbr, wgt, lo_src, lo_ok,
                     lo_w, hub_src, hub_ok, hub_w, hub_row, hub_row_ok, x_out,
                     ch_out, fr_out, liters, x_tmp, f_tmp, flags, n, d, m_lo,
                     m_hi, num_parts, v_max);
  a.unroll = unroll;
  cudaStream_t s = (cudaStream_t)stream;
  err = min_plus ? launch<true, false>(a, device, s)
                 : launch<false, false>(a, device, s);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

extern "C" int resident_megastep_launch(
    const void* x, const void* changed, const void* frontier,
    const void* vmask, const void* nbr, const void* wgt,
    const void* lo_src, const void* lo_ok, const void* lo_w,
    const void* hub_src, const void* hub_ok, const void* hub_w,
    const void* hub_row, const void* hub_row_ok, void* x_out, void* ch_out,
    void* fr_out, void* iters, void* liters, void* x_tmp, void* f_tmp,
    void* flags, int n, int d, int m_lo, int m_hi, int num_parts, int v_max,
    int max_steps, int min_plus, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(x, changed, frontier, vmask, nbr, wgt, lo_src, lo_ok,
                     lo_w, hub_src, hub_ok, hub_w, hub_row, hub_row_ok, x_out,
                     ch_out, fr_out, liters, x_tmp, f_tmp, flags, n, d, m_lo,
                     m_hi, num_parts, v_max);
  a.iters = (int*)iters;
  a.max_steps = max_steps;
  cudaStream_t s = (cudaStream_t)stream;
  err = min_plus ? launch<true, true>(a, device, s)
                 : launch<false, true>(a, device, s);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
