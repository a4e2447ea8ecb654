// K3: one fused superstep of a scalar idempotent-semiring program over flat
// (n = P·v_max) state: gated mailbox delivery, inbox ⊕-combine, the masked
// local fixpoint, the new send set and per-partition sweep counts.
// K4 (below K3): the resident narrow-phase loop, many relaxation rounds of
// one delivery and ONE masked sweep each, in one cooperative launch with
// two grid-wide barriers a round; its delivery walks the feed rows only
// and its sweeps, like K3's, walk every row or a work list by the
// frontier's size (its own notes are with it).
//
// Replaces: the JAX package's Pallas kernel `megastep_semiring_pallas`
// (src/repro/kernels/megastep.py, body `_megastep_kernel`). Outputs match
// it, and the plain `megastep_semiring_ref`, bit for bit:
//   x2 (n) f32, changed2 (n) bool, frontier_left (n) bool, liters (P) i32.
//
// What bounds it on an H100: memory, per sweep of the fixpoint, and only
// over the rows a sweep must recompute: those with an in-neighbour in the
// frontier. Such a row reads its lanes' indices (plus as many weights for
// min_plus) and its own x, and writes x and its frontier stamp; the
// gathered x stays in the 50 MB L2. The data decides the sweep count
// (road networks take hundreds) and how fast the frontier shrinks: at
// the main path's CC superstep 0 the rows with an active
// in-neighbour are a third of n on average over 972 sweeps, and the
// frontier falls under 1 % of a partition long before its last sweep.
//
// What the design does about it. The sub-graph-centric model has an
// independence the TPU kernel (grid=(1,), the whole problem in VMEM) did
// not need: local edges never leave a partition, and delivery reads only
// the INPUT x and changed, which no block writes. So no phase needs a
// barrier wider than one partition:
//  * One thread-block CLUSTER per partition (blocks of 1024 threads, one a
//    SM; the cluster size is chosen at launch from
//    cudaOccupancyMaxActiveClusters so that the P partitions take the
//    fewest rounds). Clusters are persistent: cluster c takes partitions
//    c, c + C, ...; each runs delivery, its own fixpoint loop to its own
//    quiescence, and the outputs. The blocks of a cluster sync with the
//    hardware cluster barrier; there is no grid-wide barrier and no
//    cooperative launch, and a partition that settles early frees its
//    SMs instead of sweeping no-ops until the last one settles.
//  * Work lists. A sweep recomputes only the rows with an active
//    in-neighbour: the out-neighbours of the frontier, walked through the
//    transpose of the adjacency (out_off/out_src, CSR, built once per
//    mailbox by the wrapper). A per-row stamp claims each row once a
//    sweep. While a partition's frontier holds at least `dense_rows` rows
//    (a constant of the wrapper), the sweep walks all its rows instead,
//    two rows a thread at once, testing the stamps of each row's lanes;
//    the two walks give the same iterates.
//  * A work-list entry takes a group of 8 threads (one round of the list)
//    or 4 (a longer list): its row and its out-neighbours split among them.
//  * The counters (the frontier's size per sweep, a list's fill) live in
//    the shared memory of the cluster's first block and are reached by
//    distributed-shared-memory atomics, one per block (dense walk) or one
//    per converged group of threads (work list).
//  * The ELL pads its width to a multiple of 8; a road network's rows use
//    4 lanes. The wrapper hands K3 the adjacency cut to the lanes some row
//    uses (rounded to 4), which halves the index bytes of a dense walk at
//    the main path's size. A row's indices come in 16-byte loads and its
//    gathers are issued independently, without a dependent early exit.
//    Index arithmetic is 32-bit (the wrapper checks n·D < 2^31).
//
// Places where bit identity with the JAX kernel is easily lost:
//  * Sweeps are Jacobi: no row reads a value written in the same sweep.
//    Each sweep reads one x buffer and writes into the other (x_out and
//    x_alt swap after one cluster barrier): a dense walk every row; a
//    work-list sweep the rows whose value may differ between the buffers,
//    its candidates and the last sweep's frontier rows (the other buffer
//    holds x from before them), each claimed once. Updating in place
//    (Gauss-Seidel) reaches the same fixpoint but changes liters,
//    changed_hist and the superstep count.
//  * The frontier is a stamp per row in two arrays by the sweep's parity:
//    a row is in sweep k's frontier iff fgen[k & 1][v] == k. Sweep k
//    writes k + 1 into the other array for the rows that change, which no
//    reader of sweep k looks at, and an old stamp never equals a later
//    sweep, so nothing is cleared.
//  * The frontier sizes sit in a ring of three counters: sweep k reads
//    slot k % 3, adds to slot (k + 1) % 3 and clears slot (k + 2) % 3,
//    whose last reader finished before the previous barrier.
//  * `act` follows ref.py's semiring_spmv_frontier_ref: a row with no
//    active in-neighbour keeps its value. Both walks test it (a work-list
//    candidate has one by construction; a row of the last frontier may
//    not). Rows outside vmask have no local edge (the wrapper
//    refuses a mailbox where one does), so a row that changes is always in
//    the next frontier and the sweeps never read vmask.
//  * liters keeps `unroll`'s grouping: a partition's loop trip starts only
//    while its frontier is non-empty and adds `unroll`. A partition that
//    has settled stays settled under the global loop of the reference, so
//    its own loop gives the same x2, changed2, frontier_left and liters.
//  * The identities are ±inf and `x2 != xc` is a float compare; min/max are
//    plain compares (no NaN reaches them), and the only arithmetic on an
//    identity is inf + w in min_plus, which stays inf. `__fadd_rn` keeps
//    nvcc from contracting anything.
//  * Buffers other blocks write during the launch (x, x_alt, fgen, stamp,
//    the lists) are read with `__ldcg` (L2, not the non-coherent L1) or
//    atomics; read-only inputs use `__ldg`. The cluster barrier is a
//    release/acquire at cluster scope.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // K4's blocks
constexpr int kClusterThreads = 1024;  // K3's blocks: one a SM
constexpr int kMaxIt = 1 << 30;
constexpr int kMaxDevices = 64;
constexpr int kNumSizes = 5;           // K3's cluster sizes: 1, 2, 4, 8, 16

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
  const int* out_off;  // K3: the adjacency's transpose, CSR over rows
  const int* out_src;
  float* x_out;
  uint8_t* ch_out;
  uint8_t* fr_out;
  int* liters;
  int* iters;      // K4: rounds run
  const int* feed;  // K4: the feed rows
  int2* ys;         // K4: 2·n (x, frontier stamp) words, by round parity
  int2* snd;        // K4: 2·n (x, send stamp) words, by round parity
  int* claim;       // K4: the round that last claimed a row (list walks)
  int* ctr;         // K4: a ring of 3 counter slots of (P + 2)
  int* fgen;       // K3: 2·n frontier stamps, by the parity of the sweep
  int* stamp;      // K3: the sweep that last claimed a row (work list)
  float* x_alt;    // K3: the other x buffer of dense walks
  int* lists;      // two work lists of rows (K3: v_max a partition; K4:
                   // list_cap)
  unsigned long long* phase_ns;  // K4: optional phase timer (see K4)
  int n, d, m_lo, m_hi, num_parts, v_max, unroll, max_steps, dense_rows;
  int nf, list_cap;  // K4: feed rows, the lists' capacity
};

template <bool MINP>
__device__ __forceinline__ float ident() {
  return MINP ? INFINITY : -INFINITY;
}

template <bool MINP>
__device__ __forceinline__ float oplus(float a, float b) {
  return MINP ? (b < a ? b : a) : (b > a ? b : a);
}

// ⊕ over one feed row of K3: lanes whose feed is valid AND whose source
// vertex is in the input send set (``chs``); min_plus adds the edge weight
template <bool MINP>
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
    if (!__ldg(chs + s)) continue;
    float g = __ldg(xs + s);
    if (MINP) g = __fadd_rn(g, __ldg(w + i));
    acc = oplus<MINP>(acc, g);
  }
  return acc;
}

// the inbox of row v: its lo feed lanes and, where it has one, its hub row
// (each vertex has at most one hub feed row: a gather, no scatter)
template <bool MINP>
__device__ __forceinline__ float inbox_of(const Args& a, int64_t v,
                                          const float* xs,
                                          const uint8_t* chs) {
  float inbox = reduce_feeds<MINP>(xs, chs, a.lo_src, a.lo_ok, a.lo_w,
                                       v * a.m_lo, a.m_lo);
  if (__ldg(a.hub_row_ok + v)) {
    const int64_t r = __ldg(a.hub_row + v);
    inbox = oplus<MINP>(inbox, reduce_feeds<MINP>(
        xs, chs, a.hub_src, a.hub_ok, a.hub_w, r * a.m_hi, a.m_hi));
  }
  return inbox;
}

// ---------------------------------------------------------------------------
// K3's pieces

__device__ __forceinline__ int load_counter(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// a work-list slot from the counter in the leader's shared memory: one
// cluster atomic for each group of threads that arrive together
__device__ __forceinline__ int append_one(int* counter) {
  cg::coalesced_group g = cg::coalesced_threads();
  int first = 0;
  if (g.thread_rank() == 0) first = atomicAdd(counter, (int)g.size());
  return g.shfl(first, 0) + (int)g.thread_rank();
}

// add every thread's `mine` to `counter` in the leader's shared memory: a
// warp sum, a block sum in `s_sum`, one cluster atomic a block. Every
// thread of the block calls it; the next call comes after a cluster
// barrier, so thread 0's reset of s_sum is seen.
__device__ __forceinline__ void block_count_add(int mine, int* s_sum,
                                                int* counter) {
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(s_sum, mine);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (*s_sum) atomicAdd(counter, *s_sum);
    *s_sum = 0;
  }
}

// one lane of a row update: a valid lane gathers x (⊗ w) and tests its
// source's frontier stamp
template <bool MINP>
__device__ __forceinline__ void lane(int s, float w, const float* xc,
                                     const int* gc, int k, float& y,
                                     bool& act) {
  if (s >= 0) {
    float g = __ldcg(xc + s);
    if (MINP) g = __fadd_rn(g, w);
    y = oplus<MINP>(y, g);
    act |= __ldcg(gc + s) == k;
  }
}

// the lanes of R rows at once (R independent chains of loads in flight):
// y[i] = ⊕ over row v[i]'s valid lanes; act[i] |= a lane's source is in
// sweep k's frontier (gc == k)
template <bool MINP, int R>
__device__ __forceinline__ void row_lanes(const Args& a, const int* v,
                                          const float* xc, const int* gc,
                                          int k, float* y, bool* act) {
  const int d = a.d;
  if ((d & 3) == 0) {  // 16-byte rows of indices (and weights)
#pragma unroll 2
    for (int c = 0; c < (d >> 2); ++c) {
      int4 s[R];
      float4 w[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i] = __ldg(reinterpret_cast<const int4*>(a.nbr + v[i] * d) + c);
        w[i] = MINP ? __ldg(reinterpret_cast<const float4*>(a.wgt + v[i] * d)
                            + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        lane<MINP>(s[i].x, w[i].x, xc, gc, k, y[i], act[i]);
        lane<MINP>(s[i].y, w[i].y, xc, gc, k, y[i], act[i]);
        lane<MINP>(s[i].z, w[i].z, xc, gc, k, y[i], act[i]);
        lane<MINP>(s[i].w, w[i].w, xc, gc, k, y[i], act[i]);
      }
    }
  } else {
    for (int j = 0; j < d; ++j)
#pragma unroll
      for (int i = 0; i < R; ++i)
        lane<MINP>(__ldg(a.nbr + v[i] * d + j),
                   MINP ? __ldg(a.wgt + v[i] * d + j) : 0.f, xc, gc, k, y[i],
                   act[i]);
  }
}

// R rows of sweep k: each row's new value (its old one where it has no
// active in-neighbour) into the other x buffer `xo`, and stamp k + 1 in
// the next frontier's stamps `gn` where it changes. Rows past the
// partition (v < 0) are skipped. Returns how many changed. A dense walk
// takes two rows at a time, a work list one claimed row.
template <bool MINP, int R>
__device__ __forceinline__ int dense_rows(const Args& a, const int* v,
                                          const float* xc, float* xo,
                                          const int* gc, int* gn, int k) {
  int u[R];
  float xu[R], y[R];
  bool act[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    u[i] = v[i] < 0 ? v[0] : v[i];  // a skipped row repeats the first
    xu[i] = __ldcg(xc + u[i]);
    y[i] = ident<MINP>();
    act[i] = false;
  }
  row_lanes<MINP, R>(a, u, xc, gc, k, y, act);
  int changed = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (v[i] < 0) continue;
    const float x2 = act[i] ? oplus<MINP>(xu[i], y[i]) : xu[i];
    __stcg(xo + v[i], x2);
    if (x2 != xu[i]) {
      __stcg(gn + v[i], k + 1);
      ++changed;
    }
  }
  return changed;
}

template <bool MINP>
__global__ void __launch_bounds__(kClusterThreads, 1) megastep_kernel(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int s_cnt[3];  // leader's: sweep k's frontier size in k % 3
  __shared__ int s_fill;    // leader's: fill of a list built from stamps
  __shared__ int s_sum;     // this block's partial count
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int gtid = rank * kClusterThreads + (int)threadIdx.x;
  const int gstride = csize * kClusterThreads;
  const int vmax = a.v_max;
  const bool lead = rank == 0 && threadIdx.x == 0;
  int* lcnt = cluster.map_shared_rank(s_cnt, 0);
  int* lfill = cluster.map_shared_rank(&s_fill, 0);
  if (threadIdx.x == 0) s_sum = 0;

  for (int p = (int)blockIdx.x / csize; p < a.num_parts;
       p += (int)gridDim.x / csize) {
    const int base = p * vmax;
    int* const list0 = a.lists + base;  // the two work lists
    int* const list1 = a.lists + a.n + base;
    if (lead) {
      s_cnt[0] = 0;
      s_cnt[1] = 0;
      s_cnt[2] = 0;
      s_fill = 0;
    }
    cluster.sync();

    // delivery, inbox combine, the fixpoint's starting frontier (sweep 0)
    int mine = 0;
    for (int r = gtid; r < vmax; r += gstride) {
      const int v = base + r;
      const float inbox = inbox_of<MINP>(a, v, a.x, a.changed);
      const float xv = __ldg(a.x + v);
      const float x1 = oplus<MINP>(xv, inbox);
      const bool f0 =
          __ldg(a.frontier + v) || ((x1 != xv) && __ldg(a.vmask + v));
      a.x_out[v] = x1;  // both buffers: a work-list sweep writes only the
      a.x_alt[v] = x1;  // rows it touches into the other one
      a.fgen[v] = f0 ? 0 : -1;
      a.fgen[a.n + v] = -1;
      a.stamp[v] = -1;
      mine += f0;
    }
    block_count_add(mine, &s_sum, lcnt);
    cluster.sync();
    int c = load_counter(lcnt);  // the current frontier's size
    if (c > 0 && c < a.dense_rows) {  // sweep 0 walks a work list
      for (int r = gtid; r < vmax; r += gstride)
        if (__ldcg(a.fgen + base + r) == 0)
          list0[append_one(lfill)] = base + r;
      cluster.sync();
    }

    // the partition's own masked fixpoint (megastep.py's while_loop). Each
    // sweep reads x from xc and writes into xo every row whose value may
    // differ between the two, then the buffers swap after one barrier
    float* xc = a.x_out;
    float* xo = a.x_alt;
    int k = 0, li = 0;
    for (int it = 0; it < kMaxIt && c > 0; it += a.unroll) {
      li += a.unroll;
      for (int u = 0; u < a.unroll; ++u, ++k) {
        if (c == 0) continue;  // settled inside the trip: no-op sweeps
        const int* gc = a.fgen + (k & 1) * a.n;  // sweep k's stamps
        int* gn = a.fgen + ((k + 1) & 1) * a.n;  // the next frontier's
        int* nxt = (k & 1) ? list0 : list1;
        int* ncnt = lcnt + (k + 1) % 3;
        const bool dense = c >= a.dense_rows;
        if (lead) {
          s_cnt[(k + 2) % 3] = 0;  // its last reader synced since
          s_fill = 0;
        }
        if (dense) {  // every row, two a thread
          mine = 0;
          for (int r = gtid; r < vmax; r += 2 * gstride) {
            const int v[2] = {base + r,
                              r + gstride < vmax ? base + r + gstride : -1};
            mine += dense_rows<MINP, 2>(a, v, xc, xo, gc, gn, k);
          }
          block_count_add(mine, &s_sum, ncnt);
        } else {
          // the work list: each frontier row and each of its out-neighbours
          // (the rows with an active in-neighbour) is claimed once and
          // written into xo; a frontier row changed in the last sweep, so
          // xo, which holds x from before it, needs it too. Every other
          // row is the same in both buffers.
          // Groups of 8 threads an entry while the list fits one round
          // (the sweep waits on one chain of loads a thread), else 4.
          const int* cur = (k & 1) ? list1 : list0;
          const int lg = c * 8 <= gstride ? 3 : 2;
          const int sub = gtid & ((1 << lg) - 1);
          for (int e = gtid >> lg; e < c; e += gstride >> lg) {
            const int s = __ldcg(cur + e);
            const int beg = __ldg(a.out_off + s);
            const int end = __ldg(a.out_off + s + 1);
            for (int q = beg - 1 + sub; q < end; q += 1 << lg) {
              const int v = q < beg ? s : __ldg(a.out_src + q);
              if (atomicExch(a.stamp + v, k) == k) continue;  // claimed
              if (dense_rows<MINP, 1>(a, &v, xc, xo, gc, gn, k))
                nxt[append_one(ncnt)] = v;
            }
          }
        }
        cluster.sync();
        float* t = xc;
        xc = xo;
        xo = t;
        c = load_counter(ncnt);
        if (dense && c > 0 && c < a.dense_rows) {  // the next walks a list
          for (int r = gtid; r < vmax; r += gstride)
            if (__ldcg(gn + base + r) == k + 1)
              nxt[append_one(lfill)] = base + r;
          cluster.sync();
        }
      }
    }

    // outputs (each row reads and writes only itself)
    const int* gk = a.fgen + (k & 1) * a.n;
    for (int r = gtid; r < vmax; r += gstride) {
      const int v = base + r;
      const float x2 = __ldcg(xc + v);
      if (xc != a.x_out) a.x_out[v] = x2;
      a.ch_out[v] = (x2 != __ldg(a.x + v)) && __ldg(a.vmask + v);
      a.fr_out[v] = __ldcg(gk + v) == k;
    }
    if (lead) a.liters[p] = li;
    cluster.sync();  // the leader's counters are reset for the next one
  }
}

// ---------------------------------------------------------------------------
// K4: the resident narrow-phase loop. Up to max_steps relaxation rounds in
// one launch; each round delivers the previous round's news, ⊕-combines it,
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
// What bounds it on an H100: memory, per round, and only over the rows a
// round must touch: the rows that receive a message (a feed lane whose
// source changed last round: under 1 % of n on the main path's grid) read
// their feed maps, and the rows with an active in-neighbour (on average
// 53 % of n in CC's rounds, 7 % in SSSP's) read their lanes' indices (plus
// as many weights for min_plus). The rounds run one hop each, so a road
// network takes thousands, and a round's delivery reads state other
// partitions wrote in the round before, so each round needs a barrier
// across the whole grid (1.6 µs over K4's grid on an H100).
//
// What the design does about it: one cooperative launch of the co-resident
// blocks, two grid.sync() a round (after the delivery, after the sweep;
// one more after the set-up), and each phase walks only what it must:
//  * Delivery walks the feed rows (`feed`: the rows with a valid lo lane or
//    a hub row, a static list the wrapper builds once per mailbox). Every
//    other row has x1 = xc and its feed maps are never read.
//  * The sweep has two walks, chosen each round by the frontier's size c
//    after delivery: while c >= `dense_rows` (a constant of the wrapper)
//    it walks every row, two a thread, testing each row's lanes; below it,
//    it walks the frontier's rows and their out-neighbours through the
//    adjacency's transpose (out_off/out_src, K3's), each row claimed once
//    by a round stamp in `claim`. The frontier's rows come from a list the
//    previous sweep and this round's delivery append to; after a dense
//    sweep, which builds no list, the round finds them by a scan of the
//    stamps instead (no extra barrier). Both walks give the same iterates.
//  * Both walks read K3's copy of the adjacency cut to its used lanes, a
//    row's indices (and weights) in 16-byte loads.
//  * One 8-byte load a lane: each row's x and its frontier stamp sit side
//    by side in `ys` (an int2: the x bits and the round whose frontier
//    holds the row), so a lane's value and its frontier test come from one
//    sector.
//
// Buffers. `ys` holds two (x, stamp) arrays by the round's parity: round r
// reads ys[r & 1] (after its delivery, x1 and f_r at every row) and writes
// x2 into ys[(r + 1) & 1]. `snd` holds two (x, stamp) arrays of the send
// set: snd[r & 1][s] has stamp r iff s changed in round r - 1, and then
// its x. Counters: a ring of three slots of (P + 2) ints, slot r % 3
// holding round r's frontier size, "round r runs" (round r - 1 changed a
// row) and per partition "f_r is not empty"; each slot is cleared by block
// 0 two phases before anyone writes it again.
//
// Places where bit identity with the JAX kernel is easily lost:
//  * Jacobi order. The sweep of round r reads ys[r & 1] at other rows and
//    writes only ys[(r + 1) & 1], so it never reads a value written in the
//    same round. Delivery updates ys[r & 1] in place at the feed rows, so
//    it reads the sources' xc and send-set membership from snd[r & 1],
//    which no one writes in that phase, never from ys.
//  * Rows a round does not touch. A stamp is a round number, so an old
//    stamp never equals a later round and nothing is cleared each round.
//    ys[(r + 1) & 1] held x1 of round r - 1; the rows whose value may have
//    moved since are round r's frontier (changed by sweep r - 1 or by
//    delivery r), the rows sweep r changes, and rows outside vmask that
//    delivery r changes (they enter no frontier, so delivery writes them
//    into both arrays). The sweep writes the first two, so after it every
//    row of ys[(r + 1) & 1] holds x2. Rows outside vmask have no local
//    edge (the wrapper refuses a mailbox where one does), so no sweep
//    moves them. At exit the outputs are read from the final arrays at all
//    n rows: frontier2 = (stamp == iters), changed2 = (send stamp ==
//    iters).
//  * frontier2 ⊆ changed2. x2 != x1 implies x2 != xc, since x1 = xc ⊕
//    inbox and x2 = x1 ⊕ y; so the send set of round r is delivery r's
//    changed rows in vmask (written into snd by the delivery, with x1)
//    and sweep r's changed rows (written again, with x2).
//  * iters counts the rounds run: round r runs while r < max_steps and
//    round r - 1 changed a row (round 0: some input row is changed).
//    liters[p] adds 1 in each round whose f (after delivery) holds a row
//    of partition p, read from the flags in the ring, so a partition with
//    no work is counted as the reference counts it.
//  * `act` follows ref.py's semiring_spmv_frontier_ref: a row with no lane
//    in f_r keeps x1; a row with one folds ALL its lanes.
//  * max_steps 0, or no changed input row: no round runs and the outputs
//    are the inputs, iters 0.
//  * Buffers written during the launch are read with `__ldcg` (L2, not the
//    non-coherent L1); read-only inputs with `__ldg`.

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int2 pack(float x, int stamp) {
  return make_int2(__float_as_int(x), stamp);
}

// ⊕ over one feed row of K4: lanes whose feed is valid AND whose source is
// in round r's send set, read with its value from one (x, stamp) word
template <bool MINP>
__device__ __forceinline__ float k4_feeds(const int2* snd, const int* src,
                                          const uint8_t* ok, const float* w,
                                          int64_t base, int m, int r) {
  float acc = ident<MINP>();
  for (int k = 0; k < m; ++k) {
    const int64_t i = base + k;
    if (!__ldg(ok + i)) continue;
    const int2 s = __ldcg(snd + __ldg(src + i));
    if (s.y != r) continue;
    float g = __int_as_float(s.x);
    if (MINP) g = __fadd_rn(g, __ldg(w + i));
    acc = oplus<MINP>(acc, g);
  }
  return acc;
}

// one lane of K4's sweep: x1 of its source (⊗ w) and whether the source is
// in round r's frontier, from one 8-byte load
template <bool MINP>
__device__ __forceinline__ void k4_lane(int s, float w, const int2* yc,
                                        int r, float& y, bool& act) {
  if (s >= 0) {
    const int2 p = __ldcg(yc + s);
    float g = __int_as_float(p.x);
    if (MINP) g = __fadd_rn(g, w);
    y = oplus<MINP>(y, g);
    act |= p.y == r;
  }
}

// the shared-memory flags of a K4 block: [0, P) "partition p", [P] a
// count, [P + 1] "any"
__device__ __forceinline__ void k4_flags_begin(int* sflag, int P) {
  __syncthreads();
  for (int i = threadIdx.x; i < P + 2; i += blockDim.x) sflag[i] = 0;
  __syncthreads();
}

// a phase's flags out to a ring slot: the block's count added to *cnt,
// "any" stored to *any, each partition's flag to pf[p]. Every thread of
// the block calls it, converged.
__device__ __forceinline__ void k4_flags_flush(int* sflag, int P, int mine,
                                               bool any, int* pf, int* cnt,
                                               int* anyp) {
  mine = __reduce_add_sync(0xffffffffu, mine);
  any = __any_sync(0xffffffffu, any);
  if ((threadIdx.x & 31) == 0) {
    if (mine) atomicAdd(sflag + P, mine);
    if (any) sflag[P + 1] = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (sflag[P]) atomicAdd(cnt, sflag[P]);
    if (sflag[P + 1]) *anyp = 1;
  }
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    if (sflag[i]) pf[i] = 1;  // every writer stores 1: a benign race
}

// R rows of round r's sweep (v < 0: no row): x2 from ys[r & 1] into `yn`
// where the row is in f_r or changes; a changed row (in vmask) also goes
// into the send set `sn` and into the next frontier, appended to `ln` in
// list walks (LIST) or counted in `cnt` in dense ones.
template <bool MINP, int R, bool LIST>
__device__ __forceinline__ void k4_rows(const Args& a, const int* v,
                                        const int2* yc, int2* yn, int2* sn,
                                        int r, int* ncnt, int* ln, int& cnt,
                                        bool& any, int* sflag) {
  const int d = a.d;
  int u[R];
  int2 own[R];
  float y[R];
  bool act[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    u[i] = v[i] < 0 ? v[0] : v[i];  // a skipped row repeats the first
    own[i] = __ldcg(yc + u[i]);
    y[i] = ident<MINP>();
    act[i] = false;
  }
  if ((d & 3) == 0) {  // 16-byte rows of indices (and weights)
#pragma unroll 2
    for (int c = 0; c < (d >> 2); ++c) {
      int4 s[R];
      float4 w[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i] = __ldg(reinterpret_cast<const int4*>(a.nbr + u[i] * d) + c);
        w[i] = MINP ? __ldg(reinterpret_cast<const float4*>(a.wgt + u[i] * d)
                            + c)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        k4_lane<MINP>(s[i].x, w[i].x, yc, r, y[i], act[i]);
        k4_lane<MINP>(s[i].y, w[i].y, yc, r, y[i], act[i]);
        k4_lane<MINP>(s[i].z, w[i].z, yc, r, y[i], act[i]);
        k4_lane<MINP>(s[i].w, w[i].w, yc, r, y[i], act[i]);
      }
    }
  } else {
    for (int j = 0; j < d; ++j)
#pragma unroll
      for (int i = 0; i < R; ++i)
        k4_lane<MINP>(__ldg(a.nbr + u[i] * d + j),
                      MINP ? __ldg(a.wgt + u[i] * d + j) : 0.f, yc, r, y[i],
                      act[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (v[i] < 0) continue;
    const float x1 = __int_as_float(own[i].x);
    const float x2 = act[i] ? oplus<MINP>(x1, y[i]) : x1;
    const bool moved = x2 != x1 && __ldg(a.vmask + v[i]);
    if (own[i].y == r || moved) __stcg(yn + v[i], pack(x2, moved ? r + 1 : -1));
    if (!moved) continue;
    __stcg(sn + v[i], pack(x2, r + 1));
    any = true;
    sflag[v[i] / a.v_max] = 1;
    if (LIST) {
      const int pos = append_one(ncnt);
      if (pos < a.list_cap) ln[pos] = v[i];
    } else {
      ++cnt;
    }
  }
}

// a frontier row `s` of a list or scan walk and its out-neighbours, items
// sub, sub + step, ... of [s, out_src[out_off[s]], ...], each row claimed
// once a round
template <bool MINP>
__device__ __forceinline__ void k4_entry(const Args& a, int s, int sub,
                                         int step, const int2* yc, int2* yn,
                                         int2* sn, int r, int* ncnt, int* ln,
                                         int& cnt, bool& any, int* sflag) {
  const int beg = __ldg(a.out_off + s);
  const int end = __ldg(a.out_off + s + 1);
  for (int q = beg - 1 + sub; q < end; q += step) {
    const int v = q < beg ? s : __ldg(a.out_src + q);
    if (atomicExch(a.claim + v, r) == r) continue;  // claimed
    k4_rows<MINP, 1, true>(a, &v, yc, yn, sn, r, ncnt, ln, cnt, any, sflag);
  }
}

template <bool MINP>
__global__ void __launch_bounds__(kThreads, 4) resident_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int sflag[];
  const int P = a.num_parts;
  const int slot = P + 2;  // a ring slot: [0] |f_r|, [1] runs, [2..] per p
  const int n = a.n;
  const int stride = (int)(gridDim.x * blockDim.x);
  const int gtid = (int)(blockIdx.x * blockDim.x + threadIdx.x);
  int2* const ys0 = a.ys;
  int2* const ys1 = a.ys + n;
  int2* const sn0 = a.snd;
  int2* const sn1 = a.snd + n;
  // the phase timer (optional): block 0's thread 0 reads the global timer
  // after each grid-wide barrier, so each phase's time includes the wait
  // at its barrier; [0] the set-up, [1] the deliveries, [2] the sweeps
  const bool timer = a.phase_ns && blockIdx.x == 0 && threadIdx.x == 0;
  unsigned long long t_prev = timer ? now_ns() : 0, t_d = 0, t_s = 0;
  const unsigned long long t_start = t_prev;

  // set-up: the input state into both (x, stamp) arrays and the send set
  // (round 0's frontier and send set stamped 0), claims cleared, round 0's
  // counters
  k4_flags_begin(sflag, P);
  if (blockIdx.x == 0)
    for (int p = threadIdx.x; p < P; p += blockDim.x) a.liters[p] = 0;
  int mine = 0;
  bool any = false;
  for (int v = gtid; v < n; v += stride) {
    const float x = __ldg(a.x + v);
    const bool f = __ldg(a.frontier + v);
    const bool ch = __ldg(a.changed + v);
    ys0[v] = pack(x, f ? 0 : -1);
    ys1[v] = pack(x, -1);
    sn0[v] = pack(x, ch ? 0 : -1);
    sn1[v] = pack(x, -1);
    a.claim[v] = -1;
    if (f) {
      ++mine;
      sflag[v / a.v_max] = 1;
    }
    any |= ch;
  }
  k4_flags_flush(sflag, P, mine, any, a.ctr + 2, a.ctr, a.ctr + 1);
  grid.sync();
  if (timer) {
    t_prev = now_ns();
    a.phase_ns[0] = t_prev - t_start;
  }

  bool listed = false;  // the frontier list of this round is whole
  int r = 0;
  for (;; ++r) {
    int* const cur = a.ctr + (r % 3) * slot;
    int* const nxt = a.ctr + ((r + 1) % 3) * slot;
    if (r >= a.max_steps || !__ldcg(cur + 1)) break;  // same grid-wide
    int2* const yc = (r & 1) ? ys1 : ys0;
    int2* const yn = (r & 1) ? ys0 : ys1;
    const int2* sc = (r & 1) ? sn1 : sn0;
    int2* const sn = (r & 1) ? sn0 : sn1;
    int* const lc = a.lists + (r & 1) * a.list_cap;
    int* const ln = a.lists + ((r + 1) & 1) * a.list_cap;

    // delivery over the feed rows: inbox ⊕-combine from round r's send
    // set; a row it changes enters f_r (and the next send set) unless it
    // lies outside vmask
    k4_flags_begin(sflag, P);
    mine = 0;
    any = false;
    for (int i = gtid; i < a.nf; i += stride) {
      const int v = __ldg(a.feed + i);
      const int2 own = __ldcg(yc + v);
      const float xc = __int_as_float(own.x);
      float inbox = k4_feeds<MINP>(sc, a.lo_src, a.lo_ok, a.lo_w,
                                   (int64_t)v * a.m_lo, a.m_lo, r);
      if (__ldg(a.hub_row_ok + v))
        inbox = oplus<MINP>(inbox, k4_feeds<MINP>(
            sc, a.hub_src, a.hub_ok, a.hub_w,
            (int64_t)__ldg(a.hub_row + v) * a.m_hi, a.m_hi, r));
      const float x1 = oplus<MINP>(xc, inbox);
      if (x1 == xc) continue;
      if (!__ldg(a.vmask + v)) {  // no frontier, no send: both arrays
        yc[v] = pack(x1, own.y);
        yn[v] = pack(x1, -1);
        continue;
      }
      yc[v] = pack(x1, r);
      sn[v] = pack(x1, r + 1);
      any = true;
      if (own.y == r) continue;  // already in f_r (sweep r - 1 moved it)
      sflag[v / a.v_max] = 1;
      if (listed) {
        const int pos = append_one(cur);
        if (pos < a.list_cap) lc[pos] = v;
      } else {
        ++mine;
      }
    }
    k4_flags_flush(sflag, P, mine, any, cur + 2, cur, nxt + 1);
    grid.sync();
    if (timer) {
      const unsigned long long t = now_ns();
      t_d += t - t_prev;
      t_prev = t;
    }

    // one masked sweep of f_r, by the walk its size picks
    const int c = __ldcg(cur);
    if (blockIdx.x == 0) {
      for (int p = threadIdx.x; p < P; p += blockDim.x)
        a.liters[p] += __ldcg(cur + 2 + p) != 0;
      int* const old = a.ctr + ((r + 2) % 3) * slot;  // last read in r - 1
      for (int i = threadIdx.x; i < slot; i += blockDim.x) old[i] = 0;
    }
    k4_flags_begin(sflag, P);
    mine = 0;
    any = false;
    const bool dense = c >= a.dense_rows;
    if (c == 0) {
      // nothing to sweep: x2 = x1, and f_{r+1} is empty
    } else if (dense) {  // every row, two a thread
      for (int v0 = gtid; v0 < n; v0 += 2 * stride) {
        const int v[2] = {v0, v0 + stride < n ? v0 + stride : -1};
        k4_rows<MINP, 2, false>(a, v, yc, yn, sn, r, nxt, ln, mine, any,
                                sflag);
      }
    } else if (listed) {  // the list: a group of 8 (or 4) threads an entry
      const int lg = c * 8 <= stride ? 3 : 2;
      const int sub = gtid & ((1 << lg) - 1);
      for (int e = gtid >> lg; e < c; e += stride >> lg)
        k4_entry<MINP>(a, __ldcg(lc + e), sub, 1 << lg, yc, yn, sn, r, nxt,
                       ln, mine, any, sflag);
    } else {  // after a dense sweep: the entries found by their stamps
      for (int v = gtid; v < n; v += stride)
        if (__ldcg(yc + v).y == r)
          k4_entry<MINP>(a, v, 0, 1, yc, yn, sn, r, nxt, ln, mine, any,
                         sflag);
    }
    listed = !dense;
    k4_flags_flush(sflag, P, mine, any, nxt + 2, nxt, nxt + 1);
    grid.sync();
    if (timer) {
      const unsigned long long t = now_ns();
      t_s += t - t_prev;
      t_prev = t;
    }
  }

  // outputs from the final arrays, every row
  const int2* yr = (r & 1) ? ys1 : ys0;
  const int2* sr = (r & 1) ? sn1 : sn0;
  for (int v = gtid; v < n; v += stride) {
    const int2 p = __ldcg(yr + v);
    a.x_out[v] = __int_as_float(p.x);
    a.fr_out[v] = p.y == r;
    a.ch_out[v] = __ldcg(sr + v).y == r;
  }
  if (gtid == 0) *a.iters = r;
  if (timer) {
    a.phase_ns[1] = t_d;
    a.phase_ns[2] = t_s;
  }
}

// K4's grid: at most the co-resident blocks of 256 threads (occupancy
// depends on shared memory, which grows with P)
template <bool MINP>
cudaError_t resident_blocks(int64_t n, int num_parts, int device,
                            int* blocks) {
  static int sms[kMaxDevices] = {0};
  static int per_sm[kMaxDevices] = {0};
  static size_t per_sm_smem[kMaxDevices] = {0};
  const size_t smem = sizeof(int) * (size_t)(num_parts + 2);
  cudaError_t err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
  }
  if (per_sm[device] == 0 || per_sm_smem[device] != smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[device], (void*)resident_kernel<MINP>, kThreads, smem);
    if (err != cudaSuccess) return err;
    per_sm_smem[device] = smem;
  }
  if (per_sm[device] < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int64_t want = (n + kThreads - 1) / kThreads;
  int64_t b = (int64_t)per_sm[device] * sms[device];
  if (want < b) b = want;
  *blocks = b < 1 ? 1 : (int)b;
  return cudaSuccess;
}

// one cooperative launch of K4 with at most the co-resident blocks: the
// runtime refuses a grid that would not be co-resident, and the wrapper
// raises
template <bool MINP>
cudaError_t launch_resident(const Args& a, int device, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = resident_blocks<MINP>(a.n, a.num_parts, device, &blocks);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(int) * (size_t)(a.num_parts + 2);
  Args local = a;
  void* params[] = {(void*)&local};
  return cudaLaunchCooperativeKernel((void*)resident_kernel<MINP>,
                                     dim3((unsigned)blocks), dim3(kThreads),
                                     params, smem, stream);
}

// K3's cluster shape for P partitions: of the sizes 1, 2, 4, 8 and 16
// blocks, the one whose C = min(P, most co-resident clusters) clusters
// finish the partitions in the least time, taken as rounds ceil(P / C)
// over blocks a cluster (the smaller size on a tie). `active` receives
// cudaOccupancyMaxActiveClusters at each size.
template <bool MINP>
cudaError_t cluster_shape(int num_parts, int device, int* size, int* clusters,
                          int* active) {
  static int cached[kMaxDevices][kNumSizes];
  static bool have[kMaxDevices] = {false};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  void* kernel = (void*)megastep_kernel<MINP>;
  if (!have[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    for (int i = 0; i < kNumSizes; ++i) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1u << i;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(1u << i);
      cfg.blockDim = dim3(kClusterThreads);
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&cached[device][i], kernel, &cfg);
      if (err != cudaSuccess) return err;
    }
    have[device] = true;
  }
  int best = -1, best_rounds = 0;
  for (int i = 0; i < kNumSizes; ++i) {
    active[i] = cached[device][i];
    if (active[i] < 1) continue;
    const int c = active[i] < num_parts ? active[i] : num_parts;
    const int rounds = (num_parts + c - 1) / c;
    // rounds / size < best_rounds / best_size
    if (best < 0 || (int64_t)rounds * (1 << best) <
                        (int64_t)best_rounds * (1 << i)) {
      best = i;
      best_rounds = rounds;
    }
  }
  if (best < 0) return cudaErrorInvalidConfiguration;  // no cluster fits
  *size = 1 << best;
  *clusters = active[best] < num_parts ? active[best] : num_parts;
  return cudaSuccess;
}

// one launch of K3: C clusters of `size` blocks, persistent over the
// partitions
template <bool MINP>
cudaError_t launch_megastep(const Args& a, int device, cudaStream_t stream) {
  int size = 0, clusters = 0, active[kNumSizes];
  cudaError_t err =
      cluster_shape<MINP>(a.num_parts, device, &size, &clusters, active);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)size;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(clusters * size));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, megastep_kernel<MINP>, a);
}

// the arguments both kernels share
Args make_args(const void* x, const void* changed, const void* frontier,
               const void* vmask, const void* nbr, const void* wgt,
               const void* lo_src, const void* lo_ok, const void* lo_w,
               const void* hub_src, const void* hub_ok, const void* hub_w,
               const void* hub_row, const void* hub_row_ok, void* x_out,
               void* ch_out, void* fr_out, void* liters, int n, int d,
               int m_lo, int m_hi, int num_parts, int v_max) {
  Args a = {};
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
  a.n = n;
  a.d = d;
  a.m_lo = m_lo;
  a.m_hi = m_hi;
  a.num_parts = num_parts;
  a.v_max = v_max;
  a.unroll = 1;
  return a;
}

}  // namespace

extern "C" int megastep_semiring_launch(
    const void* x, const void* changed, const void* frontier,
    const void* vmask, const void* nbr, const void* wgt,
    const void* lo_src, const void* lo_ok, const void* lo_w,
    const void* hub_src, const void* hub_ok, const void* hub_w,
    const void* hub_row, const void* hub_row_ok, const void* out_off,
    const void* out_src, void* x_out, void* ch_out, void* fr_out,
    void* liters, void* fgen, void* stamp, void* x_alt, void* lists, int n,
    int d, int m_lo, int m_hi, int num_parts, int v_max, int unroll,
    int dense_rows, int min_plus, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(x, changed, frontier, vmask, nbr, wgt, lo_src, lo_ok,
                     lo_w, hub_src, hub_ok, hub_w, hub_row, hub_row_ok, x_out,
                     ch_out, fr_out, liters, n, d, m_lo, m_hi, num_parts,
                     v_max);
  a.out_off = (const int*)out_off;
  a.out_src = (const int*)out_src;
  a.fgen = (int*)fgen;
  a.stamp = (int*)stamp;
  a.x_alt = (float*)x_alt;
  a.lists = (int*)lists;
  a.unroll = unroll;
  a.dense_rows = dense_rows;
  cudaStream_t s = (cudaStream_t)stream;
  err = min_plus ? launch_megastep<true>(a, device, s)
                 : launch_megastep<false>(a, device, s);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// K3's launch shape for P partitions: out[0] blocks a cluster, out[1]
// clusters, out[2] threads a block, out[3..7] cudaOccupancyMaxActiveClusters
// at 1, 2, 4, 8 and 16 blocks a cluster
extern "C" int megastep_cluster_shape(int num_parts, int min_plus,
                                      int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = min_plus ? cluster_shape<true>(num_parts, device, out, out + 1,
                                       out + 3)
                 : cluster_shape<false>(num_parts, device, out, out + 1,
                                        out + 3);
  out[2] = kClusterThreads;
  return (int)err;
}

extern "C" int resident_megastep_launch(
    const void* x, const void* changed, const void* frontier,
    const void* vmask, const void* nbr, const void* wgt,
    const void* lo_src, const void* lo_ok, const void* lo_w,
    const void* hub_src, const void* hub_ok, const void* hub_w,
    const void* hub_row, const void* hub_row_ok, const void* feed,
    const void* out_off, const void* out_src, void* x_out, void* ch_out,
    void* fr_out, void* iters, void* liters, void* ys, void* snd,
    void* claim, void* lists, void* ctr, void* phase_ns, int n, int d,
    int m_lo, int m_hi, int num_parts, int v_max, int nf, int max_steps,
    int dense_rows, int list_cap, int min_plus, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = make_args(x, changed, frontier, vmask, nbr, wgt, lo_src, lo_ok,
                     lo_w, hub_src, hub_ok, hub_w, hub_row, hub_row_ok, x_out,
                     ch_out, fr_out, liters, n, d, m_lo, m_hi, num_parts,
                     v_max);
  a.feed = (const int*)feed;
  a.out_off = (const int*)out_off;
  a.out_src = (const int*)out_src;
  a.iters = (int*)iters;
  a.ys = (int2*)ys;
  a.snd = (int2*)snd;
  a.claim = (int*)claim;
  a.lists = (int*)lists;
  a.ctr = (int*)ctr;
  a.phase_ns = (unsigned long long*)phase_ns;
  a.nf = nf;
  a.max_steps = max_steps;
  a.dense_rows = dense_rows;
  a.list_cap = list_cap;
  cudaStream_t s = (cudaStream_t)stream;
  err = min_plus ? launch_resident<true>(a, device, s)
                 : launch_resident<false>(a, device, s);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

// K4's cooperative grid for n rows and P partitions: out[0] blocks,
// out[1] threads a block
extern "C" int resident_grid_shape(int n, int num_parts, int min_plus,
                                   int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = min_plus ? resident_blocks<true>(n, num_parts, device, out)
                 : resident_blocks<false>(n, num_parts, device, out);
  out[1] = kThreads;
  return (int)err;
}
