// K7b on Hopper tensor cores: the backward of K7's attention — dq, dk and
// dv of causal or sliding-window attention with grouped query heads
// (GQA), queries at absolute positions q_offset + i — for bfloat16 inputs
// at head widths 64, 80, 128 and 256. `flash_attention_bwd_cuda` launches
// it for bf16 at those widths given K7's log-sum-exp; float32 inputs, and
// bf16 at dh 16 and 32, stay on the SIMT kernel in flash_attention_bwd.cu.
//
// Replaces: no TPU kernel. The JAX package differentiates its jnp flash
// loop (src/repro/models/layers.py `flash_attention`) or, on a TPU,
// through `flash_attention_pallas`; the port's training path needs K7's
// gradient as a kernel (kernels/ops.py `_FlashAttention`).
//
// Contract (kernels/flash_attention.py `flash_attention_bwd_ref` with
// `lse`): q, do and o (B, Sq, H, dh), k and v (B, Sk, KV, dh), H = g·KV,
// lse (B, H, Sq) float32 in the natural-log scale of the scaled scores
// (+inf on a row with no visible key, as K7 writes it). With
// s = (q/sqrt(dh))·k, P = exp(s − lse) over the visible keys, D =
// rowsum(do∘o) and dS = P∘(do·vᵀ − D):
//   dq = dS·k / sqrt(dh),  dk = Σ_g dSᵀ·q / sqrt(dh),  dv = Σ_g Pᵀ·do.
//
// Numerics. Every product takes bf16 operands and accumulates in float32
// on the tensor cores: the scores and do·vᵀ of the bf16 inputs, then Pᵀ·do
// and dSᵀ·q with P and dS rounded to bf16 (the A fragments), and dS·k with
// dS rounded to bf16 in shared memory. P = exp2(s·c − lse·log2 e), c =
// log2(e)/sqrt(dh). dk and dv are rounded to bf16 once; dq is summed in a
// float32 accumulator and rounded once by the post kernel.
//
// What bounds it on an H100: operations. At h2o-danube-1.8b's training
// layer (B 4, S 2048, H 32, KV 8, dh 80, causal) the visible pairs need 5
// products of 2·dh FLOP each (Sᵀ, dPᵀ, dV, dK, dQ), 2.1e11 FLOP on the
// bf16 tensor cores (989 TFLOP/s) against 0.21 GB of inputs and outputs.
//
// Three launches:
// * pre: D = rowsum(do∘o) and lse·log2(e) per (b, h, row) into float32
//   scratch padded to whole 64-row tiles (padding rows: D 0, lse +inf, so
//   their P is 0 with no mask), and the float32 dq accumulator zeroed
//   (tiles of 64 rows x dh, (b, h, tile) in order).
// * main (flash_bwd_kernel_sm90), for the card:
//   - Work item: (b, KV head, key tile). The block loads K and V of its
//     key tile once, then walks the g query heads of that KV head and, for
//     each, the query tiles of 64 rows that see the key tile (from the
//     diagonal on when causal, inside the window); tiles the mask hides
//     whole are never visited. dk and dv sum the g heads in registers:
//     deterministic, no atomics.
//   - Persistent, 384 threads: warpgroup 0 is the producer (thread 0
//     issues the TMA loads: K and V once an item, then Q, dO and the
//     tile's lse and D into a ring of 1-3 stages with full and empty
//     mbarriers; thread 32 is the dq writer; setmaxnreg 24), warpgroups 1
//     and 2 are consumers (setmaxnreg 240). No width spills a register:
//     ptxas does not know that an inline-asm wgmma writes its accumulator
//     after the issue, so a spill of one in flight would corrupt it.
//   - Item order: the (b, KV head) pairs go in chunks, each chunk with all
//     its key tiles in one round of the grid (a grid of whole chunks, SMs
//     left over idle), longest tile first, every other round walked
//     backwards, so a block's two items of a pair of rounds even out the
//     causal work, and the dq rows the blocks in flight add into stay few.
//   - dh <= 128: 128 keys an item, each consumer owns 64 of them (the
//     wgmma M) and their dk and dv, all dh columns. dh 256: 64 keys an
//     item (registers: dk and dv of 64 keys x 256 are 256 floats a
//     thread), both consumers compute the same Sᵀ and dPᵀ and each owns
//     128 columns of dk, dv and dq.
//   - Products of one (query tile, key tile) pair, a consumer:
//       Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ   (m64n64, both K-major in smem)
//       Pᵀ = exp2(Sᵀ·c − lse2), dSᵀ = Pᵀ∘(dPᵀ − D), in registers, where
//       each accumulator fragment, rounded to bf16, is wgmma's A fragment
//       dV += Pᵀ·dO, dK += dSᵀ·Q     (A from registers, B MN-major)
//       dQ = dS·K over its own keys  (its dSᵀ through shared memory: A
//                                     and B both MN-major)
//     5 products a visible pair. dh 80 runs N = 80 where dh is N (a
//     128-byte swizzle atom and a fifth of the next), and 5 k16 steps
//     where it is the reduction; dh > 80 runs dQ in 64-column passes.
//   - dq: the first consumer stores its partial dQ tile into a staging
//     buffer, the second adds its own to it (at dh 256 each stores its
//     columns), and the writer reduces the tile into the float32
//     accumulator with one TMA bulk reduction (cp.reduce.async.bulk
//     .add.f32); the reductions of the blocks that share a tile meet in L2.
//   - dk·scale and dv are rounded to bf16 and stored from the fragments.
// * post: dq = accumulator / sqrt(dh), rounded to bf16.
//
// Shared memory (main): K and V tiles, the Q/dO/lse/D ring, each
// consumer's dSᵀ tile (bf16, the 128-byte swizzle wgmma reads), the dq
// staging buffers and the mbarriers: 131 KB at dh 64, 219 KB at dh 80,
// 178 KB at dh 128, 210 KB at dh 256.
#include <cuda.h>          // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kBM = 64;         // query rows a tile
constexpr int kThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kRowBytes = 128;  // one swizzled row of a 64-column chunk
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Cfg {
  static constexpr int kChunks = (DH + 63) / 64;    // 64-column boxes a row
  static constexpr bool kSplitCols = DH > 128;      // consumers split columns
  static constexpr int kBN = kSplitCols ? 64 : 128;  // keys an item
  // dk, dv and dq columns a consumer: all, or its half at dh 256
  static constexpr int kN = kSplitCols ? DH / 2 : DH;
  static constexpr int kParts = kSplitCols ? 2 : 1;  // dq tile column parts
  // the Q/dO ring: three stages at dh <= 80; one wider (dh 256: shared
  // memory; dh 128: a second stage's index arithmetic made ptxas spill)
  static constexpr int kStages = DH > 80 ? 1 : 3;
  static constexpr int kQKSteps = DH / 16;          // k16 steps of Sᵀ, dPᵀ
  static constexpr int kTileBytes = kChunks * kBN * kRowBytes;  // K or V
  static constexpr int kQBytes = kChunks * kBM * kRowBytes;     // Q or dO
  static constexpr int kDSBytes = kBM * kRowBytes;  // a consumer's dSᵀ
  static constexpr int kVecBytes = kBM * 4;         // lse or D
  static constexpr int kDQBytes = kBM * DH * 4;     // a staged dq tile
  // dq staging buffers: two where they fit beside the ring (dh <= 128)
  static constexpr int kDQBufs = kSplitCols ? 1 : 2;
  static constexpr int kOffV = kTileBytes;
  static constexpr int kOffQ = 2 * kTileBytes;
  static constexpr int kOffDO = kOffQ + kStages * kQBytes;
  static constexpr int kOffDS = kOffDO + kStages * kQBytes;
  static constexpr int kOffDQ = kOffDS + 2 * kDSBytes;
  static constexpr int kOffLse = kOffDQ + kDQBufs * kDQBytes;
  static constexpr int kOffD = kOffLse + kStages * kVecBytes;
  static constexpr int kOffBar = kOffD + kStages * kVecBytes;
  // full_kv, empty_kv, full_q and empty_q a stage, half_dq, full_dq and
  // empty_dq a staging buffer; room to align the base to the swizzle's
  // 1024 bytes
  static constexpr int kSmem =
      kOffBar + 8 * (2 + 2 * kStages + 3 * kDQBufs) + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

// ---- PTX wrappers: shared memory, mbarriers, TMA, wgmma ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait of 10 s is a fault (a load that never lands), not a wait: it traps,
// so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint64_t start = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      else if (now - start > 10000000000ull) __trap();
    }
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The staging swizzle of a dq row of kG 8-float groups: group j of row r
// lies at group j ^ (r % 8) within its block of 8 groups (dh 80's last 2
// groups, a block of their own, stay), so the 8 rows a warp writes at once
// fall on different banks.
template <int kG>
__device__ __forceinline__ int dq_group(int j, int r) {
  return j < kG / 8 * 8 ? j ^ (r & 7) : j;
}

// dst[0 .. bytes) += src[0 .. bytes), float32, from shared memory into
// global memory by the TMA unit (the reduction runs in L2); one bulk group
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32"
      " [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
}

// A wgmma shared-memory descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets (all in 16-byte units), layout type 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous issue and the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 64, f32) = scale_d·D + A·B, A and B in shared memory; TA, TB:
// the transpose bits (1: MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 80, f32) = scale_d·D + A·B, A and B in shared memory; TA, TB:
// the transpose bits (1: MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, %43, %44;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 128, f32) = scale_d·D + A·B, A and B in shared memory; TA, TB:
// the transpose bits (1: MN-major)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) += A·B, A (64 x 16) from registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 80, f32) += A·B, A (64 x 16) from registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A·B, A (64 x 16) from registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 80 || N == 128, "ss width");
  if constexpr (N == 64) wgmma_ss_n64<TA, TB>(d, da, db, scale_d);
  else if constexpr (N == 80) wgmma_ss_n80<TA, TB>(d, da, db, scale_d);
  else wgmma_ss_n128<TA, TB>(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 80 || N == 128, "rs width");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 80) wgmma_rs_n80(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// a float2 of shared memory by an ordinary load, which the compiler may
// schedule freely between the asm statements that order shared memory
__device__ __forceinline__ float2 ld_shared2(uint32_t addr) {
  return *reinterpret_cast<const float2*>(__cvta_shared_to_generic(addr));
}

__device__ __forceinline__ float fast_exp2(float x) {   // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a 64 x 64 accumulator fragment rounded to bf16 as wgmma's A fragments:
// columns 16kk..16kk+15 are exactly the A fragment of the kk-th k16 step
__device__ __forceinline__ void to_a_fragments(const float (&x)[32],
                                               uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// ---- the main kernel ----

// One work item: key tile k0 of (batch b, KV head kvh), and the query tiles
// qt_lo .. qt_lo + n_qt - 1 of each of its g query heads that see it.
struct Item {
  int b, kvh, k0, qt_lo, n_qt, n_iters;
};

// Item w of the launch. The (b, KV head) pairs go in chunks of `chunk`,
// all key tiles of a chunk together (chunk · n_kt items, one round of the
// grid where it has that many blocks), so that the dq accumulator and the
// Q and dO tiles of the items in flight stay in L2; within a chunk the
// key tiles go slowest, the first (under a causal mask the longest) first.
template <int BN>
__device__ __forceinline__ Item item_of(int w, int B, int KV, int g, int Sq,
                                        int Sk, int causal, int window,
                                        int q_offset, int n_kt, int chunk) {
  Item it;
  const int base = w / (chunk * n_kt) * chunk;   // the chunk's first pair
  const int cn = min(chunk, B * KV - base);      // its pairs
  const int j = w - base * n_kt;                 // the item in the chunk
  it.k0 = (j / cn) * BN;
  it.b = (base + j % cn) / KV;
  it.kvh = (base + j % cn) % KV;
  const int k_last = min(it.k0 + BN, Sk) - 1;
  int lo = 0, hi = Sq - 1;                 // query rows that see a key
  if (causal) lo = max(0, it.k0 - q_offset);
  if (window > 0) hi = min(hi, k_last + window - 1 - q_offset);
  it.qt_lo = lo / kBM;
  it.n_qt = lo <= hi ? hi / kBM - lo / kBM + 1 : 0;
  it.n_iters = g * it.n_qt;
  return it;
}

// Block c of G takes item c of each round of G items, every other round
// walked backwards. Past the end of the last round: W.
__device__ __forceinline__ int round_item(int n, int c, int G, int W) {
  const int w = n * G + ((n & 1) ? G - 1 - c : c);
  return w < W ? w : W;
}

struct Params {
  const float* lse2;   // (B, H, sq_pad): lse·log2(e), +inf past Sq
  const float* dsum;   // (B, H, sq_pad): D, 0 past Sq
  float* dq_acc;       // (B, H, sq_pad / 64) tiles of 64 x dh float32
  __nv_bfloat16* dk;   // (B, Sk, KV, dh)
  __nv_bfloat16* dv;
  int B, Sq, Sk, H, KV, g, causal, window, q_offset, sq_pad, n_kt, chunk;
  float scale, scale_log2;
};

// The shared-memory addresses of one block (a 1024-byte aligned base).
struct Smem {
  uint32_t k, v, q, dout, ds, dq, lse, d, full_kv, empty_kv, full_q, empty_q,
      half_dq, full_dq, empty_dq;
};

// Consumer warpgroup CW of a block: its loop over the block's items.
template <int DH, int CW>
__device__ __forceinline__ void consume(const Params& p, const Smem& sm,
                                        int c, int G, int W, int ct) {
  using C = Cfg<DH>;
  constexpr int kc = C::kSplitCols ? 0 : 64 * CW;   // first key it owns
  constexpr int kCol = C::kSplitCols ? CW * C::kN : 0;  // its first column
  // dh > 80: dk, dv and dq together hold too many registers for the A
  // fragments to stay live beside them, so dQ waits for dV and dK
  constexpr bool kFused = DH > 80;                  // (the dS loop below)
  // dQ's passes: dh > 80 in 64-column passes after dV and dK are done, so
  // that dk, dv and the A fragments leave room for its accumulator
  constexpr int kPasses = DH > 80 ? C::kN / 64 : 1;
  constexpr int kNP = C::kN / kPasses;
  const int quad = ct % 4;
  const int r0 = (ct / 32) * 16 + (ct % 32) / 4;    // fragment rows r0, r0+8
  const uint32_t sds = sm.ds + CW * C::kDSBytes;    // its dSᵀ tile
  auto group_sync = [&]() {                         // this warpgroup only
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + CW) : "memory");
  };

  float dk[C::kN / 2], dv[C::kN / 2], s[32], dp[32], dq[kNP / 2];
  uint32_t pa[4][4], da[4][4];
  int ring = 0;                                     // Q tiles consumed
  for (int n = 0; n * G < W; ++n) {                 // n: items taken so far
    const int w = round_item(n, c, G, W);
    if (w == W) break;                              // only in the last round
    const Item it = item_of<C::kBN>(w, p.B, p.KV, p.g, p.Sq, p.Sk, p.causal,
                                    p.window, p.q_offset, p.n_kt, p.chunk);
#pragma unroll
    for (int i = 0; i < C::kN / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(sm.full_kv, n & 1);
    const int key0 = it.k0 + kc;                    // its first key position

    for (int t = 0; t < it.n_iters; ++t, ++ring) {
      const int st = ring % C::kStages;
      const int h = it.kvh * p.g + t / it.n_qt;
      const int q0 = (it.qt_lo + t % it.n_qt) * kBM;
      const uint32_t sq = sm.q + st * C::kQBytes;
      const uint32_t sdo = sm.dout + st * C::kQBytes;
      mbar_wait(sm.full_q + 8 * st, (ring / C::kStages) & 1);

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this consumer's 64 keys x 64 queries
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kQKSteps; ++kk) {
        const uint32_t col = (kk % 4) * 32;     // bytes along the chunk's row
        mma_ss<64, 0, 0>(
            s, smem_desc(sm.k + ((kk / 4) * C::kBN + kc) * kRowBytes + col,
                         16, 1024),
            smem_desc(sq + (kk / 4) * kBM * kRowBytes + col, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < C::kQKSteps; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        mma_ss<64, 0, 0>(
            dp, smem_desc(sm.v + ((kk / 4) * C::kBN + kc) * kRowBytes + col,
                          16, 1024),
            smem_desc(sdo + (kk / 4) * kBM * kRowBytes + col, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();                          // Sᵀ is in
      fence_regs(s);

      // Pᵀ = exp2(Sᵀ·c − lse2) over the visible pairs; a tile that crosses
      // the diagonal or the window's edge is masked element by element.
      // Keys past Sk are zero rows of K and V and queries past Sq have lse2
      // +inf, so neither needs a mask. Then dSᵀ = Pᵀ∘(dPᵀ − D), into
      // registers and, bf16, into this consumer's dSᵀ tile (row: key, 64
      // query columns; the 128-byte swizzle). At dh <= 80 the exps run
      // while dPᵀ is on the tensor cores; wider, dk and dv leave no
      // registers for Sᵀ to outlive the exps, so dPᵀ is waited for first
      // and each P goes into dS as it is made.
      const int qpos0 = p.q_offset + q0;
      const bool whole = (!p.causal || key0 + 63 <= qpos0) &&
                         (p.window <= 0 || qpos0 + 63 - key0 < p.window);
      auto ds_row = [&](int j) {
        const float2 dd = ld_shared2(sm.d + st * C::kVecBytes +
                                           (8 * j + 2 * quad) * 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          dp[i] = s[i] * (dp[i] - ((e & 1) ? dd.y : dd.x));
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half;
          st_shared(sds + r * kRowBytes + ((j ^ (r % 8)) << 4) + quad * 4,
                    pack_bf16(dp[4 * j + 2 * half], dp[4 * j + 2 * half + 1]));
        }
      };
      if constexpr (kFused) {
        wgmma_wait<0>();                        // dPᵀ is in
        fence_regs(dp);
      }
      // the exponent of each pair, lse2 its column's; masked: -inf
      auto arg = [&](int i, const float2& l2) {
        return fmaf(s[i], p.scale_log2, -((i & 1) ? l2.y : l2.x));
      };
      if (whole) {                              // every pair visible
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = ld_shared2(sm.lse + st * C::kVecBytes +
                                             (8 * j + 2 * quad) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * j + e] = fast_exp2(arg(4 * j + e, l2));
          if constexpr (kFused) ds_row(j);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = ld_shared2(sm.lse + st * C::kVecBytes +
                                             (8 * j + 2 * quad) * 4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = key0 + r0 + 8 * (e >> 1);
            const int qpos = qpos0 + 8 * j + 2 * quad + (e & 1);
            bool ok = true;
            if (p.causal) ok = kpos <= qpos;
            if (p.window > 0) ok = ok && qpos - kpos < p.window;
            s[4 * j + e] = fast_exp2(ok ? arg(4 * j + e, l2) : -INFINITY);
          }
          if constexpr (kFused) ds_row(j);
        }
      }
      to_a_fragments(s, pa);
      if constexpr (!kFused) {
        wgmma_wait<0>();                        // dPᵀ is in
        fence_regs(dp);
#pragma unroll
        for (int j = 0; j < 8; ++j) ds_row(j);
      }
      to_a_fragments(dp, da);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      group_sync();                             // the dSᵀ tile is whole

      // dV += Pᵀ·dO, dK += dSᵀ·Q (dO and Q MN-major, their columns kCol..),
      // and dQ = dS·K over its 64 keys (A its dSᵀ, B its K rows, both
      // MN-major)
      // dQ in passes of kNP columns (dh > 80: 64 at a time, so its
      // accumulator takes 32 registers beside dk and dv)
      auto issue_dq = [&](int pass) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_ss<kNP, 1, 1>(
              dq, smem_desc(sds + 16 * kk * kRowBytes, kBM * kRowBytes, 1024),
              smem_desc(sm.k + (((kCol + kNP * pass) / 64) * C::kBN + kc +
                                16 * kk) *
                                   kRowBytes,
                        C::kBN * kRowBytes, 1024),
              kk > 0);
        wgmma_commit();
      };
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<C::kN>(dv, pa[kk],
                      smem_desc(sdo + ((kCol / 64) * kBM + 16 * kk) *
                                          kRowBytes,
                                kBM * kRowBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs<C::kN>(dk, da[kk],
                      smem_desc(sq + ((kCol / 64) * kBM + 16 * kk) *
                                         kRowBytes,
                                kBM * kRowBytes, 1024));
      wgmma_commit();
      if constexpr (kPasses == 1) issue_dq(0);
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      if (ct == 0) mbar_arrive(sm.empty_q + 8 * st);  // Q and dO are read

      // dq into a staging buffer (64 rows x dh, each row's 8-float groups
      // swizzled, dq_group) once the dq writer has emptied it. Below dh
      // 256 the two consumers' partial dQ share the tile's columns: the
      // first stores its own, the second adds its own to it, so that one
      // reduction a tile goes to the accumulator; at dh 256 each stores
      // its half of the columns.
      constexpr bool kSum = !C::kSplitCols;
      constexpr int kG = C::kN / 8;                 // 8-float groups a row
      const int db = ring % C::kDQBufs;
      const uint32_t phase = (ring / C::kDQBufs) & 1;
      if (kSum && CW == 1)
        mbar_wait(sm.half_dq + 8 * db, phase);      // the first part is in
      else
        mbar_wait(sm.empty_dq + 8 * db, phase ^ 1);
#pragma unroll
      for (int pass = 0; pass < kPasses; ++pass) {
        if (kPasses > 1) {
          wgmma_fence();
          issue_dq(pass);
          wgmma_wait<0>();
          fence_regs(dq);
        }
        // the row's address, laundered so that the compiler computes the
        // addresses here and does not hoist them out of the loop into
        // registers the accumulators need
        uint32_t row_at = sm.dq + db * C::kDQBytes +
                          (kCol * kBM + r0 * C::kN + 2 * quad) * 4;
        int rw = r0;
        asm volatile("" : "+r"(row_at), "+r"(rw));
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int j = 0; j < kNP / 8; ++j) {
            const uint32_t at =
                row_at + (8 * half * C::kN +
                          8 * dq_group<kG>(kNP / 8 * pass + j, rw + 8 * half)) *
                             4;
            float x = dq[4 * j + 2 * half], y = dq[4 * j + 2 * half + 1];
            if (kSum && CW == 1) {
              const float2 first = ld_shared2(at);
              x += first.x;
              y += first.y;
            }
            st_shared2(at, x, y);
          }
      }
      if (kSum && CW == 0) {
        group_sync();
        if (ct == 0) mbar_arrive(sm.half_dq + 8 * db);
      } else {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        group_sync();
        if (ct == 0) mbar_arrive(sm.full_dq + 8 * db);
      }
    }

    // epilogue: dk·scale and dv in bf16 from the fragments, rows past Sk
    // dropped; the K/V buffers are free for the next item
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kpos = key0 + r0 + 8 * half;
      if (kpos < p.Sk) {
        const int64_t at = ((int64_t)(it.b * p.Sk + kpos) * p.KV + it.kvh) * DH;
#pragma unroll
        for (int j = 0; j < C::kN / 8; ++j) {
          const int col = kCol + 8 * j + 2 * quad;
          *reinterpret_cast<uint32_t*>(p.dk + at + col) =
              pack_bf16(dk[4 * j + 2 * half] * p.scale,
                        dk[4 * j + 2 * half + 1] * p.scale);
          *reinterpret_cast<uint32_t*>(p.dv + at + col) =
              pack_bf16(dv[4 * j + 2 * half], dv[4 * j + 2 * half + 1]);
        }
      }
    }
    if (ct == 0) mbar_arrive(sm.empty_kv);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const Params p) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  Smem sm;
  sm.k = base;
  sm.v = base + C::kOffV;
  sm.q = base + C::kOffQ;
  sm.dout = base + C::kOffDO;
  sm.ds = base + C::kOffDS;
  sm.dq = base + C::kOffDQ;
  sm.lse = base + C::kOffLse;
  sm.d = base + C::kOffD;
  sm.full_kv = base + C::kOffBar;
  sm.empty_kv = sm.full_kv + 8;
  sm.full_q = sm.empty_kv + 8;                 // + 8·stage each
  sm.empty_q = sm.full_q + 8 * C::kStages;
  sm.half_dq = sm.empty_q + 8 * C::kStages;    // + 8·buffer each
  sm.full_dq = sm.half_dq + 8 * C::kDQBufs;
  sm.empty_dq = sm.full_dq + 8 * C::kDQBufs;

  const int W = p.n_kt * p.B * p.KV;
  const int G = gridDim.x, c = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(sm.full_kv, 1);
    mbar_init(sm.empty_kv, 2);                 // one arrival a consumer
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(sm.full_q + 8 * s, 1);
      mbar_init(sm.empty_q + 8 * s, 2);
    }
    for (int b = 0; b < C::kDQBufs; ++b) {
      mbar_init(sm.half_dq + 8 * b, 1);        // the first consumer
      mbar_init(sm.full_dq + 8 * b, C::kSplitCols ? 2 : 1);  // the last
      mbar_init(sm.empty_dq + 8 * b, 1);       // the dq writer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: thread 0 issues every load, thread 32 is
    // the dq writer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      int ring = 0;                             // Q tiles issued so far
      for (int n = 0; n * G < W; ++n) {
        const int w = round_item(n, c, G, W);
        if (w == W) break;                      // only in the last round
        const Item it = item_of<C::kBN>(w, p.B, p.KV, p.g, p.Sq, p.Sk,
                                        p.causal, p.window, p.q_offset,
                                        p.n_kt, p.chunk);
        mbar_wait(sm.empty_kv, (n & 1) ^ 1);    // the first wait: free
        mbar_expect_tx(sm.full_kv, 2 * C::kTileBytes);
        for (int ch = 0; ch < C::kChunks; ++ch) {
          tma_load(sm.k + ch * C::kBN * kRowBytes, &tk, sm.full_kv, 64 * ch,
                   it.kvh, it.k0, it.b);
          tma_load(sm.v + ch * C::kBN * kRowBytes, &tv, sm.full_kv, 64 * ch,
                   it.kvh, it.k0, it.b);
        }
        for (int t = 0; t < it.n_iters; ++t, ++ring) {
          const int st = ring % C::kStages;
          const int h = it.kvh * p.g + t / it.n_qt;
          const int q0 = (it.qt_lo + t % it.n_qt) * kBM;
          const uint32_t full = sm.full_q + 8 * st;
          mbar_wait(sm.empty_q + 8 * st, ((ring / C::kStages) & 1) ^ 1);
          mbar_expect_tx(full, 2 * C::kQBytes + 2 * C::kVecBytes);
          for (int ch = 0; ch < C::kChunks; ++ch) {
            tma_load(sm.q + st * C::kQBytes + ch * kBM * kRowBytes, &tq,
                     full, 64 * ch, h, q0, it.b);
            tma_load(sm.dout + st * C::kQBytes + ch * kBM * kRowBytes, &tdo,
                     full, 64 * ch, h, q0, it.b);
          }
          const int64_t row = (int64_t)(it.b * p.H + h) * p.sq_pad + q0;
          bulk_load(sm.lse + st * C::kVecBytes, p.lse2 + row, C::kVecBytes,
                    full);
          bulk_load(sm.d + st * C::kVecBytes, p.dsum + row, C::kVecBytes,
                    full);
        }
      }
    } else if (tid == 32) {
      // the dq writer (a warp of its own): each staged tile reduced into
      // the accumulator by one bulk operation; the buffer is free again
      // once the operation has read it
      int ring = 0;
      for (int n = 0; n * G < W; ++n) {
        const int w = round_item(n, c, G, W);
        if (w == W) break;
        const Item it = item_of<C::kBN>(w, p.B, p.KV, p.g, p.Sq, p.Sk,
                                        p.causal, p.window, p.q_offset,
                                        p.n_kt, p.chunk);
        for (int t = 0; t < it.n_iters; ++t, ++ring) {
          const int h = it.kvh * p.g + t / it.n_qt;
          const int64_t tile = (int64_t)(it.b * p.H + h) * (p.sq_pad / kBM) +
                               it.qt_lo + t % it.n_qt;
          const int db = ring % C::kDQBufs;
          mbar_wait(sm.full_dq + 8 * db, (ring / C::kDQBufs) & 1);
          bulk_reduce_add(p.dq_acc + tile * kBM * DH, sm.dq + db * C::kDQBytes,
                          C::kDQBytes);
          asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
          mbar_arrive(sm.empty_dq + 8 * db);
        }
      }
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if (tid < 256) consume<DH, 0>(p, sm, c, G, W, tid - 128);
    else consume<DH, 1>(p, sm, c, G, W, tid - 256);
  }
}

// ---- pre and post ----

// D = rowsum(do∘o) and lse·log2(e) a (b, h, row) of the padded layout
// (padding rows: 0 and +inf), and the dq accumulator zeroed. A row of o
// and do is kL neighbouring lanes (one 16-byte vector of each a lane, kL a
// power of two >= dh/8), so a warp reads whole rows in order.
template <int DH>
__global__ void __launch_bounds__(256)
    flash_bwd_kernel_sm90_pre(const __nv_bfloat16* __restrict__ o,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse,
                              float* __restrict__ lse2,
                              float* __restrict__ dsum,
                              float* __restrict__ dq_acc, int B, int Sq,
                              int H, int sq_pad) {
  constexpr int kVecs = DH / 8;                     // 16-byte vectors a row
  constexpr int kL = kVecs <= 8 ? 8 : (kVecs <= 16 ? 16 : 32);
  const int64_t rows = (int64_t)B * Sq * H;         // (b, i, h), in order
  const int64_t lanes = (rows * kL + 31) / 32 * 32;  // whole warps
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int j = threadIdx.x % kL;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < lanes;
       t += stride) {                               // warp-uniform bound
    const int64_t r = t / kL;
    float acc = 0.f;
    if (r < rows && j < kVecs) {
      const uint4 a = reinterpret_cast<const uint4*>(o + r * DH)[j];
      const uint4 d = reinterpret_cast<const uint4*>(dout + r * DH)[j];
      const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* dh2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(ah[e]);
        const float2 y = __bfloat1622float2(dh2[e]);
        acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
      }
    }
#pragma unroll
    for (int off = kL / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (r < rows && j == 0) {
      const int64_t h = r % H, bi = r / H;
      const int64_t row = (bi / Sq * H + h) * Sq + bi % Sq;  // (b, h, i)
      const int64_t at = (bi / Sq * H + h) * sq_pad + bi % Sq;
      dsum[at] = acc;
      lse2[at] = lse[row] * kLog2e;                 // +inf stays +inf
    }
  }
  const int pad = sq_pad - Sq;                      // rows past Sq: P = 0
  const int64_t pads = (int64_t)B * H * pad;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < pads;
       t += stride) {
    const int64_t at = t / pad * sq_pad + Sq + t % pad;
    dsum[at] = 0.f;
    lse2[at] = INFINITY;
  }
  const int64_t n4 = (int64_t)B * H * sq_pad * (DH / 4);
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n4;
       t += stride)
    reinterpret_cast<float4*>(dq_acc)[t] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dq = accumulator · scale in bf16: eight values a thread, read in the
// accumulator's order (tiles of 64 rows x dh, at dh 256 in two parts of
// 128 columns; each row's 8-float groups swizzled, dq_group) and
// written to their (b, i, h) row, rows past Sq dropped.
template <int DH>
__global__ void __launch_bounds__(256)
    flash_bwd_kernel_sm90_post(const float* __restrict__ dq_acc,
                               __nv_bfloat16* __restrict__ dq, int Sq, int H,
                               int sq_pad, int64_t n8, float scale) {
  using C = Cfg<DH>;
  constexpr int kG = C::kN / 8;                     // 8-float groups a row
  constexpr int kPart8 = kBM * kG;                  //   a part
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n8;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t tile = e / (C::kParts * kPart8);
    const int in = (int)(e % (C::kParts * kPart8));
    const int row = in % kPart8 / kG;
    const int col = in / kPart8 * C::kN + 8 * dq_group<kG>(in % kG, row);
    const int n_qt = sq_pad / kBM;
    const int i = (int)(tile % n_qt) * kBM + row;
    if (i < Sq) {
      const int64_t bh = tile / n_qt;
      const float4 a = reinterpret_cast<const float4*>(dq_acc)[2 * e];
      const float4 b = reinterpret_cast<const float4*>(dq_acc)[2 * e + 1];
      uint4 out;
      out.x = pack_bf16(a.x * scale, a.y * scale);
      out.y = pack_bf16(a.z * scale, a.w * scale);
      out.z = pack_bf16(b.x * scale, b.y * scale);
      out.w = pack_bf16(b.z * scale, b.w * scale);
      *reinterpret_cast<uint4*>(
          dq + (((bh / H) * Sq + i) * H + bh % H) * DH + col) = out;
    }
  }
}

// ---- host side: tensor maps and the launches ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: taken through the runtime's
// entry-point query, so the library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, S, heads, dh) bf16 tensor as a 4-D map over (dh, heads, S, B):
// boxes of 64 columns x `rows` positions of one head, 128-byte swizzle,
// zero fill past every edge.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int dh,
              int heads, int S, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)S * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr,
            "flash_attention_bwd_sm90: cuTensorMapEncodeTiled failed "
            "(CUresult %d) for (dh %d, heads %d, S %d, B %d), box rows %d\n",
            (int)r, dh, heads, S, B, rows);
    return false;
  }
  return true;
}

// a grid-stride launch of n threads' work: at most 8 blocks of 256 an SM
int stride_grid(int64_t n, int sms) {
  const int64_t blocks = (n + 255) / 256;
  const int64_t cap = (int64_t)sms * 8;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* dq_acc, void* lse2, void* dsum, int B, int Sq, int Sk, int H,
           int KV, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  using C = Cfg<DH>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(enc, &tq, q, DH, H, Sq, B, kBM) ||
      !make_map(enc, &tk, k, DH, KV, Sk, B, C::kBN) ||
      !make_map(enc, &tv, v, DH, KV, Sk, B, C::kBN) ||
      !make_map(enc, &tdo, dout, DH, H, Sq, B, kBM))
    return (int)cudaErrorInvalidValue;
  int device, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  const int sq_pad = (Sq + kBM - 1) / kBM * kBM;

  const int64_t pre_lanes = (int64_t)B * Sq * H * 32;   // at most 32 a row
  flash_bwd_kernel_sm90_pre<DH><<<stride_grid(pre_lanes, sms), 256, 0,
                                  stream>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, (const float*)lse,
      (float*)lse2, (float*)dsum, (float*)dq_acc, B, Sq, H, sq_pad);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(flash_bwd_kernel_sm90<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.lse2 = (const float*)lse2;
  p.dsum = (const float*)dsum;
  p.dq_acc = (float*)dq_acc;
  p.dk = (__nv_bfloat16*)dk;
  p.dv = (__nv_bfloat16*)dv;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.KV = KV;
  p.g = H / KV;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.sq_pad = sq_pad;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  // persistent: one block an SM, each walking its share of the items
  constexpr int bn = C::kBN;
  p.n_kt = (Sk + bn - 1) / bn;
  const long items = (long)p.n_kt * B * KV;
  // a round of the grid is whole chunks of (b, KV head) pairs with all
  // their key tiles (item_of): chunk · n_kt blocks, the SMs left over idle,
  // so that block c's items of two rounds in a row (the second walked
  // backwards) are key tiles kt and n_kt - 1 - kt, whose causal work sums
  // to the same for every block
  p.chunk = sms / p.n_kt;
  if (p.chunk > B * KV) p.chunk = B * KV;
  if (p.chunk < 1) p.chunk = 1;
  const long round = p.n_kt <= sms ? (long)p.chunk * p.n_kt : sms;
  const int grid = (int)(items < round ? items : round);
  flash_bwd_kernel_sm90<DH><<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  // DH % 8 == 0: the ceil-div is exact
  const int64_t n8 = ((int64_t)B * H * sq_pad * DH + 8 - 1) / 8;
  flash_bwd_kernel_sm90_post<DH><<<stride_grid(n8, sms), 256, 0, stream>>>(
      (const float*)dq_acc, (__nv_bfloat16*)dq, Sq, H, sq_pad, n8, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v, o, do, dq, dk and dv; float32 lse (B, H, Sq) from K7 and
// float32 scratch: dq_acc B·H·sq_pad·dh, lse2 and dsum B·H·sq_pad each,
// sq_pad = ceil(Sq/64)·64. window <= 0: no window. The wrapper has checked
// shapes, dh in {64, 80, 128, 256}, H % KV == 0, Sk >= 1 and 16-byte
// aligned base pointers. Three launches (pre, main, post), each checked;
// the first error returns.
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dq_acc, void* lse2, void* dsum, int B, int Sq, int Sk, int H,
    int KV, int dh, int causal, int window, int q_offset, float scale,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, dq_acc, lse2, dsum,
                        B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 80:
      return launch<80>(q, k, v, o, dout, lse, dq, dk, dv, dq_acc, lse2, dsum,
                        B, Sq, Sk, H, KV, causal, window, q_offset, scale, s);
    case 128:
      return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, dq_acc, lse2,
                         dsum, B, Sq, Sk, H, KV, causal, window, q_offset,
                         scale, s);
    case 256:
      return launch<256>(q, k, v, o, dout, lse, dq, dk, dv, dq_acc, lse2,
                         dsum, B, Sq, Sk, H, KV, causal, window, q_offset,
                         scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
