// K7 on Hopper tensor cores: forward attention with an online softmax for
// bfloat16 q, k, v at head widths 64, 80, 128 and 256 — causal and/or a
// sliding window, grouped query heads (GQA), queries at absolute positions
// q_offset + i. `flash_attention_cuda` launches it for bf16 inputs at those
// widths; float32 inputs, and bf16 at the reduced configs' widths 16 and
// 32, stay on the SIMT kernel in flash_attention.cu.
//
// Replaces: the JAX package's Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:72, body `_flash_kernel`).
//
// Contract (kernels/flash_attention.py `flash_attention_ref`): q (B, Sq, H,
// dh), k and v (B, Sk, KV, dh), H = g·KV, query head h reads KV head h / g.
// Key j is visible to query i when j < Sk, j <= q_offset + i (causal) and
// q_offset + i - j < window (window > 0); a row with no visible key is 0.
//
// Numerics. q·k of bf16 operands accumulates in float32 on the tensor
// cores (exact products, sums in another order than the plain version).
// The 1/sqrt(dh) scale is applied to the float32 scores inside exp2, with
// log2(e) folded in: p = exp2(s·c - m·c), c = log2(e)/sqrt(dh). The row sum
// l adds the float32 p; P·V takes p rounded to bf16 and accumulates in
// float32; the output is acc / max(l, 1e-30) rounded once to bf16. Masked
// scores are -inf, so p = 0, and a row whose running max is still -inf
// uses 0 in its place (the plain version's m_safe), which keeps a row
// with no visible key at 0.
//
// What bounds it on an H100: operations. At llama3-8b's prefill (B 4,
// Sq = Sk = 2048, H 32, KV 8, dh 128, causal) the visible pairs need
// 1.4e11 FLOP on the bf16 tensor cores (989 TFLOP/s) against 168 MB of
// q, k, v and o: ~820 FLOP a byte, above the card's ~295.
//
// The design, for the card:
// * Work item: a 128-query tile of one head of one batch. A tile a head
//   (not the SIMT kernel's whole query group in one block, which would
//   make a wgmma tile 64/g positions tall and shuffle rows between heads)
//   keeps it a plain row block; the query heads of one KV head are
//   neighbours in the item order, so the group's g items reread the same
//   K/V tiles from L2 (2 MB a KV head at llama3's shape), not from HBM.
// * Persistent: one block an SM (min(items, SMs) blocks). Items are
//   numbered with the q tile slowest and longest first; block c takes
//   item c of each round of G items, every other round walked backwards,
//   so long and short causal tiles even out across blocks. A block's
//   producer loads the next item's Q and first K/V tiles while the
//   consumers finish this one, which hides the load latency a block a
//   tile would pay at every start. (A global item counter balances the
//   blocks better but puts an atomic and a zeroing launch in the way; it
//   was slower on the card.)
// * 384 threads: warpgroup 0 is the producer (one thread issues every TMA
//   load; setmaxnreg gives its registers away, 24 a thread), warpgroups
//   1 and 2 are consumers of 64 query rows each (the wgmma M), 240
//   registers a thread.
// * TMA: 4-D tensor maps over (dh, heads, S, B), so a box past Sq or Sk is
//   zero-filled by the hardware and never reads the next batch or head.
//   The 128-byte swizzle caps a box at 64 bf16, so a row of dh > 64 is
//   ceil(dh/64) boxes side by side ("chunks" of 64 columns). dh 80 rides on
//   a 128-wide tile: the map's dh of 80 zero-fills columns 80-127. Q has
//   two buffers at dh <= 128 (one at 256); K and V tiles a ring of two
//   stages; every buffer a full and an empty mbarrier.
// * S = Q·K^T: wgmma m64nNk16, Q and K both K-major in shared memory
//   (descriptors with the 128-byte swizzle; one k16 step is 32 bytes along
//   a row, four steps a chunk). dh 80 takes 5 steps, not 8.
// * O += P·V: P from registers as the A operand — the scores' accumulator
//   fragment, rounded to bf16, is exactly wgmma's A fragment — and V from
//   shared memory as it lies, (keys, dh), MN-major, with the descriptor's
//   transpose bit. O stays in float32 registers, 64 rows x dh (x 128 for
//   dh 80, whose columns 80-127 are zeros and never stored).
// * Overlap: a consumer issues S = Q·K_t^T and O += P_{t-1}·V_{t-1}
//   together, runs the softmax of S_t while the second is on the tensor
//   cores, and rescales O after it. The two consumers take turns to issue
//   (named barriers), so one's softmax runs beside the other's products.
// * The online softmax runs in registers: a row lives on the four threads
//   of a quad, so its max and sum are two shuffles.
// * Key tiles that the causal mask or the window hide in full are never
//   loaded; only tiles that cross the diagonal, the window's edge or Sk are
//   masked element by element.
// * Epilogue: O / l rounded to bf16 into the consumer's own rows of the Q
//   buffer (same swizzled layout), then one TMA store a chunk, which drops
//   rows past Sq and columns past dh; the buffer's empty barrier fires once
//   the store has read it.
//
// Tiles: 128 keys at dh <= 128, 64 at dh 256 (registers: S 32 + O 128 +
// P 16 floats a thread). Shared memory: 96 KB at dh 64, 192 KB at dh 80,
// 128 and 256, raised per launch with cudaFuncSetAttribute. ptxas: 168
// registers at launch, no spills, at every width.
#include <cuda.h>          // CUtensorMap and its enums; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kBM = 128;        // query rows a block: 2 consumer warpgroups
constexpr int kThreads = 384;   // producer warpgroup + 2 consumers
constexpr int kStages = 2;      // K/V ring depth
constexpr int kRowBytes = 128;  // one swizzled row of a 64-column chunk

template <int DH>
struct Cfg {
  static constexpr int kChunks = (DH + 63) / 64;       // boxes a row
  static constexpr int kDHP = kChunks * 64;            // width in smem
  static constexpr int kBN = DH <= 128 ? 128 : 64;     // keys a tile
  static constexpr int kQKSteps = DH / 16;             // k16 steps of q·k
  static constexpr int kPVSteps = kBN / 16;            // k16 steps of p·V
  static constexpr int kQBytes = kChunks * kBM * kRowBytes;
  static constexpr int kQBufs = DH <= 128 ? 2 : 1;    // next item's Q ahead
  static constexpr int kTileBytes = kChunks * kBN * kRowBytes;  // K or V
  static constexpr int kBarOffset =
      kQBufs * kQBytes + 2 * kStages * kTileBytes;
  // the tiles, 2·kQBufs + 4·kStages mbarriers, and room to align the base
  // to the swizzle's 1024-byte period
  static constexpr int kSmem =
      kBarOffset + 8 * (2 * kQBufs + 4 * kStages) + 1024;
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

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
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

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
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

// D (64 x 64, f32) = scale_d·D + A·B, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) = scale_d·D + A·B, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
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

// D (64 x 256, f32) += A·B, A (64 x 16) from registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "q·k tile of 64 or 128 keys");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 64 || N == 128 || N == 256, "p·V width 64, 128, 256");
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float fast_exp2(float x) {   // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A consumer warpgroup's view of one block: its 64 query rows, their
// positions and the accumulator fragment's coordinates. Element i of a
// 64 x N fragment lies in row (i & 2 ? row + 8 : row), column
// 8·(i / 4) + 2·quad + (i & 1).
template <int DH>
struct Consumer {
  using C = Cfg<DH>;
  uint32_t q_rows;         // this warpgroup's rows of Q in shared memory
  int quad, qpos0, qpos1;  // qpos1 = qpos0 + 8
  float scale_log2;

  // S = Q·K^T of the K tile at `k_tile`: issue only
  __device__ __forceinline__ void issue_qk(float (&sc)[C::kBN / 2],
                                           uint32_t k_tile) const {
#pragma unroll
    for (int kk = 0; kk < C::kQKSteps; ++kk) {
      const uint32_t col = (kk % 4) * 32;     // bytes along the chunk's row
      mma_ss<C::kBN>(
          sc, smem_desc(q_rows + (kk / 4) * kBM * kRowBytes + col, 16, 1024),
          smem_desc(k_tile + (kk / 4) * C::kBN * kRowBytes + col, 16, 1024),
          kk > 0);
    }
  }

  // O += P·V of the V tile at `v_tile` (MN-major: its 64-column chunks lie
  // kBN·128 bytes apart): issue only
  __device__ __forceinline__ void issue_pv(
      float (&acc)[C::kDHP / 2], const uint32_t (&pa)[C::kPVSteps][4],
      uint32_t v_tile) const {
#pragma unroll
    for (int kk = 0; kk < C::kPVSteps; ++kk)
      mma_rs<C::kDHP>(acc, pa[kk],
                      smem_desc(v_tile + kk * 16 * kRowBytes,
                                C::kBN * kRowBytes, 1024));
  }

  // -inf where key k0 + column is hidden from the row's query
  __device__ __forceinline__ void mask(float (&sc)[C::kBN / 2], int k0, int Sk,
                                       int causal, int window) const {
#pragma unroll
    for (int i = 0; i < C::kBN / 2; ++i) {
      const int kpos = k0 + 8 * (i / 4) + 2 * quad + (i & 1);
      const int qpos = (i & 2) ? qpos1 : qpos0;
      bool ok = kpos < Sk;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && qpos - kpos < window;
      if (!ok) sc[i] = -INFINITY;
    }
  }

  // The online softmax of one tile of scores, in place: sc becomes p, the
  // running max m and this thread's part of the row sum l move on, and
  // corr is the factor that brings the rows' earlier O to the new max.
  __device__ __forceinline__ void softmax(float (&sc)[C::kBN / 2], float (&m)[2],
                                          float (&l)[2],
                                          float (&corr)[2]) const {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < C::kBN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
    float base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;   // m_safe
      corr[r] = fast_exp2(m[r] * scale_log2 - base[r]);          // 0 from -inf
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < C::kBN / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -base[r]));
      sum[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
  }
};

// p rounded to bf16 as wgmma's A fragments: the scores' fragment for keys
// 16kk..16kk+15 is exactly the A fragment of the kk-th k16 step
template <int NS>
__device__ __forceinline__ void to_a_fragments(const float (&sc)[NS],
                                               uint32_t (&pa)[NS / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NS / 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

// ---- the kernel ----

// One work item: a 128-query tile of one head of one batch, and the key
// tiles some row of it can see, from a tile boundary.
struct Item {
  int h, b, q0, qpos_lo, qpos_hi, k_begin, n_tiles;
};

// Item w of the launch: q tiles slowest and longest first, the query heads
// of one KV head neighbours (module header).
template <int BN>
__device__ __forceinline__ Item item_of(int w, int n_qt, int H, int B, int Sq,
                                        int Sk, int causal, int window,
                                        int q_offset) {
  Item it;
  const int hb = H * B;
  it.q0 = (n_qt - 1 - w / hb) * kBM;
  it.h = (w % hb) % H;
  it.b = (w % hb) / H;
  it.qpos_lo = q_offset + it.q0;
  it.qpos_hi = q_offset + min(it.q0 + kBM, Sq) - 1;
  int k_end = Sk;
  it.k_begin = 0;
  if (causal) k_end = min(Sk, it.qpos_hi + 1);
  if (window > 0) it.k_begin = max(0, it.qpos_lo - window + 1);
  it.k_begin -= it.k_begin % BN;
  it.n_tiles = k_end > it.k_begin ? (k_end - it.k_begin + BN - 1) / BN : 0;
  return it;
}

// Block c of G takes item c of each round of G items, every other round
// walked backwards, so each block's sum of long and short causal tiles is
// about the same. Past the end of the last round: W.
__device__ __forceinline__ int round_item(int n, int c, int G, int W) {
  const int w = n * G + ((n & 1) ? G - 1 - c : c);
  return w < W ? w : W;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to,
                      float* __restrict__ lse, int B, int Sq, int Sk, int H,
                      int g, int causal, int window, int q_offset,
                      float scale_log2) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;  // Q buffers
  const uint32_t sk = sq + C::kQBufs * C::kQBytes;    // kStages K tiles
  const uint32_t sv = sk + kStages * C::kTileBytes;   // kStages V tiles
  const uint32_t full_q = sq + C::kBarOffset;         // + 8·buffer each
  const uint32_t empty_q = full_q + 8 * C::kQBufs;
  const uint32_t full_k = empty_q + 8 * C::kQBufs;    // + 8·stage each
  const uint32_t full_v = full_k + 8 * kStages;
  const uint32_t empty_k = full_v + 8 * kStages;
  const uint32_t empty_v = empty_k + 8 * kStages;

  const int n_qt = (Sq + kBM - 1) / kBM;
  const int W = n_qt * H * B;
  const int G = gridDim.x, c = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < C::kQBufs; ++i) {
      mbar_init(full_q + 8 * i, 1);
      mbar_init(empty_q + 8 * i, 2);    // one arrival a consumer warpgroup
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2);
      mbar_init(empty_v + 8 * s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: one thread issues every load, running ahead into the
    // next item while the consumers finish this one ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      int ring = 0;                             // K/V tiles issued so far
      for (int n = 0; n * G < W; ++n) {         // n: items taken so far
        const int w = round_item(n, c, G, W);
        if (w == W) break;                      // only in the last round
        const Item it = item_of<C::kBN>(w, n_qt, H, B, Sq, Sk, causal,
                                        window, q_offset);
        const int qb = n % C::kQBufs;
        const uint32_t qbuf = sq + qb * C::kQBytes;
        mbar_wait(empty_q + 8 * qb, ((n / C::kQBufs) & 1) ^ 1);  // 1st: free
        mbar_expect_tx(full_q + 8 * qb, C::kQBytes);
        for (int ch = 0; ch < C::kChunks; ++ch)
          for (int half = 0; half < 2; ++half)
            tma_load(qbuf + (ch * kBM + half * 64) * kRowBytes, &tq,
                     full_q + 8 * qb, 64 * ch, it.h, it.q0 + 64 * half, it.b);
        for (int t = 0; t < it.n_tiles; ++t, ++ring) {
          const int s = ring % kStages;
          const uint32_t free_parity = ((ring / kStages) & 1) ^ 1;
          const int k0 = it.k_begin + t * C::kBN;
          mbar_wait(empty_k + 8 * s, free_parity);
          mbar_expect_tx(full_k + 8 * s, C::kTileBytes);
          for (int ch = 0; ch < C::kChunks; ++ch)
            tma_load(sk + s * C::kTileBytes + ch * C::kBN * kRowBytes, &tk,
                     full_k + 8 * s, 64 * ch, it.h / g, k0, it.b);
          mbar_wait(empty_v + 8 * s, free_parity);
          mbar_expect_tx(full_v + 8 * s, C::kTileBytes);
          for (int ch = 0; ch < C::kChunks; ++ch)
            tma_load(sv + s * C::kTileBytes + ch * C::kBN * kRowBytes, &tv,
                     full_v + 8 * s, 64 * ch, it.h / g, k0, it.b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = tid / 128 - 1;
    const int ct = tid % 128;
    const int quad = ct % 4;
    // this thread's rows of the accumulators: row and row + 8
    const int row = cw * 64 + (ct / 32) * 16 + (ct % 32) / 4;
    // The two consumers take turns to issue their products (named barriers
    // 3 and 4), so one's softmax runs while the other's products hold the
    // tensor cores. Consumer 0 goes first; at the end it takes consumer
    // 1's last hand-over, which nobody else waits for.
    bool turns = false;
    auto turn_begin = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory");
    };
    auto turn_end = [&]() {
      asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory");
    };

    float acc[C::kDHP / 2];
    float sc[C::kBN / 2];
    uint32_t pa[C::kPVSteps][4];
    int ring = 0;                               // K/V tiles consumed so far
    for (int n = 0; n * G < W; ++n) {           // n: items taken so far
      const int w = round_item(n, c, G, W);
      if (w == W) break;                        // only in the last round
      const Item it = item_of<C::kBN>(w, n_qt, H, B, Sq, Sk, causal, window,
                                      q_offset);
      const int qb = n % C::kQBufs;
      const uint32_t qbuf = sq + qb * C::kQBytes;
      const Consumer<DH> cs{qbuf + cw * 64 * kRowBytes, quad,
                            it.qpos_lo + row, it.qpos_lo + row + 8,
                            scale_log2};
      // a tile that crosses the diagonal, the window's edge or Sk is masked
      auto whole = [&](int k0) {
        return k0 + C::kBN <= Sk &&
               (!causal || k0 + C::kBN - 1 <= it.qpos_lo) &&
               (window <= 0 || it.qpos_hi - k0 < window);
      };
#pragma unroll
      for (int i = 0; i < C::kDHP / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
      if (it.n_tiles > 0 && !turns) {
        turns = true;
        if (cw == 1) asm volatile("bar.arrive 3, 256;\n" ::: "memory");
      }
      mbar_wait(full_q + 8 * qb, (n / C::kQBufs) & 1);

      if (it.n_tiles > 0) {
        // tile 0: S, softmax, P
        const int s = ring % kStages;
        mbar_wait(full_k + 8 * s, (ring / kStages) & 1);
        fence_regs(sc);
        turn_begin();
        wgmma_fence();
        cs.issue_qk(sc, sk + s * C::kTileBytes);
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_regs(sc);
        if (ct == 0) mbar_arrive(empty_k + 8 * s);
        if (!whole(it.k_begin)) cs.mask(sc, it.k_begin, Sk, causal, window);
        cs.softmax(sc, m, l, corr);
        to_a_fragments(sc, pa);
      }
      // tile t: S = Q·K_t^T runs on the tensor cores beside
      // O += P_{t-1}·V_{t-1}; the softmax of S waits for the first only,
      // O's rescale for both
      for (int t = 1; t < it.n_tiles; ++t) {
        const int s = (ring + t) % kStages, sp = (ring + t - 1) % kStages;
        const int k0 = it.k_begin + t * C::kBN;
        mbar_wait(full_k + 8 * s, ((ring + t) / kStages) & 1);
        mbar_wait(full_v + 8 * sp, ((ring + t - 1) / kStages) & 1);
        fence_regs(sc);
        fence_regs(acc);
        fence_regs(pa);
        turn_begin();
        wgmma_fence();
        cs.issue_qk(sc, sk + s * C::kTileBytes);
        wgmma_commit();
        cs.issue_pv(acc, pa, sv + sp * C::kTileBytes);
        wgmma_commit();
        turn_end();
        wgmma_wait<1>();                       // S is in
        fence_regs(sc);
        if (ct == 0) mbar_arrive(empty_k + 8 * s);
        if (!whole(k0)) cs.mask(sc, k0, Sk, causal, window);
        cs.softmax(sc, m, l, corr);
        wgmma_wait<0>();                       // O is in
        fence_regs(acc);
        fence_regs(pa);
        if (ct == 0) mbar_arrive(empty_v + 8 * sp);
#pragma unroll
        for (int i = 0; i < C::kDHP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        to_a_fragments(sc, pa);
      }
      if (it.n_tiles > 0) {
        // the last tile's O += P·V
        ring += it.n_tiles;
        const int sp = (ring - 1) % kStages;
        mbar_wait(full_v + 8 * sp, ((ring - 1) / kStages) & 1);
        fence_regs(acc);
        fence_regs(pa);
        turn_begin();
        wgmma_fence();
        cs.issue_pv(acc, pa, sv + sp * C::kTileBytes);
        wgmma_commit();
        turn_end();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        if (ct == 0) mbar_arrive(empty_v + 8 * sp);
      }

      // epilogue: O / l in bf16 into this warpgroup's rows of the Q buffer,
      // swizzled as TMA reads them, then one TMA store a chunk; the buffer
      // is free for the next Q once the store has read it
      const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      if (lse != nullptr && quad == 0) {
        // each row's log-sum-exp of the scaled scores, natural log: the
        // exp2 form's m·c + log2(l), times ln 2; +inf on a row with no
        // visible key, so that the backward's exp(s - lse) is 0 there
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qi = it.q0 + row + 8 * half;
          if (qi < Sq)
            lse[((int64_t)it.b * H + it.h) * Sq + qi] =
                m[half] == -INFINITY
                    ? INFINITY
                    : (m[half] * scale_log2 + log2f(half ? l1 : l0)) *
                          0.6931471805599453f;
        }
      }
#pragma unroll
      for (int j = 0; j < C::kDHP / 8; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = row + 8 * half;
          const float inv = half ? inv1 : inv0;
          st_shared(qbuf + ((j / 8) * kBM + r) * kRowBytes +
                        (((j % 8) ^ (r % 8)) << 4) + quad * 4,
                    pack_bf16(acc[4 * j + 2 * half] * inv,
                              acc[4 * j + 2 * half + 1] * inv));
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      if (ct == 0) {
        for (int ch = 0; ch < C::kChunks; ++ch)
          tma_store(&to, cs.q_rows + ch * kBM * kRowBytes, 64 * ch, it.h,
                    it.q0 + 64 * cw, it.b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        mbar_arrive(empty_q + 8 * qb);
      }
    }
    if (cw == 0 && turns) turn_begin();   // consumer 1's last hand-over
  }
}

// ---- host side: tensor maps and the launch ----

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
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads, dh) bf16 tensor as a 4-D map over (dh, heads, S, B):
// boxes of 64 columns x `rows` positions of one head, 128-byte swizzle,
// zero fill past every edge.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, int dh,
              int heads, int S, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)S * heads * dh * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr,
            "flash_attention_sm90: cuTensorMapEncodeTiled failed (CUresult "
            "%d) for (dh %d, heads %d, S %d, B %d), box rows %d\n",
            (int)r, dh, heads, S, B, rows);
    return false;
  }
  return true;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  using C = Cfg<DH>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(enc, &tq, q, DH, H, Sq, B, 64) ||
      !make_map(enc, &tk, k, DH, KV, Sk, B, C::kBN) ||
      !make_map(enc, &tv, v, DH, KV, Sk, B, C::kBN) ||
      !make_map(enc, &to, o, DH, H, Sq, B, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_sm90<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  // persistent: one block an SM, each walking its share of the items
  const long items = (long)((Sq + kBM - 1) / kBM) * H * B;
  const int grid = (int)(items < sms ? items : sms);
  flash_kernel_sm90<DH><<<grid, kThreads, C::kSmem, stream>>>(
      tq, tk, tv, to, lse, B, Sq, Sk, H, H / KV, causal, window, q_offset,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q, k, v and o; lse: NULL, or float32 (B, H, Sq) for each row's
// log-sum-exp (what the backward needs; the serving path passes NULL and
// the kernel writes nothing more). window <= 0: no window. The wrapper has
// checked shapes, dh in {64, 80, 128, 256}, H % KV == 0, H / KV <= 64,
// Sk >= 1 and 16-byte aligned base pointers.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* o, void* lse,
                                           int B, int Sq, int Sk, int H,
                                           int KV, int dh, int causal,
                                           int window, int q_offset,
                                           float scale, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* const f = static_cast<float*>(lse);
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, o, f, B, Sq, Sk, H, KV, causal, window,
                        q_offset, scale, s);
    case 80:
      return launch<80>(q, k, v, o, f, B, Sq, Sk, H, KV, causal, window,
                        q_offset, scale, s);
    case 128:
      return launch<128>(q, k, v, o, f, B, Sq, Sk, H, KV, causal, window,
                         q_offset, scale, s);
    case 256:
      return launch<256>(q, k, v, o, f, B, Sq, Sk, H, KV, causal, window,
                         q_offset, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
