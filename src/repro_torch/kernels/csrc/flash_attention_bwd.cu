// K7b: the backward of K7's attention — dq, dk and dv of causal or
// sliding-window attention with grouped query heads (GQA), queries at
// absolute positions q_offset + i.
//
// Replaces: no TPU kernel. The JAX package has no backward Pallas kernel:
// it differentiates its jnp flash loop (src/repro/models/layers.py
// `flash_attention`, jax.checkpoint per kv block) or, on a TPU, through
// `flash_attention_pallas`, recomputing the scores. The port's training
// path runs K7 in every dense layer on the card, so its gradient is a
// kernel too: `kernels/ops.py` wraps K7 in a torch.autograd.Function whose
// backward launches this one.
//
// Contract (kernels/flash_attention.py `flash_attention_bwd_ref`): q, do
// and o (B, Sq, H, dh), k and v (B, Sk, KV, dh), H = g·KV, one dtype T
// (float32 or bfloat16); query head h reads KV head h / g; the mask is
// K7's. With s = (q/sqrt(dh))·k, P = softmax(s) over the visible keys
// (a row with none is 0), D = rowsum(do∘o) and dS = P∘(do·vᵀ − D):
//   dq = dS·k / sqrt(dh),  dk = Σ_g dSᵀ·q / sqrt(dh),  dv = Σ_g Pᵀ·do.
// dk and dv sum over the g query heads of their KV head. Every product
// and sum is float32; the outputs are rounded to T once.
//
// K7 keeps no log-sum-exp, so this kernel recomputes the row statistics
// (max and sum of exp) in a first pass over the keys, as the TPU path
// recomputes the scores.
//
// What bounds it on an H100: operations. At h2o-danube-1.8b's training
// layer (B 4, S 2048, H 32, KV 8, dh 80, causal) the visible pairs need
// 5 products of 2·dh FLOP each at the least (the scores for the row
// statistics and again for P, do·vᵀ, dS·k, dSᵀ·q and Pᵀ·do share four of
// them in the tensor-core form), 2.1e11 FLOP against 0.34 GB of inputs
// and outputs.
//
// What the design does about it, as a first simple kernel: float32 on the
// CUDA cores (67 TFLOP/s, not the 989 of the bf16 tensor cores), one
// cooperative launch in two phases split by one grid.sync():
//   A. a block a tile of 64 query rows (position × head of the group, as
//      K7's tiles): the row statistics over the visible key tiles of 32,
//      D, then dq over the same tiles (scores, P, do·vᵀ, dS, dS·k), and
//      the rows' (max, sum, D) to a float32 scratch;
//   B. a block a tile of 32 keys of one KV head: dk and dv in registers
//      over every query row that sees a key of the tile, all g heads
//      included, so no atomics are needed and the sums are deterministic.
// The blocks are the co-resident ones and walk the tiles of each phase
// in turn. Shared memory: the q and do tiles (64 rows), the k and v tiles
// (32 keys) at a padded row stride of dh + 1 floats, P and dS (64 × 33)
// and three row vectors: 78 KB at dh 80, 210 KB at dh 256.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows a tile: position × head of the group
constexpr int kKeys = 32;   // keys a tile
constexpr int kLdS = kKeys + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;       // (B, Sq, H, 3): the row's max, sum of exp and D
  int B, Sq, Sk, H, KV, g, bq, causal, window, q_offset;
  float scale;
};

template <int DH>
struct Tile {
  static constexpr int kLd = DH + 1;        // padded: no bank conflicts
  // dq, dk, dv: threads across columns (16 where 32 does not divide dh)
  static constexpr int kTc = DH < 32 ? DH : (DH % 32 ? 16 : 32);
  static constexpr int kTr = kThreads / kTc;
  static constexpr int kRpt = kRows / kTr;  // dq rows a thread
  static constexpr int kKpt = kKeys / kTr;  // dk, dv keys a thread
  static constexpr int kCpt = DH / kTc;     // columns a thread
  static constexpr int kFloats =
      (2 * kRows + 2 * kKeys) * kLd + 2 * kRows * kLdS + 3 * kRows;
};

__device__ __forceinline__ bool visible(int qpos, int kpos, int causal,
                                        int window) {
  bool ok = true;
  if (causal) ok = kpos <= qpos;
  if (window > 0) ok = ok && qpos - kpos < window;
  return ok;
}

// rows [0, kRows) of a query tile at position q0 of (batch b, KV head kvh)
// into dst, times mul; rows past `rows` or Sq are 0
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          const Args& a, int b, int kvh,
                                          int q0, int rows, float mul) {
  for (int i = threadIdx.x; i < kRows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int qi = q0 + r / a.g;
    float val = 0.f;
    if (r < rows && qi < a.Sq)
      val = to_f(src[(((int64_t)b * a.Sq + qi) * a.H + kvh * a.g + r % a.g)
                         * DH + d]) * mul;
    dst[r * Tile<DH>::kLd + d] = val;
  }
}

// keys [k0, k0 + kKeys) of (batch b, KV head kvh) into dst; past k_end 0
template <typename T, int DH>
__device__ __forceinline__ void load_keys(float* dst, const T* src,
                                          const Args& a, int b, int kvh,
                                          int k0, int k_end) {
  for (int i = threadIdx.x; i < kKeys * DH; i += kThreads) {
    const int j = i / DH, d = i % DH;
    const int kj = k0 + j;
    dst[j * Tile<DH>::kLd + d] =
        kj < k_end
            ? to_f(src[(((int64_t)b * a.Sk + kj) * a.KV + kvh) * DH + d])
            : 0.f;
  }
}

// s = q·kᵀ and, with kDp, dp = do·vᵀ over the 64 × 32 tile: rows
// tid / 8 + 32·ii and keys tid % 8 + 8·jj of a thread
template <int DH, bool kDp>
__device__ __forceinline__ void products(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         float (&s)[2][4], float (&dp)[2][4]) {
  constexpr int kLd = Tile<DH>::kLd;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
#pragma unroll
  for (int ii = 0; ii < 2; ++ii)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) s[ii][jj] = dp[ii][jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float aq[2], ad[2], bk[4], bv[4];
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
      aq[ii] = qs[(tr + 32 * ii) * kLd + d];
      if (kDp) ad[ii] = dos[(tr + 32 * ii) * kLd + d];
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      bk[jj] = ks[(tc + 8 * jj) * kLd + d];
      if (kDp) bv[jj] = vs[(tc + 8 * jj) * kLd + d];
    }
#pragma unroll
    for (int ii = 0; ii < 2; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[ii][jj] = fmaf(aq[ii], bk[jj], s[ii][jj]);
        if (kDp) dp[ii][jj] = fmaf(ad[ii], bv[jj], dp[ii][jj]);
      }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(Args a) {
  using Tl = Tile<DH>;
  constexpr int kLd = Tl::kLd;
  extern __shared__ float smem[];
  float* qs = smem;                         // [kRows][kLd] q / sqrt(dh)
  float* dos = qs + kRows * kLd;            // [kRows][kLd] do
  float* ks = dos + kRows * kLd;            // [kKeys][kLd]
  float* vs = ks + kKeys * kLd;             // [kKeys][kLd]
  float* ps = vs + kKeys * kLd;             // [kRows][kLdS] P
  float* dss = ps + kRows * kLdS;           // [kRows][kLdS] dS
  float* m_s = dss + kRows * kLdS;          // a row's max
  float* l_s = m_s + kRows;                 //         sum of exp
  float* d_s = l_s + kRows;                 //         rowsum(do∘o)

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  T* dq = static_cast<T*>(a.dq);
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
  const int tid = threadIdx.x;
  const int tr = tid / 8, tc = tid % 8;
  const int pr = tid / Tl::kTc, pc = tid % Tl::kTc;
  const int rows = a.bq * a.g;              // rows [rows, kRows) stay empty
  const int n_qt = (a.Sq + a.bq - 1) / a.bq;
  const int n_kt = (a.Sk + kKeys - 1) / kKeys;
  const int64_t n_a = (int64_t)n_qt * a.B * a.KV;
  const int64_t n_b = (int64_t)n_kt * a.B * a.KV;

  // ---- phase A: row statistics and dq, a query tile at a time
  for (int64_t item = blockIdx.x; item < n_a; item += gridDim.x) {
    const int qt = (int)(item % n_qt);
    const int bk = (int)(item / n_qt);
    const int b = bk / a.KV, kvh = bk % a.KV;
    const int q0 = qt * a.bq;
    __syncthreads();                        // the last item's tiles are read
    load_rows<T, DH>(qs, q, a, b, kvh, q0, rows, a.scale);
    load_rows<T, DH>(dos, dout, a, b, kvh, q0, rows, 1.f);
    __syncthreads();
    {                                       // D: four threads a row
      const int r = tid / 4, part = tid % 4;
      const int qi = q0 + r / a.g;
      float sum = 0.f;
      if (r < rows && qi < a.Sq) {
        const T* orow =
            o + (((int64_t)b * a.Sq + qi) * a.H + kvh * a.g + r % a.g) * DH;
        for (int d = part; d < DH; d += 4)
          sum = fmaf(dos[r * kLd + d], to_f(orow[d]), sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) d_s[r] = sum;
    }
    // the keys some row of the tile can see (K7's range)
    const int q_last = min(q0 + a.bq, a.Sq) - 1;
    int k_begin = 0, k_end = a.Sk;
    if (a.causal) k_end = min(a.Sk, a.q_offset + q_last + 1);
    if (a.window > 0) k_begin = max(0, a.q_offset + q0 - a.window + 1);

    // pass 1: each row's max and sum of exp, online over the key tiles
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
      __syncthreads();
      load_keys<T, DH>(ks, k, a, b, kvh, k0, k_end);
      __syncthreads();
      float s[2][4], unused[2][4];
      products<DH, false>(qs, dos, ks, vs, s, unused);
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r = tr + 32 * ii;
        const int qi = q0 + r / a.g;
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kpos = k0 + tc + 8 * jj;
          const bool ok = r < rows && qi < a.Sq && kpos < k_end &&
                          visible(a.q_offset + qi, kpos, a.causal, a.window);
          s[ii][jj] = ok ? s[ii][jj] : -INFINITY;
          mx = fmaxf(mx, s[ii][jj]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        const float m_new = fmaxf(m[ii], mx);
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sum += expf(s[ii][jj] - m_safe);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 4);
        const float corr = isfinite(m[ii]) ? expf(m[ii] - m_safe) : 0.f;
        l[ii] = corr * l[ii] + sum;
        m[ii] = m_new;
      }
    }
    if (tc == 0) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        m_s[tr + 32 * ii] = m[ii];
        l_s[tr + 32 * ii] = l[ii];
      }
    }
    __syncthreads();
    if (tid < kRows) {
      const int qi = q0 + tid / a.g;
      if (tid < rows && qi < a.Sq) {
        float* st = a.stats +
            (((int64_t)b * a.Sq + qi) * a.H + kvh * a.g + tid % a.g) * 3;
        st[0] = m_s[tid];
        st[1] = l_s[tid];
        st[2] = d_s[tid];
      }
    }

    // pass 2: P, dP and dS over the same tiles; dq += dS·k
    float acc[Tl::kRpt][Tl::kCpt];
#pragma unroll
    for (int rr = 0; rr < Tl::kRpt; ++rr)
#pragma unroll
      for (int cc = 0; cc < Tl::kCpt; ++cc) acc[rr][cc] = 0.f;
    for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
      __syncthreads();
      load_keys<T, DH>(ks, k, a, b, kvh, k0, k_end);
      load_keys<T, DH>(vs, v, a, b, kvh, k0, k_end);
      __syncthreads();
      float s[2][4], dp[2][4];
      products<DH, true>(qs, dos, ks, vs, s, dp);
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r = tr + 32 * ii;
        const int qi = q0 + r / a.g;
        const float m_safe = isfinite(m_s[r]) ? m_s[r] : 0.f;
        const float l_r = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kpos = k0 + tc + 8 * jj;
          const bool ok = r < rows && qi < a.Sq && kpos < k_end &&
                          visible(a.q_offset + qi, kpos, a.causal, a.window);
          const float p = ok ? expf(s[ii][jj] - m_safe) / l_r : 0.f;
          dss[r * kLdS + tc + 8 * jj] = p * (dp[ii][jj] - d_s[r]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kKeys; ++j) {
        float pp[Tl::kRpt], kk[Tl::kCpt];
#pragma unroll
        for (int rr = 0; rr < Tl::kRpt; ++rr)
          pp[rr] = dss[(pr + Tl::kTr * rr) * kLdS + j];
#pragma unroll
        for (int cc = 0; cc < Tl::kCpt; ++cc)
          kk[cc] = ks[j * kLd + pc + Tl::kTc * cc];
#pragma unroll
        for (int rr = 0; rr < Tl::kRpt; ++rr)
#pragma unroll
          for (int cc = 0; cc < Tl::kCpt; ++cc)
            acc[rr][cc] = fmaf(pp[rr], kk[cc], acc[rr][cc]);
      }
    }
#pragma unroll
    for (int rr = 0; rr < Tl::kRpt; ++rr) {
      const int r = pr + Tl::kTr * rr;
      const int qi = q0 + r / a.g;
      if (r >= rows || qi >= a.Sq) continue;
      T* dst = dq + (((int64_t)b * a.Sq + qi) * a.H + kvh * a.g + r % a.g)
                        * DH;
#pragma unroll
      for (int cc = 0; cc < Tl::kCpt; ++cc)
        store(dst + pc + Tl::kTc * cc, acc[rr][cc] * a.scale);
    }
  }

  cg::this_grid().sync();                   // every row's statistics are out

  // ---- phase B: dk and dv, a key tile of one KV head at a time
  for (int64_t item = blockIdx.x; item < n_b; item += gridDim.x) {
    const int kt = (int)(item % n_kt);
    const int bk = (int)(item / n_kt);
    const int b = bk / a.KV, kvh = bk % a.KV;
    const int k0 = kt * kKeys;
    const int k_end = min(k0 + kKeys, a.Sk);
    __syncthreads();
    load_keys<T, DH>(ks, k, a, b, kvh, k0, k_end);
    load_keys<T, DH>(vs, v, a, b, kvh, k0, k_end);
    // the query positions that see some key of the tile
    int qi_begin = 0, qi_end = a.Sq;
    if (a.causal) qi_begin = max(0, k0 - a.q_offset);
    if (a.window > 0)
      qi_end = min(a.Sq, max(0, k_end - 1 + a.window - a.q_offset));
    float acc_k[Tl::kKpt][Tl::kCpt], acc_v[Tl::kKpt][Tl::kCpt];
#pragma unroll
    for (int jj = 0; jj < Tl::kKpt; ++jj)
#pragma unroll
      for (int cc = 0; cc < Tl::kCpt; ++cc) acc_k[jj][cc] = acc_v[jj][cc] = 0.f;
    for (int q0 = qi_begin; q0 < qi_end; q0 += a.bq) {
      __syncthreads();
      load_rows<T, DH>(qs, q, a, b, kvh, q0, rows, a.scale);
      load_rows<T, DH>(dos, dout, a, b, kvh, q0, rows, 1.f);
      if (tid < kRows) {
        const int qi = q0 + tid / a.g;
        float mv = -INFINITY, lv = 0.f, dvv = 0.f;
        if (tid < rows && qi < a.Sq) {
          const float* st = a.stats +
              (((int64_t)b * a.Sq + qi) * a.H + kvh * a.g + tid % a.g) * 3;
          mv = st[0];
          lv = st[1];
          dvv = st[2];
        }
        m_s[tid] = mv;
        l_s[tid] = lv;
        d_s[tid] = dvv;
      }
      __syncthreads();
      float s[2][4], dp[2][4];
      products<DH, true>(qs, dos, ks, vs, s, dp);
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        const int r = tr + 32 * ii;
        const int qi = q0 + r / a.g;
        const float m_safe = isfinite(m_s[r]) ? m_s[r] : 0.f;
        const float l_r = fmaxf(l_s[r], 1e-30f);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int kpos = k0 + tc + 8 * jj;
          const bool ok = r < rows && qi < a.Sq && kpos < k_end &&
                          visible(a.q_offset + qi, kpos, a.causal, a.window);
          const float p = ok ? expf(s[ii][jj] - m_safe) / l_r : 0.f;
          ps[r * kLdS + tc + 8 * jj] = p;
          dss[r * kLdS + tc + 8 * jj] = p * (dp[ii][jj] - d_s[r]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        float pv[Tl::kKpt], sv[Tl::kKpt], dov[Tl::kCpt], qv[Tl::kCpt];
#pragma unroll
        for (int jj = 0; jj < Tl::kKpt; ++jj) {
          pv[jj] = ps[r * kLdS + pr + Tl::kTr * jj];
          sv[jj] = dss[r * kLdS + pr + Tl::kTr * jj];
        }
#pragma unroll
        for (int cc = 0; cc < Tl::kCpt; ++cc) {
          dov[cc] = dos[r * kLd + pc + Tl::kTc * cc];
          qv[cc] = qs[r * kLd + pc + Tl::kTc * cc];
        }
#pragma unroll
        for (int jj = 0; jj < Tl::kKpt; ++jj)
#pragma unroll
          for (int cc = 0; cc < Tl::kCpt; ++cc) {
            acc_v[jj][cc] = fmaf(pv[jj], dov[cc], acc_v[jj][cc]);
            acc_k[jj][cc] = fmaf(sv[jj], qv[cc], acc_k[jj][cc]);
          }
      }
    }
#pragma unroll
    for (int jj = 0; jj < Tl::kKpt; ++jj) {
      const int kpos = k0 + pr + Tl::kTr * jj;
      if (kpos >= k_end) continue;
      const int64_t at = (((int64_t)b * a.Sk + kpos) * a.KV + kvh) * DH;
#pragma unroll
      for (int cc = 0; cc < Tl::kCpt; ++cc) {
        store(dk + at + pc + Tl::kTc * cc, acc_k[jj][cc]);
        store(dv + at + pc + Tl::kTc * cc, acc_v[jj][cc]);
      }
    }
  }
}

// the co-resident blocks of one kernel, at most `want`
cudaError_t resident_blocks(const void* kern, size_t smem, int64_t want,
                            int device, int* blocks) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int64_t n = (int64_t)per_sm * sms;
  if (want < n) n = want;
  *blocks = n < 1 ? 1 : (int)n;
  return cudaSuccess;
}

// one cooperative launch on the co-resident blocks: the runtime refuses a
// grid that would not be co-resident, and the wrapper raises
template <typename T, int DH>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)Tile<DH>::kFloats;
  const void* kern = (const void*)flash_bwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t n_a = (int64_t)((a.Sq + a.bq - 1) / a.bq) * a.B * a.KV;
  const int64_t n_b = (int64_t)((a.Sk + kKeys - 1) / kKeys) * a.B * a.KV;
  int blocks = 0;
  err = resident_blocks(kern, smem, n_a > n_b ? n_a : n_b, device, &blocks);
  if (err != cudaSuccess) return err;
  Args local = a;
  void* params[] = {(void*)&local};
  err = cudaLaunchCooperativeKernel(kern, dim3((unsigned)blocks),
                                    dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(const Args& a, int dh, int device, cudaStream_t s) {
  switch (dh) {
    case 16: return launch<T, 16>(a, device, s);
    case 32: return launch<T, 32>(a, device, s);
    case 64: return launch<T, 64>(a, device, s);
    case 80: return launch<T, 80>(a, device, s);
    case 128: return launch<T, 128>(a, device, s);
    case 256: return launch<T, 256>(a, device, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0: no window. bf16 = 1: every tensor but `stats` is
// __nv_bfloat16, else float. stats is float scratch of B·Sq·H·3 entries.
// The wrapper has checked shapes, H % KV == 0, H / KV <= 64, dh and Sk > 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, int B,
    int Sq, int Sk, int H, int KV, int dh, int causal, int window,
    int q_offset, int bf16, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Sq == 0 || Sk == 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > kRows)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.stats = static_cast<float*>(stats);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.H = H;
  a.KV = KV;
  a.g = H / KV;
  a.bq = kRows / a.g;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_dh<__nv_bfloat16>(a, dh, device, s)
                    : launch_dh<float>(a, dh, device, s));
}
