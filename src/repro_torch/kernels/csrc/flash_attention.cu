// K7: forward attention with an online softmax — causal or sliding-window,
// grouped query heads (GQA), queries at absolute positions q_offset + i.
//
// Replaces: the JAX package's Pallas kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py, body `_flash_kernel`), which every
// attention layer of a prefill or forward reaches on a TPU. This SIMT
// kernel takes float32 inputs, and bf16 at dh 16 and 32 (the reduced
// configs); bf16 at dh 64, 80, 128 and 256 goes to the tensor-core kernel
// in flash_attention_sm90.cu.
//
// Contract (kernels/flash_attention.py `flash_attention_ref`): q (B, Sq, H,
// dh), k and v (B, Sk, KV, dh), H = g·KV; query head h reads KV head h / g.
// Key j is visible to query i when j < Sk, j <= q_offset + i (causal) and
// q_offset + i - j < window (window > 0). Every product and sum is float32,
// p·V included (the TPU kernel's numerics, not a bf16 p); q is scaled by
// 1/sqrt(dh) as it is loaded; the output is acc / max(l, 1e-30) in q's
// dtype, so a row with no visible key is 0.
//
// What bounds it on an H100: operations. At llama3-8b's prefill (B 4, Sq =
// Sk = 2048, H 32, KV 8, dh 128, causal) a layer does 4·B·H·dh·Sq·Sk/2 =
// 1.4e11 FLOP against reading q, k, v and writing o once (168 MB in bf16):
// ~820 FLOP a byte, above the card's ~295 bf16 tensor-core FLOP a byte.
//
// What the design does about it, as a first simple kernel: one block per
// (q tile, batch, KV head) covering the whole query group, so K and V are
// staged once in shared memory for g query heads. A block holds 64 rows
// (query position × head of the group, 64 / g positions), walks its keys
// in tiles of 64 and keeps the running max, sum and per-row accumulator:
// the scores by a 4×4 register tile a thread, the softmax by four threads a
// row, p·V by a register tile whose columns run across a warp. Tiles that
// the causal mask or the window hide in full are never loaded. All of it
// runs on the CUDA cores in float32 (67 TFLOP/s peak), not on the tensor
// cores: that is what float32 inputs ask for.
//
// Shared memory: the q tile and one K-or-V tile at a padded row stride of
// dh + 1 floats, the 64×65 score tile and three row vectors: 83 KB at dh
// 128 and 149 KB at dh 256 (gemma3), so the launch raises the block's
// dynamic shared memory limit with cudaFuncSetAttribute.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // query rows a block: position × head of the group
constexpr int kKeys = 64;   // keys a tile
constexpr int kLdS = kKeys + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int H, int KV, int g,
             int bq, int causal, int window, int q_offset, float scale) {
  constexpr int kLd = DH + 1;               // padded: no bank conflicts
  // p·V: threads across columns (16 where 32 does not divide dh, as 80)
  constexpr int kTc = DH < 32 ? DH : (DH % 32 ? 16 : 32);
  constexpr int kTr = kThreads / kTc;       //      and across rows
  constexpr int kRpt = kRows / kTr;         // rows a thread
  constexpr int kCpt = DH / kTc;            // columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                         // [kRows][kLd]
  float* kv = qs + kRows * kLd;             // [kKeys][kLd]: K, then V
  float* ss = kv + kKeys * kLd;             // [kRows][kLdS]: s, then p
  float* m_s = ss + kRows * kLdS;           // running max a row
  float* l_s = m_s + kRows;                 // running sum a row
  float* c_s = l_s + kRows;                 // this tile's correction a row

  const int tid = threadIdx.x;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const int q0 = blockIdx.x * bq;
  const int rows = bq * g;                  // rows [rows, kRows) stay empty

  // row r is query q0 + r / g at head kvh·g + r % g: the g heads of one
  // position lie next to each other in (B, Sq, H, dh)
  for (int i = tid; i < kRows * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int qi = q0 + r / g;
    float val = 0.f;
    if (r < rows && qi < Sq)
      val = to_f(q[(((int64_t)b * Sq + qi) * H + kvh * g + r % g) * DH + d])
            * scale;
    qs[r * kLd + d] = val;
  }
  if (tid < kRows) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // the keys some row of the tile can see
  const int q_last = min(q0 + bq, Sq) - 1;
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q_offset + q_last + 1);
  if (window > 0) k_begin = max(0, q_offset + q0 - window + 1);

  const int pr = tid / kTc, pc = tid % kTc;
  float acc[kRpt][kCpt];
#pragma unroll
  for (int rr = 0; rr < kRpt; ++rr)
#pragma unroll
    for (int cc = 0; cc < kCpt; ++cc) acc[rr][cc] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kKeys) {
    __syncthreads();                        // the last tile's V and p are read
    for (int i = tid; i < kKeys * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      const int kj = k0 + j;
      kv[j * kLd + d] =
          kj < k_end ? to_f(k[(((int64_t)b * Sk + kj) * KV + kvh) * DH + d])
                     : 0.f;
    }
    __syncthreads();

    // s = q·k: rows tr + 16·ii and keys tc + 16·jj of a thread
    {
      const int tr = tid / 16, tc = tid % 16;
      float s[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float a[4], bb[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) a[ii] = qs[(tr + 16 * ii) * kLd + d];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bb[jj] = kv[(tc + 16 * jj) * kLd + d];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            s[ii][jj] = fmaf(a[ii], bb[jj], s[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = tr + 16 * ii;
        const int qi = q0 + r / g;
        const int qpos = q_offset + qi;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = tc + 16 * jj;
          const int kpos = k0 + j;
          bool ok = r < rows && qi < Sq && kpos < k_end;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && qpos - kpos < window;
          ss[r * kLdS + j] = ok ? s[ii][jj] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // V replaces K; meanwhile the online softmax, four threads a row
    for (int i = tid; i < kKeys * DH; i += kThreads) {
      const int j = i / DH, d = i % DH;
      const int kj = k0 + j;
      kv[j * kLd + d] =
          kj < k_end ? to_f(v[(((int64_t)b * Sk + kj) * KV + kvh) * DH + d])
                     : 0.f;
    }
    {
      const int r = tid / 4, part = tid % 4;
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kKeys / 4; ++jj)
        mx = fmaxf(mx, ss[r * kLdS + part + 4 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kKeys / 4; ++jj) {
        const int j = part + 4 * jj;
        const float p = expf(ss[r * kLdS + j] - m_safe);  // masked: exp(-inf)
        ss[r * kLdS + j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = isfinite(m_old) ? expf(m_old - m_safe) : 0.f;
        c_s[r] = corr;
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = corr·acc + p·V: rows pr + kTr·rr, columns pc + kTc·cc
    {
      float corr[kRpt];
#pragma unroll
      for (int rr = 0; rr < kRpt; ++rr) corr[rr] = c_s[pr + kTr * rr];
#pragma unroll
      for (int rr = 0; rr < kRpt; ++rr)
#pragma unroll
        for (int cc = 0; cc < kCpt; ++cc) acc[rr][cc] *= corr[rr];
#pragma unroll 4
      for (int j = 0; j < kKeys; ++j) {
        float pp[kRpt], vv[kCpt];
#pragma unroll
        for (int rr = 0; rr < kRpt; ++rr)
          pp[rr] = ss[(pr + kTr * rr) * kLdS + j];
#pragma unroll
        for (int cc = 0; cc < kCpt; ++cc) vv[cc] = kv[j * kLd + pc + kTc * cc];
#pragma unroll
        for (int rr = 0; rr < kRpt; ++rr)
#pragma unroll
          for (int cc = 0; cc < kCpt; ++cc)
            acc[rr][cc] = fmaf(pp[rr], vv[cc], acc[rr][cc]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int rr = 0; rr < kRpt; ++rr) {
    const int r = pr + kTr * rr;
    const int qi = q0 + r / g;
    if (r >= rows || qi >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* dst = o + (((int64_t)b * Sq + qi) * H + kvh * g + r % g) * DH;
#pragma unroll
    for (int cc = 0; cc < kCpt; ++cc) store(dst + pc + kTc * cc, acc[rr][cc] / l);
  }
  // each row's log-sum-exp of the scaled scores when asked (the backward's
  // input): m + log(l), +inf on a row with no visible key
  if (lse != nullptr && tid < rows) {
    const int qi = q0 + tid / g;
    if (qi < Sq)
      lse[((int64_t)b * H + kvh * g + tid % g) * Sq + qi] =
          m_s[tid] == -INFINITY ? INFINITY : m_s[tid] + logf(l_s[tid]);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  const int g = H / KV;
  const int bq = kRows / g;
  const size_t smem =
      sizeof(float) * ((size_t)(kRows + kKeys) * (DH + 1) + kRows * kLdS +
                       3 * kRows);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + bq - 1) / bq, B * KV);
  flash_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Sk, H, KV, g,
      bq, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int Sq, int Sk, int H, int KV, int dh,
              int causal, int window, int q_offset, float scale,
              cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal,
                           window, q_offset, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal,
                           window, q_offset, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal,
                           window, q_offset, scale, stream);
    case 80:
      return launch<T, 80>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal,
                           window, q_offset, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal,
                            window, q_offset, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal,
                            window, q_offset, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0: no window. bf16 = 1: q, k, v and o are __nv_bfloat16, else
// float. lse: NULL, or float32 (B, H, Sq) for each row's log-sum-exp. The
// wrapper has checked shapes, H % KV == 0, H / KV <= 64 and dh.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Sq, int Sk, int H, int KV,
                                      int dh, int causal, int window,
                                      int q_offset, int bf16, float scale,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > kRows)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float* const f = static_cast<float*>(lse);
  return bf16 ? launch_dh<__nv_bfloat16>(q, k, v, o, f, B, Sq, Sk, H, KV, dh,
                                         causal, window, q_offset, scale, s)
              : launch_dh<float>(q, k, v, o, f, B, Sq, Sk, H, KV, dh, causal,
                                 window, q_offset, scale, s);
}
