// K1: ELL semiring SpMV, y[v] = ⊕_j x[nbr[v,j]] ⊗ wgt[v,j], and K2, the
// same sweep masked by a frontier.
//
// K1 replaces: the JAX package's Pallas kernel `semiring_spmv_pallas`
// (src/repro/kernels/semiring_spmv.py, body `_spmv_kernel`).
// Semirings: min_plus (SSSP), max_first (CC, MaxVertex; ⊗ ignores wgt),
// plus_times (PageRank's pull). A PAD (-1) lane gives the ⊕-identity, so an
// all-PAD row gives +inf / -inf / 0.
//
// What bounds it on an H100: memory. Each row reads D int32 indices and D
// float32 weights once and writes one float32, so the least time is
// (V·D·8 + V·8) bytes over 3.35 TB/s; the gathered x (V·4 bytes) is read
// through L2, which holds it at the main path's size (8 MB of 50 MB).
//
// What the design does about it: one thread per row, lanes 0..D-1 in order,
// no shared memory and no atomics, so the kernel is as simple as the
// Pallas one and every load is read-only (`__ldg`). The TPU kernel kept x
// resident in VMEM; here L2 plays that part. plus_times multiplies and adds
// with `__fmul_rn`/`__fadd_rn` so nvcc cannot contract them into an FMA;
// the lane order still differs from the plain version's reduction, which
// is why plus_times is held to allclose and min/max to bit equality.
//
// K2 replaces: `semiring_spmv_frontier_pallas` (same file, body
// `_spmv_frontier_kernel`), the masked sweep of every staged sub-graph
// superstep. min_plus and max_first only. A row none of whose valid lanes
// has its neighbour in the frontier gives the identity and row_active = 0
// without gathering x; any other row reduces exactly like K1, so y and
// row_active are bit-identical to `semiring_spmv_frontier_ref`.
//
// What bounds it: memory. It reads nbr (V·D·4 bytes) and the frontier (one
// byte a vertex, tested as a byte: a torch.bool is one uint8), writes y and
// row_active (5 bytes a row); active rows also gather x, and min_plus
// reads their weights. The gathers hit L2.
//
// What the design does about it: K1's shape, one thread per row. The
// frontier test walks the lanes until the first active neighbour, so an
// inactive row costs its index loads and its frontier bytes only. The
// TPU kernel skipped whole 256-row blocks; a thread skips its own row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPad = -1;
constexpr int kThreads = 256;
enum Semiring { kMinPlus = 0, kMaxFirst = 1, kPlusTimes = 2 };

template <int SR>
__global__ void __launch_bounds__(kThreads)
spmv_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
            const float* __restrict__ wgt, float* __restrict__ y, int rows,
            int d) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int* nr = nbr + row * d;
  const float* wr = wgt + row * d;
  float acc = SR == kMinPlus ? INFINITY : (SR == kMaxFirst ? -INFINITY : 0.0f);
  for (int j = 0; j < d; ++j) {
    const int s = __ldg(nr + j);
    if (s == kPad) continue;
    const float g = __ldg(x + s);
    if (SR == kMinPlus) {
      const float t = __fadd_rn(g, __ldg(wr + j));
      acc = t < acc ? t : acc;
    } else if (SR == kMaxFirst) {
      acc = g > acc ? g : acc;
    } else {
      acc = __fadd_rn(acc, __fmul_rn(g, __ldg(wr + j)));
    }
  }
  y[row] = acc;
}

template <int SR>
__global__ void __launch_bounds__(kThreads)
spmv_frontier_kernel(const float* __restrict__ x,
                     const uint8_t* __restrict__ frontier,
                     const int* __restrict__ nbr, const float* __restrict__ wgt,
                     float* __restrict__ y, uint8_t* __restrict__ row_active,
                     int rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const int* nr = nbr + row * d;
  const float ident = SR == kMinPlus ? INFINITY : -INFINITY;
  bool active = false;
  for (int j = 0; j < d && !active; ++j) {
    const int s = __ldg(nr + j);
    active = s != kPad && __ldg(frontier + s) != 0;
  }
  row_active[row] = active ? 1 : 0;
  if (!active) {
    y[row] = ident;
    return;
  }
  const float* wr = wgt + row * d;
  float acc = ident;
  for (int j = 0; j < d; ++j) {
    const int s = __ldg(nr + j);
    if (s == kPad) continue;
    const float g = __ldg(x + s);
    if (SR == kMinPlus) {
      const float t = __fadd_rn(g, __ldg(wr + j));
      acc = t < acc ? t : acc;
    } else {
      acc = g > acc ? g : acc;
    }
  }
  y[row] = acc;
}

}  // namespace

extern "C" int semiring_spmv_frontier_launch(
    const void* x, const void* frontier, const void* nbr, const void* wgt,
    void* y, void* row_active, int rows, int d, int semiring, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const int blocks = (rows + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const uint8_t* ff = (const uint8_t*)frontier;
  const int* ni = (const int*)nbr;
  const float* wf = (const float*)wgt;
  float* yf = (float*)y;
  uint8_t* af = (uint8_t*)row_active;
  switch (semiring) {
    case kMinPlus:
      spmv_frontier_kernel<kMinPlus><<<blocks, kThreads, 0, s>>>(
          xf, ff, ni, wf, yf, af, rows, d);
      break;
    case kMaxFirst:
      spmv_frontier_kernel<kMaxFirst><<<blocks, kThreads, 0, s>>>(
          xf, ff, ni, wf, yf, af, rows, d);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int semiring_spmv_launch(const void* x, const void* nbr,
                                    const void* wgt, void* y, int rows, int d,
                                    int semiring, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows == 0) return 0;
  const int blocks = (rows + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  const int* ni = (const int*)nbr;
  const float* wf = (const float*)wgt;
  float* yf = (float*)y;
  switch (semiring) {
    case kMinPlus:
      spmv_kernel<kMinPlus><<<blocks, kThreads, 0, s>>>(xf, ni, wf, yf, rows, d);
      break;
    case kMaxFirst:
      spmv_kernel<kMaxFirst><<<blocks, kThreads, 0, s>>>(xf, ni, wf, yf, rows, d);
      break;
    case kPlusTimes:
      spmv_kernel<kPlusTimes><<<blocks, kThreads, 0, s>>>(xf, ni, wf, yf, rows, d);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
