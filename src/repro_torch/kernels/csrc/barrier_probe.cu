// A probe of the two barriers the superstep kernels are built on, for
// measurement only: one grid.sync() across a cooperative grid (K4's
// barrier, twice a round: after the delivery over the feed rows and after
// the sweep, with none added when the sweep's walk changes, plus one after
// its set-up) and one hardware cluster barrier
// (K3's, once a sweep, plus one when a dense sweep hands over to a work
// list). Each kernel runs `iters` barriers back to back;
// thread 0 of block 0 reads the global timer around them and writes the
// elapsed nanoseconds. No path of the port launches it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void grid_sync_probe(int iters, unsigned long long* ns) {
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  const unsigned long long t0 = now_ns();
  for (int i = 0; i < iters; ++i) grid.sync();
  const unsigned long long t1 = now_ns();
  if (blockIdx.x == 0 && threadIdx.x == 0) *ns = t1 - t0;
}

__global__ void __launch_bounds__(1024, 1)
    cluster_sync_probe(int iters, unsigned long long* ns) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const unsigned long long t0 = now_ns();
  for (int i = 0; i < iters; ++i) cluster.sync();
  const unsigned long long t1 = now_ns();
  if (blockIdx.x == 0 && threadIdx.x == 0) *ns = t1 - t0;
}

}  // namespace

// cluster_blocks 0: grid_sync_probe as one cooperative launch of `blocks`
// blocks of `threads`; else cluster_sync_probe in clusters of
// `cluster_blocks` blocks of 1024 threads (`blocks` in all)
extern "C" int barrier_probe_launch(int cluster_blocks, int blocks,
                                    int threads, int iters, void* ns,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* out = (unsigned long long*)ns;
  if (cluster_blocks == 0) {
    void* params[] = {(void*)&iters, (void*)&out};
    err = cudaLaunchCooperativeKernel((void*)grid_sync_probe,
                                      dim3((unsigned)blocks),
                                      dim3((unsigned)threads), params, 0, s);
  } else {
    err = cudaFuncSetAttribute((void*)cluster_sync_probe,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster_blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(1024);
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, cluster_sync_probe, iters, out);
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
