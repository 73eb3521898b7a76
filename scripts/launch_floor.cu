// The launch floor of one CUDA card: microseconds per launch (CUDA events
// over 2,000 back-to-back launches) of near-empty kernels on an N=128-sized
// grid (5 x 17 blocks of 128 threads), with and without a thread-block
// cluster, 100 KB of dynamic shared memory and two cluster barriers, and
// of pairs of kernels whose shared-memory needs differ (the carveout
// switch between the SG stage kernel and the small SG kernels).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//       -o build/launch_floor scripts/launch_floor.cu && build/launch_floor
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace cg = cooperative_groups;

__global__ void k_plain(float* out) {
  if (threadIdx.x == 0 && out) out[blockIdx.x] = 1.f;
}

__global__ void k_smem(float* out) {
  extern __shared__ float sm[];
  sm[threadIdx.x] = threadIdx.x;
  __syncthreads();
  if (threadIdx.x == 0 && out) out[blockIdx.x] = sm[5];
}

__global__ void k_cluster_sync(float* out) {
  extern __shared__ float sm[];
  cg::cluster_group cl = cg::this_cluster();
  sm[threadIdx.x] = threadIdx.x;
  cl.sync();
  const float v = cl.map_shared_rank(
      sm, (cl.block_rank() + 1) % cl.num_blocks())[threadIdx.x];
  cl.sync();
  if (threadIdx.x == 0 && out) out[blockIdx.x] = v;
}

template <typename F>
float time_us(F launch, int reps = 2000) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 50; ++i) launch();
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int i = 0; i < reps; ++i) launch();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms * 1000.f / reps;
}

int main() {
  float* out;
  cudaMalloc(&out, 1 << 20);
  const int smem = 100 * 1024;
  cudaFuncSetAttribute(k_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       232448);
  cudaFuncSetAttribute(k_cluster_sync,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  const dim3 grid(5, 17), block(128);
  auto ex = [&](void (*k)(float*), int cluster, int bytes) {
    cudaLaunchConfig_t c = {};
    c.gridDim = grid;
    c.blockDim = block;
    c.dynamicSmemBytes = bytes;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cluster;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    c.attrs = at;
    c.numAttrs = 1;
    cudaLaunchKernelEx(&c, k, out);
  };
  printf("plain <<<>>>                  %.2f us\n",
         time_us([&] { k_plain<<<grid, block>>>(out); }));
  printf("plain, cluster 1              %.2f us\n",
         time_us([&] { ex(k_plain, 1, 0); }));
  printf("plain, cluster 5              %.2f us\n",
         time_us([&] { ex(k_plain, 5, 0); }));
  printf("100 KB shared <<<>>>          %.2f us\n",
         time_us([&] { k_smem<<<grid, block, smem>>>(out); }));
  printf("100 KB shared, cluster 5      %.2f us\n",
         time_us([&] { ex(k_smem, 5, smem); }));
  printf("2 cluster barriers, 100 KB    %.2f us\n",
         time_us([&] { ex(k_cluster_sync, 5, smem); }));
  printf("pair plain + 100 KB shared    %.2f us\n", time_us([&] {
           k_plain<<<grid, block>>>(out);
           k_smem<<<grid, block, smem>>>(out);
         }));
  printf("pair plain + plain            %.2f us\n", time_us([&] {
           k_plain<<<grid, block>>>(out);
           k_plain<<<grid, block>>>(out);
         }));
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
