// The launch floor of one CUDA card: microseconds per launch (CUDA events
// over 2,000 back-to-back launches) of near-empty kernels on an N=128-sized
// grid (5 x 17 blocks of 128 threads), with and without a thread-block
// cluster, 100 KB of dynamic shared memory and two cluster barriers, and
// of pairs of kernels whose shared-memory needs differ (the carveout
// switch between the SG stage kernel and the small SG kernels).
//
// Then the grid-wide barrier of a cooperative launch (cudaLaunchKernelEx
// with cudaLaunchAttributeCooperative): one launch of 256-thread blocks
// doing 48 cooperative_groups::this_grid().sync() calls (the 3 x 16
// dependent phases of one FV BiCGSTAB solve at K=16), at 64, 192 and 512
// blocks (the 16x16 tiles of 128x128 cells for 1, 3 and 8 lanes); its time
// less that of the same launch with no sync, over 48, is the cost of one
// sync. Two variants do between syncs the in-block work that starts each
// FV BiCGSTAB phase: "tree" the 2-4 fixed-order reductions of a partial
// table column over 256 shared-memory slots (9 __syncthreads each) and the
// 2-4 per-block partials the phase writes (the FV kernels' separate
// reductions before the one-pass form), "fused" the same sums with every
// column in one pass (a warp a column, the last five tree levels as
// __shfl_down_sync; csrc/fv_phases.cuh: warp_col_sum, col_tree).
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

constexpr int NT = 256;  // threads of a cooperative block

// One column of a (nb, ncol) table summed by the 256-slot tree, and a
// block's value summed by it (the FV kernels' separate reductions).
__device__ float tree_sum(float v, float* sh) {
  const int tid = threadIdx.x;
  sh[tid] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

__device__ float tree_col(const float* part, int ncol, int col, int nb,
                          float* sh) {
  float acc = 0.f;
  for (int b = threadIdx.x; b < nb; b += NT) acc += part[b * ncol + col];
  return tree_sum(acc, sh);
}

// Columns [0, ncol) of a (nb, ncol) table (ncol <= 8) in one pass, warp c
// summing column c over the same pairs as the tree; the sums land in
// out[0, ncol) of shared memory.
__device__ void fused_cols(const float* part, int ncol, int nb, float* out) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  if (w < ncol) {
    float a[8];
    for (int j = 0; j < 8; ++j) {
      a[j] = 0.f;
      for (int b = l + 32 * j; b < nb; b += NT) a[j] += part[b * ncol + w];
    }
    float v = ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]));
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
    if (l == 0) out[w] = v;
  }
  __syncthreads();
}

// Values v[0, ncol) of every thread summed per column in one pass into
// part[tile * 4 + c].
__device__ void fused_partials(const float* v, int ncol, float* sh,
                               float* part, int tile) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  for (int c = 0; c < ncol; ++c) sh[c * NT + threadIdx.x] = v[c];
  __syncthreads();
  if (w < ncol) {
    const float* col = sh + w * NT + l;
    float x = ((col[0] + col[128]) + (col[64] + col[192])) +
              ((col[32] + col[160]) + (col[96] + col[224]));
    for (int s = 16; s > 0; s >>= 1) x += __shfl_down_sync(0xffffffffu, x, s);
    if (l == 0) part[tile * 4 + w] = x;
  }
  __syncthreads();
}

// mode 0: syncs only; 1: tree reductions between syncs; 2: fused ones.
// Phase q % 3 reduces 4, 2, 4 columns and writes 2, 4, 4 partials (the
// FV BiCGSTAB direction, stabilize and update phases); a lane is 64
// blocks, and a block reduces its lane's (64, 4) table.
__global__ void __launch_bounds__(NT)
k_grid_sync(int nsync, int mode, float* part, float* out) {
  __shared__ float sh[4 * NT];
  __shared__ float sums[8];
  cg::grid_group grid = cg::this_grid();
  constexpr int nb = 64;
  const int lane = blockIdx.x / nb, tile = blockIdx.x % nb;
  float acc = 0.f;
  for (int q = 0; q < nsync; ++q) {
    const int nred = q % 3 == 1 ? 2 : 4, npart = q % 3 == 0 ? 2 : 4;
    const float* src = part + (q % 2) * 4 * 1024 + lane * nb * 4;
    float* dst = part + ((q + 1) % 2) * 4 * 1024 + lane * nb * 4;
    if (mode == 1) {
      for (int c = 0; c < nred; ++c) acc += tree_col(src, 4, c, nb, sh);
      for (int c = 0; c < npart; ++c) {
        const float r = tree_sum(acc * (threadIdx.x + c), sh);
        if (threadIdx.x == 0) dst[tile * 4 + c] = r;
      }
    } else if (mode == 2) {
      fused_cols(src, nred, nb, sums);
      for (int c = 0; c < nred; ++c) acc += sums[c];
      float v[4];
      for (int c = 0; c < 4; ++c) v[c] = acc * (threadIdx.x + c);
      fused_partials(v, npart, sh, dst, tile);
    }
    grid.sync();
  }
  if (threadIdx.x == 0 && out) out[blockIdx.x] = acc;
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
  int coop = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, 0);
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_grid_sync, NT, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  printf("cooperative launch %d, co-resident blocks of %d threads: %d x %d "
         "SMs\n", coop, NT, per_sm, sms);
  float* part;
  cudaMalloc(&part, 2 * 4 * 1024 * sizeof(float));
  cudaMemset(part, 0, 2 * 4 * 1024 * sizeof(float));
  auto coop_launch = [&](int blocks, int nsync, int mode) {
    cudaLaunchConfig_t c = {};
    c.gridDim = dim3(blocks);
    c.blockDim = dim3(NT);
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeCooperative;
    at[0].val.cooperative = 1;
    c.attrs = at;
    c.numAttrs = 1;
    cudaLaunchKernelEx(&c, k_grid_sync, nsync, mode, part, out);
  };
  const char* names[3] = {"syncs only", "tree reductions", "fused reductions"};
  for (int blocks : {64, 192, 512}) {
    for (int mode = 0; mode < 3; ++mode) {
      const float t0 = time_us([&] { coop_launch(blocks, 0, mode); }, 500);
      const float t48 = time_us([&] { coop_launch(blocks, 48, mode); }, 500);
      printf("cooperative %3d blocks, %-16s: 48 syncs %.2f us, none %.2f "
             "us, %.3f us a sync\n",
             blocks, names[mode], t48, t0, (t48 - t0) / 48.f);
    }
  }
  const cudaError_t err = cudaGetLastError();
  printf("%s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
