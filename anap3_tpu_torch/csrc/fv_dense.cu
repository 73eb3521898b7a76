// fv_dense: the dense products of the tensor-product pressure solve,
// C = op(A) op(B) with fused epilogues.
//
// Replaces: psolve and the refinement products of the body _make_iterate of
//   anap3_tpu/ops/pallas_fv.py (make_pallas_fv_step,
//   make_pallas_fv_chunk_runner), _mm at HIGHEST precision:
//   p' = V1 ((V1^T f V2) * inv_lam) V2^T, plus one refinement solve in
//   float32. V1 = P.Vx is the y eigenbasis (ny, ny), applied from the left
//   to (ny, nx) fields, V2 = P.Vy the x eigenbasis (nx, nx), inv_lam
//   (ny, nx).
//
// Bound on the card: latency. At N=128 a product is 2 x 128^3 = 4.2 MFLOP
//   (about 0.06 us at the card's float32 FMA rate) on 64 KB operands that
//   sit in L2; four to eight dependent products per SIMPLE iteration cost
//   their launches and one pass of shared-memory tiles each.
// Design: a 16 x 16 output tile per block with 16 x 16 shared-memory
//   k-tiles, exact FMA in the working type (no TF32, no tensor cores),
//   summed over k in ascending order; both extents and the depth are masked
//   on the ragged edge, so every N and nx != ny work. The first product of
//   a solve subtracts the mean of its right-hand side on load (the mean is
//   the fixed-order reduction of the previous launch's partials, as in every
//   FV kernel), the second multiplies by inv_lam in its epilogue, and the
//   last accumulates into p' for the refinement step.
#include "fv_common.cuh"

namespace fv {
namespace {

template <typename T>
__global__ void __launch_bounds__(NT)
dense_kernel(int M, int N, int K, const T* __restrict__ A, int transA,
             const T* __restrict__ B, int transB, const T* mean_part, int nb,
             int n_total, const T* __restrict__ scale, int accumulate, T* C) {
  __shared__ T As[TILE][TILE + 1];
  __shared__ T Bs[TILE][TILE + 1];
  __shared__ T red[NT];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE + tx;
  const int row = blockIdx.y * TILE + ty;
  const int col = blockIdx.x * TILE + tx;
  T mean = 0;
  if (mean_part != nullptr)
    mean = reduce_col(mean_part, 1, 0, nb, red, tid, NT) / T(n_total);
  T acc = 0;
  for (int k0 = 0; k0 < K; k0 += TILE) {
    const int ka = k0 + tx, kb = k0 + ty;
    T a = 0, b = 0;
    if (row < M && ka < K)
      a = transA ? A[(size_t)ka * M + row] : A[(size_t)row * K + ka];
    if (kb < K && col < N) {
      b = transB ? B[(size_t)col * K + kb] : B[(size_t)kb * N + col];
      b -= mean;
    }
    As[ty][tx] = a;
    Bs[ty][tx] = b;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; ++kk) acc = fma(As[ty][kk], Bs[kk][tx], acc);
    __syncthreads();
  }
  if (row < M && col < N) {
    const size_t o = (size_t)row * N + col;
    if (scale != nullptr) acc *= scale[o];
    if (accumulate) acc = C[o] + acc;
    C[o] = acc;
  }
}

}  // namespace

template <typename T>
cudaError_t launch_dense(int M, int N, int K, const T* A, int transA,
                         const T* B, int transB, const T* mean_part, int nb,
                         int n_total, const T* scale, int accumulate, T* C,
                         cudaStream_t s) {
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  dense_kernel<T><<<grid, dim3(TILE, TILE), 0, s>>>(
      M, N, K, A, transA, B, transB, mean_part, nb, n_total, scale,
      accumulate, C);
  return cudaGetLastError();
}

#define FV_INSTANTIATE(T)                                                    \
  template cudaError_t launch_dense<T>(int, int, int, const T*, int,         \
                                       const T*, int, const T*, int, int,    \
                                       const T*, int, T*, cudaStream_t);
FV_INSTANTIATE(float)
FV_INSTANTIATE(double)
#undef FV_INSTANTIATE

}  // namespace fv
