// sg_stage: one low-storage RK stage of the PN-PN-2 artificial-compressibility
// step (anap3_tpu/models/spectral_sg.py: residuals + the stage update of
// sg_step, with the masked BC select).
//
// Replaces: the stage body that the Pallas kernels run four times per step,
//   anap3_tpu/ops/pallas_tiled.py make_tiled_sg_step (_stage_machinery) and
//   make_tiled_chunk_runner, and anap3_tpu/ops/pallas_aligned.py
//   make_aligned_chunk_runner (run_stage). The bordered core, the 32-padding,
//   the stacked operators and the bf16 hi/lo splits of those kernels are TPU
//   layout devices and are not carried over: this kernel works on the
//   unpadded (N+1)^2 velocity and (N-1)^2 pressure grids in exact FMA
//   arithmetic of the working type.
//
// Bound on the card: at N <= 320 every operand fits in the 50 MB L2 and one
//   stage is twelve small dense products, a few tens of MFLOP. A launch
//   fills 81 (N=128) to 441 (N=320) 256-thread blocks, a few waves over 132
//   SMs at most, so launch latency and wave quantization bound it, not HBM
//   bandwidth or FLOPs.
// Design: the Pallas "left phase / row phase" split becomes two launches.
//   stage_left computes the six products whose right operand is the state
//   (Dx u, Dxx u, Dx v, Dxx v, Gx p, Ix p) into scratch, one product per
//   grid z-slice. stage_row computes, per 16x16 output tile, the six right
//   products (u DyT, u DyyT, v DyT, v DyyT, (Gx p) IyT, (Ix p) GyT) from
//   shared-memory tiles and finishes the residuals, the RK update with dt
//   read from a device scalar (no host sync) and the BC select in its
//   epilogue. On the last stage each block also writes its partial sums of
//   R_u^2, R_v^2, R_p^2, |u-u0|^2 and |v-v0|^2; sg_control reduces them in
//   a second pass without atomics, so a run is reproducible bit for bit.
//   Ragged tile edges of both extents (nf and ni) are masked.
#include "sg_common.cuh"

namespace sg {
namespace {

template <typename T>
__global__ void stage_left(Ops<T> o, StageArgs<T> a, int nf) {
  const int ni = nf - 2;
  const size_t nn = (size_t)nf * nf;
  const T* A;
  const T* B;
  T* C;
  int K;
  switch (blockIdx.z) {
    case 0: A = o.Dx; B = a.u_in; C = a.left; K = nf; break;
    case 1: A = o.Dxx; B = a.u_in; C = a.left + nn; K = nf; break;
    case 2: A = o.Dx; B = a.v_in; C = a.left + 2 * nn; K = nf; break;
    case 3: A = o.Dxx; B = a.v_in; C = a.left + 3 * nn; K = nf; break;
    case 4: A = o.Gx; B = a.p_in; C = a.left + 4 * nn; K = ni; break;
    default:
      A = o.Ix; B = a.p_in; C = a.left + 4 * nn + (size_t)nf * ni; K = ni;
      break;
  }
  const int ncol = K;  // (nf, nf) products of u, v; (nf, ni) products of p
  if ((int)blockIdx.x * TILE >= ncol) return;  // uniform: p is narrower
  __shared__ T As[TILE][TILE];
  __shared__ T Bs[TILE][TILE];
  const int row = blockIdx.y * TILE + threadIdx.y;
  const int col = blockIdx.x * TILE + threadIdx.x;
  T acc = T(0);
  for (int k0 = 0; k0 < K; k0 += TILE) {
    load_tiles(A, K, nf, B, ncol, ncol, K, k0, row, col, As, Bs);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; ++kk)
      acc += As[threadIdx.y][kk] * Bs[kk][threadIdx.x];
    __syncthreads();
  }
  if (row < nf && col < ncol) C[(size_t)row * ncol + col] = acc;
}

template <typename T>
__global__ void stage_row(Ops<T> o, StageArgs<T> a, int nf) {
  const int ni = nf - 2;
  const size_t nn = (size_t)nf * nf;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.y * TILE + ty;
  const int j = blockIdx.x * TILE + tx;
  __shared__ T S1[TILE][TILE], S2[TILE][TILE];
  __shared__ T O1[TILE][TILE], O2[TILE][TILE];
  __shared__ T red[TILE * TILE];

  // u DyT, u DyyT, v DyT, v DyyT (contraction over nf)
  T u_dy = 0, u_dyy = 0, v_dy = 0, v_dyy = 0;
  for (int k0 = 0; k0 < nf; k0 += TILE) {
    load_tiles(a.u_in, nf, nf, o.DyT, nf, nf, nf, k0, i, j, S1, O1);
    load_tiles(a.v_in, nf, nf, o.DyyT, nf, nf, nf, k0, i, j, S2, O2);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; ++kk) {
      const T uk = S1[ty][kk], vk = S2[ty][kk];
      const T d1 = O1[kk][tx], d2 = O2[kk][tx];
      u_dy += uk * d1;
      u_dyy += uk * d2;
      v_dy += vk * d1;
      v_dyy += vk * d2;
    }
    __syncthreads();
  }
  // (Gx p) IyT = dp/dx and (Ix p) GyT = dp/dy (contraction over ni)
  const T* gp = a.left + 4 * nn;
  const T* ip = gp + (size_t)nf * ni;
  T dp_dx = 0, dp_dy = 0;
  for (int k0 = 0; k0 < ni; k0 += TILE) {
    load_tiles(gp, ni, nf, o.IyT, nf, nf, ni, k0, i, j, S1, O1);
    load_tiles(ip, ni, nf, o.GyT, nf, nf, ni, k0, i, j, S2, O2);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; ++kk) {
      dp_dx += S1[ty][kk] * O1[kk][tx];
      dp_dy += S2[ty][kk] * O2[kk][tx];
    }
    __syncthreads();
  }

  T ru2 = 0, rv2 = 0, rp2 = 0, du2 = 0, dv2 = 0;
  if (i < nf && j < nf) {
    const size_t k = (size_t)i * nf + j;
    const T u = a.u_in[k], v = a.v_in[k];
    const T du_dx = a.left[k], dv_dx = a.left[2 * nn + k];
    const T lap_u = a.left[nn + k] + u_dyy;
    const T lap_v = a.left[3 * nn + k] + v_dyy;
    T conv_u, conv_v;
    if (o.su) {
      // singular subtraction: convect with the TOTAL velocity; the
      // singular derivatives are the sampled fields
      const T U = u + o.su[k], V = v + o.sv[k];
      conv_u = U * (du_dx + o.sdudx[k]) + V * (u_dy + o.sdudy[k]);
      conv_v = U * (dv_dx + o.sdvdx[k]) + V * (v_dy + o.sdvdy[k]);
    } else {
      conv_u = u * du_dx + v * u_dy;
      conv_v = u * dv_dx + v * v_dy;
    }
    T R_u = -conv_u - dp_dx + o.nu * lap_u;
    T R_v = -conv_v - dp_dy + o.nu * lap_v;
    if (a.tau_u) {
      R_u += a.tau_u[k];
      R_v += a.tau_v[k];
    }
    const T adt = a.alpha * a.scal[S_DT];
    const bool interior = i > 0 && i < nf - 1 && j > 0 && j < nf - 1;
    const T u0 = a.u0[k], v0 = a.v0[k];
    const T u_new = interior ? u0 + adt * R_u : o.bc_u[k];
    const T v_new = interior ? v0 + adt * R_v : o.bc_v[k];
    a.u_out[k] = u_new;
    a.v_out[k] = v_new;
    if (interior) {
      const size_t kp = (size_t)(i - 1) * ni + (j - 1);
      T R_p = -o.beta_sq * (du_dx + v_dy);
      if (a.tau_p) R_p += a.tau_p[kp];
      a.p_out[kp] = a.p0[kp] + adt * R_p;
      rp2 = R_p * R_p;
    }
    ru2 = R_u * R_u;
    rv2 = R_v * R_v;
    du2 = (u_new - u0) * (u_new - u0);
    dv2 = (v_new - v0) * (v_new - v0);
  }
  if (a.part) {  // last stage: per-block partial sums (uniform branch)
    const int tid = ty * TILE + tx;
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    const T sums[NPART] = {ru2, rv2, rp2, du2, dv2};
#pragma unroll
    for (int q = 0; q < NPART; ++q) {
      const T s = block_sum(sums[q], red, tid, TILE * TILE);
      if (tid == 0) a.part[(size_t)b * NPART + q] = s;
    }
  }
}

}  // namespace

template <typename T>
cudaError_t launch_stage(const Ops<T>& o, const StageArgs<T>& a, int nf,
                         cudaStream_t s) {
  const dim3 block(TILE, TILE);
  stage_left<T><<<dim3(tiles(nf), tiles(nf), 6), block, 0, s>>>(o, a, nf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stage_row<T><<<dim3(tiles(nf), tiles(nf)), block, 0, s>>>(o, a, nf);
  return cudaGetLastError();
}

template cudaError_t launch_stage<float>(const Ops<float>&,
                                         const StageArgs<float>&, int,
                                         cudaStream_t);
template cudaError_t launch_stage<double>(const Ops<double>&,
                                          const StageArgs<double>&, int,
                                          cudaStream_t);

}  // namespace sg
