// sg_diag: the per-step reductions of the SG step.
//
// Replaces: the adaptive-dt pass and the conserved-quantity metrics pass of
//   anap3_tpu/ops/pallas_tiled.py (_adaptive_dt, _stage_machinery's
//   metrics_pass; make_tiled_sg_step and make_tiled_chunk_runner) and of
//   anap3_tpu/ops/pallas_aligned.py make_aligned_chunk_runner
//   (adaptive_dt, metrics_pass). Semantics: anap3_tpu/models/spectral_sg.py
//   adaptive_dt and conserved_quantities.
//
// Bound on the card: dt_kernel reads two (nf, nf) fields (133 KB at N=128,
//   L2-resident) with one block, a few microseconds that launch latency
//   dominates. The quadratures need two more dense products (omega depends
//   on a whole product, and grad(omega) on the whole of omega), so they take
//   two tiled launches; like sg_stage they are latency- and wave-bound.
// Design: dt_kernel is ONE block, so max|u_tot|, max|v_tot| and the base
//   norms |u0|^2, |v0|^2 reduce in a fixed-order tree with no cross-block
//   step; it writes dt into a device scalar that every stage reads, so no
//   host sync enters the step. The quadratures run only on the steps the
//   host loop samples (metrics_every); each tile block writes partial sums
//   and sg_control finishes them in a second pass, without atomics.
//   The |u-u0|^2 / |v-v0|^2 partials ride the last stage's epilogue
//   (sg_stage.cu), which already holds both states.
#include "sg_common.cuh"

namespace sg {
namespace {

template <typename T>
__global__ void dt_kernel(Ops<T> o, const T* u, const T* v, T* scal, int nf) {
  __shared__ T sh[RED_THREADS];
  const int tid = threadIdx.x;
  const int n = nf * nf;
  T umax = 0, vmax = 0, usq = 0, vsq = 0;
  for (int k = tid; k < n; k += RED_THREADS) {
    T uu = u[k], vv = v[k];
    usq += uu * uu;
    vsq += vv * vv;
    if (o.su) {  // wave speeds belong to the TOTAL velocity
      uu += o.su[k];
      vv += o.sv[k];
    }
    umax = nan_max(umax, (T)fabs(uu));
    vmax = nan_max(vmax, (T)fabs(vv));
  }
  umax = block_max(umax, sh, tid, RED_THREADS);
  vmax = block_max(vmax, sh, tid, RED_THREADS);
  usq = block_sum(usq, sh, tid, RED_THREADS);
  vsq = block_sum(vsq, sh, tid, RED_THREADS);
  if (tid == 0) {
    const T u_max = nan_max(umax, o.lid);
    const T v_max = nan_max(vmax, T(1e-10));
    const T lam_x = (u_max + sqrt(u_max * u_max + o.beta_sq)) * o.inv_dx
                    + o.nu * (o.inv_dx * o.inv_dx);
    const T lam_y = (v_max + sqrt(v_max * v_max + o.beta_sq)) * o.inv_dy
                    + o.nu * (o.inv_dy * o.inv_dy);
    scal[S_DT] = o.cfl / (lam_x + lam_y);
    scal[S_U0SQ] = usq;
    scal[S_V0SQ] = vsq;
  }
}

// omega = Dx v - u DyT (smooth part) into scratch, plus the energy and
// enstrophy partials over the TOTAL fields.
template <typename T>
__global__ void omega_kernel(Ops<T> o, const T* u, const T* v, T* omega,
                             T* qpart, int nf) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.y * TILE + ty;
  const int j = blockIdx.x * TILE + tx;
  __shared__ T A1[TILE][TILE], B1[TILE][TILE];
  __shared__ T A2[TILE][TILE], B2[TILE][TILE];
  __shared__ T red[TILE * TILE];
  T dvdx = 0, dudy = 0;
  for (int k0 = 0; k0 < nf; k0 += TILE) {
    load_tiles(o.Dx, nf, nf, v, nf, nf, nf, k0, i, j, A1, B1);
    load_tiles(u, nf, nf, o.DyT, nf, nf, nf, k0, i, j, A2, B2);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; ++kk) {
      dvdx += A1[ty][kk] * B1[kk][tx];
      dudy += A2[ty][kk] * B2[kk][tx];
    }
    __syncthreads();
  }
  T e = 0, z = 0;
  if (i < nf && j < nf) {
    const size_t k = (size_t)i * nf + j;
    const T om = dvdx - dudy;
    omega[k] = om;
    T ut = u[k], vt = v[k], omt = om;
    if (o.su) {
      ut += o.su[k];
      vt += o.sv[k];
      omt += o.sw[k];
    }
    const T w = o.W2d[k];
    e = w * (ut * ut + vt * vt);
    z = w * omt * omt;
  }
  const int tid = ty * TILE + tx;
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  e = block_sum(e, red, tid, TILE * TILE);
  z = block_sum(z, red, tid, TILE * TILE);
  if (tid == 0) {
    qpart[(size_t)b * NQPART + 0] = e;
    qpart[(size_t)b * NQPART + 1] = z;
  }
}

// grad(omega) = (Dx omega, omega DyT) of the smooth vorticity plus the
// sampled singular gradients; palinstrophy partials.
template <typename T>
__global__ void grad_kernel(Ops<T> o, const T* omega, T* qpart, int nf) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = blockIdx.y * TILE + ty;
  const int j = blockIdx.x * TILE + tx;
  __shared__ T A1[TILE][TILE], B1[TILE][TILE];
  __shared__ T A2[TILE][TILE], B2[TILE][TILE];
  __shared__ T red[TILE * TILE];
  T dwx = 0, dwy = 0;
  for (int k0 = 0; k0 < nf; k0 += TILE) {
    load_tiles(o.Dx, nf, nf, omega, nf, nf, nf, k0, i, j, A1, B1);
    load_tiles(omega, nf, nf, o.DyT, nf, nf, nf, k0, i, j, A2, B2);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE; ++kk) {
      dwx += A1[ty][kk] * B1[kk][tx];
      dwy += A2[ty][kk] * B2[kk][tx];
    }
    __syncthreads();
  }
  T pal = 0;
  if (i < nf && j < nf) {
    const size_t k = (size_t)i * nf + j;
    if (o.su) {
      dwx += o.sdwx[k];
      dwy += o.sdwy[k];
    }
    pal = o.W2d[k] * (dwx * dwx + dwy * dwy);
  }
  const int tid = ty * TILE + tx;
  pal = block_sum(pal, red, tid, TILE * TILE);
  if (tid == 0)
    qpart[(size_t)(blockIdx.y * gridDim.x + blockIdx.x) * NQPART + 2] = pal;
}

}  // namespace

template <typename T>
cudaError_t launch_dt(const Ops<T>& o, const T* u, const T* v, T* scal,
                      int nf, cudaStream_t s) {
  dt_kernel<T><<<1, RED_THREADS, 0, s>>>(o, u, v, scal, nf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_quadratures(const Ops<T>& o, const T* u, const T* v,
                               T* omega, T* qpart, int nf, cudaStream_t s) {
  const dim3 grid(tiles(nf), tiles(nf)), block(TILE, TILE);
  omega_kernel<T><<<grid, block, 0, s>>>(o, u, v, omega, qpart, nf);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grad_kernel<T><<<grid, block, 0, s>>>(o, omega, qpart, nf);
  return cudaGetLastError();
}

template cudaError_t launch_dt<float>(const Ops<float>&, const float*,
                                      const float*, float*, int,
                                      cudaStream_t);
template cudaError_t launch_dt<double>(const Ops<double>&, const double*,
                                       const double*, double*, int,
                                       cudaStream_t);
template cudaError_t launch_quadratures<float>(const Ops<float>&,
                                               const float*, const float*,
                                               float*, float*, int,
                                               cudaStream_t);
template cudaError_t launch_quadratures<double>(const Ops<double>&,
                                                const double*,
                                                const double*, double*,
                                                double*, int, cudaStream_t);

}  // namespace sg
