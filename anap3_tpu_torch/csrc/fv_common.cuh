// Shared declarations of the FV-SIMPLE kernels (fv_stencil.cu,
// fv_bicgstab.cu, fv_dense.cu, fv_control.cu) and their C host entries
// (fv_host.cu).
//
// Layout: cell fields are (ny, nx) row-major, index [j * nx + i]; the state's
// face fluxes are unpadded, mx (ny, nx-1) and my (ny-1, nx), as
// anap3_tpu_torch/models/fv.py holds them; the u/v pairs of the joint
// BiCGSTAB are (2, ny, nx). Every kernel is templated on the working type T
// (float or double) and accumulates in T.
//
// Tile kernels run one thread per cell on TILE x TILE tiles; a block that
// needs a field at its neighbours' cells computes it on the haloed
// (TILE+2)^2 tile into shared memory from values of the previous launch, so
// no launch needs a grid-wide sync. Grid-wide sums go through per-block
// partials that the NEXT launch reduces, in a fixed order, in every block:
// no atomics, and a run repeats bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fv {

constexpr int TILE = 16;
constexpr int NT = TILE * TILE;    // threads of a tile block
constexpr int HT = TILE + 2;       // haloed tile edge
constexpr int RED_THREADS = 1024;  // threads of the one-block control kernel

// Slots of the pointer table (the order of
// anap3_tpu_torch/ops/fv_kernels.py:_PTR_NAMES).
enum Ptr {
  P_V1, P_V2, P_INVLAM, P_A1, P_A2, P_APBC, P_BBCU,  // operators
  P_U, P_V, P_P, P_MX, P_MY,  // state, updated in place
  P_GPX, P_GPY, P_APR, P_AE, P_AW, P_AN, P_AS, P_DU,  // (ny, nx) work
  P_X, P_R, P_RH, P_PV0, P_PV1, P_VV0, P_VV1, P_S, P_T,  // (2, ny, nx)
  P_MXS, P_MYS, P_RHSP, P_RES, P_G1, P_G2, P_G3, P_PP,  // (ny, nx) work
  P_PART_RHS,  // (nb, 2) |rhs_u|^2, |rhs_v|^2
  P_PART_R,    // (nb, 4) |r_u|^2, |r_v|^2, <rh_u,r_u>, <rh_v,r_v>
  P_PART_V,    // (nb, 2) <rh_u,vv_u>, <rh_v,vv_v>
  P_PART_T,    // (nb, 4) <t_u,s_u>, <t_v,s_v>, <t_u,t_u>, <t_v,t_v>
  P_PART_M,    // (nb, 1) sum of rhs_p
  P_PART_M2,   // (nb, 1) sum of the refinement residual
  P_PART_C,    // (nb, 7) see NPART_C
  P_PART_Q,    // (nb, 3) |div|^2, omega^2, |grad omega|^2
  P_SLOTS,     // (K+1) * SL_COUNT BiCGSTAB scalars (see Slot)
  P_METRICS,   // step: (6,)
  P_ROWS,      // chunk: (chunk, 7) rows in runner.METRIC_KEYS order
  P_FLAGS,     // chunk: int32 (done, conv_iter, converged)
  P_COUNT
};

// Host scalars, in the order of fv_kernels.py:statics()["host_scalars"].
enum Scal { H_MU, H_DX, H_DY, H_AUV, H_AP, H_RHO, H_LID, H_COUNT };

// The scalars of BiCGSTAB iteration k live in slot k + 1 (slot 0 holds the
// start values 1, 1, 1, and in SL_ACTIVE ||rhs||^2 + eps, the guard's
// scale, since slot 0 has no guard): every launch reads slots written by
// earlier launches only, so no block reads a slot another block is writing.
enum Slot { SL_RHO, SL_ALPHA, SL_OMEGA, SL_ACTIVE, SL_COUNT };

// c1 partials: |u'|^2, |v'|^2, sum(u_n^2 + v_n^2), |u_n - u|^2,
// |v_n - v|^2, |u|^2, |v|^2.
constexpr int NPART_C = 7;
constexpr int NPART_Q = 3;

// Kernel counts reported to the wrapper's launch counters.
enum Count { C_STENCIL, C_BICG, C_DENSE, C_CONTROL, C_COUNT };

template <typename T>
struct Grid {
  int ny, nx, nb;
  T mu, dx, dy, auv, ap, rho, lid;
  T vol, Dxc, Dyc;
};

template <typename T>
Grid<T> make_grid(const double* h, int ny, int nx) {
  Grid<T> g;
  g.ny = ny;
  g.nx = nx;
  g.nb = ((ny + TILE - 1) / TILE) * ((nx + TILE - 1) / TILE);
  g.mu = T(h[H_MU]); g.dx = T(h[H_DX]); g.dy = T(h[H_DY]);
  g.auv = T(h[H_AUV]); g.ap = T(h[H_AP]); g.rho = T(h[H_RHO]);
  g.lid = T(h[H_LID]);
  g.vol = g.dx * g.dy;
  g.Dxc = g.mu * g.dy / g.dx;
  g.Dyc = g.mu * g.dx / g.dy;
  return g;
}

// Every buffer of one call, by name (fv_host.cu fills it from the table).
template <typename T>
struct Work {
  const T *V1, *V2, *inv_lam, *A1, *A2, *aP_bc, *b_bc_u;
  T *u, *v, *p, *mx, *my;
  T *gpx, *gpy, *aPr, *aE, *aW, *aN, *aS, *Du;
  T *x, *r, *rh, *pv[2], *vv[2], *s, *t;
  T *mxs, *mys, *rhsp, *res, *g1, *g2, *g3, *pp;
  T *part_rhs, *part_r, *part_v, *part_t, *part_m, *part_m2, *part_c,
      *part_q;
  T* slots;
  T *metrics, *rows;
  int* flags;
};

// max that propagates NaN from either side (torch.maximum / jnp.maximum)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// Fixed-order tree sum over the block (sh holds nthreads values).
template <typename T>
__device__ T block_sum(T v, T* sh, int tid, int nthreads) {
  sh[tid] = v;
  __syncthreads();
  for (int s = nthreads / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] += sh[tid + s];
    __syncthreads();
  }
  T r = sh[0];
  __syncthreads();
  return r;
}

// Column `col` of a (nb, ncol) partial table summed in a fixed order: the
// same arithmetic in every block, so every block gets the same bits.
template <typename T>
__device__ T reduce_col(const T* part, int ncol, int col, int nb, T* sh,
                        int tid, int nthreads) {
  T acc = 0;
  for (int b = tid; b < nb; b += nthreads) acc += part[(size_t)b * ncol + col];
  return block_sum(acc, sh, tid, nthreads);
}

// Tile-block geometry: this thread's cell (j, i) and the block's index.
struct TileCell {
  int j, i, ty, tx, tid, j0, i0, b;
};

__device__ __forceinline__ TileCell tile_cell() {
  TileCell c;
  c.tx = threadIdx.x;
  c.ty = threadIdx.y;
  c.tid = c.ty * TILE + c.tx;
  c.j0 = blockIdx.y * TILE;
  c.i0 = blockIdx.x * TILE;
  c.j = c.j0 + c.ty;
  c.i = c.i0 + c.tx;
  c.b = blockIdx.y * gridDim.x + blockIdx.x;
  return c;
}

// Launchers, defined and instantiated for float and double in the .cu file
// of each kernel. None synchronizes; each returns cudaGetLastError().
enum StencilPhase { PH_ASSEMBLE, PH_RHIE_CHOW, PH_RESIDUAL, PH_CORRECT,
                    PH_METRICS };
enum BicgPhase { BP_DIRECTION, BP_STABILIZE, BP_UPDATE };

template <typename T>
cudaError_t launch_stencil(int phase, const Grid<T>& g, const Work<T>& w,
                           int upwind, cudaStream_t s);
template <typename T>
cudaError_t launch_bicg(int phase, int k, const Grid<T>& g, const Work<T>& w,
                        cudaStream_t s);
// C (M x N) = op(A) op(B), op = transpose when trans*; B minus the mean of
// a partial column when mean_part is set; epilogue * scale, or += into C.
template <typename T>
cudaError_t launch_dense(int M, int N, int K, const T* A, int transA,
                         const T* B, int transB, const T* mean_part, int nb,
                         int n_total, const T* scale, int accumulate, T* C,
                         cudaStream_t s);
template <typename T>
cudaError_t launch_control(const Grid<T>& g, const Work<T>& w, int row,
                           int idx, int warmup, T tol, cudaStream_t s);

}  // namespace fv
