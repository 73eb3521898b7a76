// Shared declarations of the spectral SG kernels (sg_stage.cu, sg_diag.cu,
// sg_control.cu) and their C host entries (sg_host.cu).
//
// Layout: velocities u, v live on the full (nf, nf) Gauss-Lobatto grid and
// the pressure p on the (ni, ni) inner grid, ni = nf - 2, all row-major and
// dense, exactly as anap3_tpu/models/spectral_sg.py holds them. Every kernel
// is templated on the working type T (float or double) and accumulates in T.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sg {

constexpr int TILE = 16;          // output tile edge of the 2-D kernels
// threads of the one-block kernels: wide, because their loops over the
// (nf, nf) fields are bound by load latency
constexpr int RED_THREADS = 1024;

// Slots of the pointer table the Python wrapper hands to the host entries
// (the order of anap3_tpu_torch/ops/sg_kernels.py:_PTR_NAMES).
enum Ptr {
  P_DX, P_DYT, P_DXX, P_DYYT, P_IX, P_IYT, P_GX, P_GYT,
  P_BCU, P_BCV, P_W2D,
  // sampled singular fields; null in the regularized-lid modes
  P_SU, P_SV, P_SDUDX, P_SDUDY, P_SDVDX, P_SDVDY, P_SW, P_SDWX, P_SDWY,
  P_U, P_V, P_P,                       // RK base state (chunk: committed)
  P_AU, P_AV, P_AP, P_BU, P_BV, P_BP,  // stage ping-pong (step: B = out)
  P_LEFT,     // left-phase products: 4 (nf, nf) then 2 (nf, ni)
  P_OMEGA,    // (nf, nf) smooth vorticity of the sampled state
  P_PART,     // (nblocks, NPART) last-stage partial sums
  P_QPART,    // (nblocks, NQPART) quadrature partial sums
  P_SCAL,     // (S_COUNT,) device scalars
  P_TAUU, P_TAUV, P_TAUP,              // FAS forcing; null without it
  P_METRICS,  // step: (6,) u_eq v_eq continuity energy enstrophy palinstrophy
  P_ROWS,     // chunk: (chunk, 7) rows in runner.METRIC_KEYS order
  P_FLAGS,    // chunk: int32 (done, conv_iter, converged)
  P_REFNORM,  // chunk: (1,) residual-criterion normalization
  P_CU, P_CV, P_CP,  // smoother: second output ping-pong (scratch)
  P_COUNT
};

// Host scalars, in the order of sg_kernels.py:_scalars.
enum Scal { H_NU, H_BETA, H_CFL, H_LID, H_IDX, H_IDY, H_COUNT };

// Device scalars: the step's dt, the base state's squared norms, and the
// last sampled quadratures (held between samples, as the aligned kernel's
// carries are).
enum DevScal { S_DT, S_U0SQ, S_V0SQ, S_E, S_Z, S_P, S_COUNT };

// Last-stage partials: R_u^2, R_v^2, R_p^2, |u-u0|^2, |v-v0|^2.
constexpr int NPART = 5;
// Quadrature partials: W(u^2+v^2), W w^2, W(|grad w|^2).
constexpr int NQPART = 3;

// Kernel counts reported to the wrapper's launch counters.
enum Count { C_STAGE, C_DIAG, C_CONTROL, C_COUNT };

template <typename T>
struct Ops {
  const T *Dx, *DyT, *Dxx, *DyyT, *Ix, *IyT, *Gx, *GyT, *bc_u, *bc_v, *W2d;
  const T *su, *sv, *sdudx, *sdudy, *sdvdx, *sdvdy, *sw, *sdwx, *sdwy;
  T nu, beta_sq, cfl, lid, inv_dx, inv_dy;
};

template <typename T>
Ops<T> make_ops(const void* const* P, const double* h) {
  auto c = [&](int k) { return static_cast<const T*>(P[k]); };
  Ops<T> o;
  o.Dx = c(P_DX); o.DyT = c(P_DYT); o.Dxx = c(P_DXX); o.DyyT = c(P_DYYT);
  o.Ix = c(P_IX); o.IyT = c(P_IYT); o.Gx = c(P_GX); o.GyT = c(P_GYT);
  o.bc_u = c(P_BCU); o.bc_v = c(P_BCV); o.W2d = c(P_W2D);
  o.su = c(P_SU); o.sv = c(P_SV); o.sdudx = c(P_SDUDX); o.sdudy = c(P_SDUDY);
  o.sdvdx = c(P_SDVDX); o.sdvdy = c(P_SDVDY); o.sw = c(P_SW);
  o.sdwx = c(P_SDWX); o.sdwy = c(P_SDWY);
  o.nu = T(h[H_NU]); o.beta_sq = T(h[H_BETA]); o.cfl = T(h[H_CFL]);
  o.lid = T(h[H_LID]); o.inv_dx = T(h[H_IDX]); o.inv_dy = T(h[H_IDY]);
  return o;
}

// One RK stage: state (u_in, v_in, p_in) -> (u_out, ...), base (u0, v0, p0).
template <typename T>
struct StageArgs {
  const T *u_in, *v_in, *p_in;
  const T *u0, *v0, *p0;
  T *u_out, *v_out, *p_out;
  T* left;
  const T *tau_u, *tau_v, *tau_p;
  const T* scal;  // reads scal[S_DT]
  T alpha;
  T* part;        // non-null on the last stage
};

inline int tiles(int n) { return (n + TILE - 1) / TILE; }

// max that propagates NaN from either side (jnp.maximum / torch.maximum)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// Shared-memory k-tile of A (M x K, leading dim lda; row `row` of this
// thread) and of B (K x N, leading dim ldb; column `col`), zero-masked on
// the ragged edges of every extent. Thread (ty, tx) loads one element of
// each; blocks are TILE x TILE.
template <typename T>
__device__ __forceinline__ void load_tiles(
    const T* A, int lda, int M, const T* B, int ldb, int N, int K, int k0,
    int row, int col, T (&As)[TILE][TILE], T (&Bs)[TILE][TILE]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  As[ty][tx] = (row < M && k0 + tx < K) ? A[(size_t)row * lda + k0 + tx]
                                        : T(0);
  Bs[ty][tx] = (k0 + ty < K && col < N) ? B[(size_t)(k0 + ty) * ldb + col]
                                        : T(0);
}

// Fixed-order tree sum over the block (deterministic; sh holds nthreads).
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

template <typename T>
__device__ T block_max(T v, T* sh, int tid, int nthreads) {
  sh[tid] = v;
  __syncthreads();
  for (int s = nthreads / 2; s > 0; s >>= 1) {
    if (tid < s) sh[tid] = nan_max(sh[tid], sh[tid + s]);
    __syncthreads();
  }
  T r = sh[0];
  __syncthreads();
  return r;
}

// Launchers, defined (and instantiated for float and double) in the .cu
// file of each kernel. None synchronizes; each returns cudaGetLastError().
template <typename T>
cudaError_t launch_stage(const Ops<T>& o, const StageArgs<T>& a, int nf,
                         cudaStream_t s);
template <typename T>
cudaError_t launch_dt(const Ops<T>& o, const T* u, const T* v, T* scal,
                      int nf, cudaStream_t s);
template <typename T>
cudaError_t launch_quadratures(const Ops<T>& o, const T* u, const T* v,
                               T* omega, T* qpart, int nf, cudaStream_t s);
template <typename T>
cudaError_t launch_control(const T* part, const T* qpart, int nb, int sampled,
                           T* scal, T* rows, int row, int idx, int warmup,
                           T tol, int use_residual, int* flags, T* ref_norm,
                           T* u, T* v, T* p, const T* u_new, const T* v_new,
                           const T* p_new, int nf, cudaStream_t s);
template <typename T>
cudaError_t launch_step_finish(const T* part, const T* qpart, int nb,
                               T* metrics, cudaStream_t s);

}  // namespace sg
