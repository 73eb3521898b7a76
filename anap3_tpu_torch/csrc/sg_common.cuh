// Shared declarations of the spectral SG kernels (sg_stage.cu, sg_diag.cu,
// sg_control.cu) and their C host entries (sg_host.cu).
//
// Layout: velocities u, v live on the full (nf, nf) Gauss-Lobatto grid and
// the pressure p on the (ni, ni) inner grid, ni = nf - 2, all row-major and
// dense, exactly as anap3_tpu/models/spectral_sg.py holds them. Every kernel
// is templated on the working type T (float or double) and accumulates in T.
//
// Lanes: every kernel runs B independent solves ("lanes") of one order in
// one launch, the lane being a grid axis (blockIdx.z of the tile kernels,
// blockIdx.x of the one-block kernels). Operator matrices are shared; the
// boundary values, the singular fields, the scalars (nu, beta^2, CFL, lid,
// 1/dx, 1/dy), the states and every scratch buffer are per lane, lane b at
// b times the lane stride of its buffer (lane_* below). A lane reads and
// writes nothing of another lane, and its arithmetic does not depend on B,
// so lane b of a B-lane call gives the bits of a one-lane call on its data.
// The single solves (step, chunk, smoother) are the B = 1 case.
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
  P_OMEGA,    // (nf, nf) smooth vorticity of the sampled state
  P_PART,     // (StageGeo::nparts, NPART) last-stage partial sums
  P_QPART,    // (lane_blocks, NQPART) quadrature partial sums
  P_SCAL,     // (S_COUNT,) device scalars
  P_TAUU, P_TAUV, P_TAUP,              // FAS forcing; null without it
  P_METRICS,  // step: (6,) u_eq v_eq continuity energy enstrophy palinstrophy
  P_ROWS,     // chunk: (chunk, 7) rows in runner.METRIC_KEYS order
  P_FLAGS,    // chunk: int32 (done, conv_iter, converged)
  P_REFNORM,  // chunk: (1,) residual-criterion normalization
  P_CU, P_CV, P_CP,  // smoother: second output ping-pong (scratch)
  P_LSC,      // (lanes, H_COUNT) per-lane scalars in the working type
  P_COUNT
};

// Columns of the per-lane scalar table, in the order of
// sg_kernels.py:scalar_table (each the host double cast to T by torch).
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

// Launch geometry of the stage kernel (sg_stage.cu), chosen on the host by
// anap3_tpu_torch/ops/sg_kernels.py:stage_geometry and handed to every C
// entry as an int array in this slot order. A block computes an output
// tile of STAGE_TM rows by tn columns, STAGE_RM x STAGE_RN outputs a
// thread; the `cluster` blocks of one row band form a thread-block cluster
// (grid x = cluster, grid y = rows, grid z = lanes): a portable cluster of
// up to MAX_CLUSTER blocks, or, for 48-wide tiles only (N >= 384), a
// non-portable one of up to MAX_CLUSTER_NP. Operand bands are
// staged in k slabs of ks through a ring of `depth` slots, or, with depth
// 0 ("burst"), every phase's bands whole (ks = nf) in regions of their
// own, all copies issued at the start. smem is the dynamic shared memory of
// a block in bytes; nparts = cluster * rows is the number of last-stage
// partial-sum blocks a lane; ksplit (1, 2, 4 or 8) warp groups of a block
// share each contraction, group g taking k = g, g + ksplit, ..., so the
// arithmetic depends on tn and ksplit only, not on ks or depth.
enum GeoSlot { G_TN, G_CLUSTER, G_ROWS, G_KS, G_DEPTH, G_SMEM, G_NPARTS,
               G_KSPLIT, G_COUNT };
constexpr int STAGE_TM = 8;
constexpr int STAGE_RM = 2;
constexpr int STAGE_RN = 2;
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int MAX_CLUSTER_NP = 16; // the largest non-portable one (H100)
constexpr int MAX_SMEM = 232448;   // opt-in shared memory of a block

struct StageGeo {
  int tn, cluster, rows, ks, depth, smem, nparts, ksplit;
};

// Threads of one k group, and the most threads a block may have (the
// kernel's launch bound, which leaves each thread the registers it needs
// without spilling) for elements of `elem` bytes and tn columns.
__host__ __device__ constexpr int stage_group_threads(int tn) {
  return (STAGE_TM / STAGE_RM) * (tn / STAGE_RN);
}
__host__ __device__ constexpr int stage_max_threads(int elem, int tn) {
  return tn == 48 ? (elem == 4 ? 384 : 192) : 256;
}

// Lane strides (elements) of the per-lane buffers at order nf - 1.
__host__ __device__ inline int tiles(int n) { return (n + TILE - 1) / TILE; }
__host__ __device__ inline size_t lane_full(int nf) { return (size_t)nf * nf; }
__host__ __device__ inline size_t lane_inner(int nf) {
  return (size_t)(nf - 2) * (nf - 2);
}
__host__ __device__ inline size_t lane_blocks(int nf) {
  return (size_t)tiles(nf) * tiles(nf);
}

template <typename T>
struct Ops {
  // shared by every lane
  const T *Dx, *DyT, *Dxx, *DyyT, *Ix, *IyT, *Gx, *GyT, *W2d;
  // per lane (lane stride lane_full); the singular fields are null in the
  // regularized-lid modes
  const T *bc_u, *bc_v;
  const T *su, *sv, *sdudx, *sdudy, *sdvdx, *sdvdy, *sw, *sdwx, *sdwy;
  const T* lsc;  // (lanes, H_COUNT)
  // lane b's scalars, set by at_lane
  T nu, beta_sq, cfl, lid, inv_dx, inv_dy;
};

template <typename T>
Ops<T> make_ops(const void* const* P) {
  auto c = [&](int k) { return static_cast<const T*>(P[k]); };
  Ops<T> o;
  o.Dx = c(P_DX); o.DyT = c(P_DYT); o.Dxx = c(P_DXX); o.DyyT = c(P_DYYT);
  o.Ix = c(P_IX); o.IyT = c(P_IYT); o.Gx = c(P_GX); o.GyT = c(P_GYT);
  o.bc_u = c(P_BCU); o.bc_v = c(P_BCV); o.W2d = c(P_W2D);
  o.su = c(P_SU); o.sv = c(P_SV); o.sdudx = c(P_SDUDX); o.sdudy = c(P_SDUDY);
  o.sdvdx = c(P_SDVDX); o.sdvdy = c(P_SDVDY); o.sw = c(P_SW);
  o.sdwx = c(P_SDWX); o.sdwy = c(P_SDWY);
  o.lsc = c(P_LSC);
  o.nu = o.beta_sq = o.cfl = o.lid = o.inv_dx = o.inv_dy = T(0);
  return o;
}

// The operators as lane b sees them: its boundary values, singular fields
// and scalars.
template <typename T>
__device__ __forceinline__ Ops<T> at_lane(Ops<T> o, int b, int nf) {
  const size_t f = (size_t)b * lane_full(nf);
  o.bc_u += f;
  o.bc_v += f;
  if (o.su) {
    o.su += f; o.sv += f; o.sdudx += f; o.sdudy += f; o.sdvdx += f;
    o.sdvdy += f; o.sw += f; o.sdwx += f; o.sdwy += f;
  }
  const T* s = o.lsc + (size_t)b * H_COUNT;
  o.nu = s[H_NU]; o.beta_sq = s[H_BETA]; o.cfl = s[H_CFL];
  o.lid = s[H_LID]; o.inv_dx = s[H_IDX]; o.inv_dy = s[H_IDY];
  return o;
}

// One RK stage: state (u_in, v_in, p_in) -> (u_out, ...), base (u0, v0, p0);
// every pointer is lane 0's.
template <typename T>
struct StageArgs {
  const T *u_in, *v_in, *p_in;
  const T *u0, *v0, *p0;
  T *u_out, *v_out, *p_out;
  const T *tau_u, *tau_v, *tau_p;
  const T* scal;  // reads scal[S_DT]
  T alpha;
  T* part;        // non-null on the last stage
};

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
// file of each kernel, each for `lanes` lanes at once; pointers are lane 0's.
// None synchronizes; each returns cudaGetLastError().
// The geometry from the host's int array, checked against what the stage
// kernel can take at order nf - 1 with elements of `elem` bytes;
// cudaErrorInvalidValue when it cannot.
cudaError_t stage_geometry(const int* geo, int nf, int elem, StageGeo* g);
template <typename T>
cudaError_t launch_stage(const Ops<T>& o, const StageArgs<T>& a, int nf,
                         int lanes, const StageGeo& g, cudaStream_t s);
template <typename T>
cudaError_t launch_dt(const Ops<T>& o, const T* u, const T* v, T* scal,
                      int nf, int lanes, cudaStream_t s);
template <typename T>
cudaError_t launch_quadratures(const Ops<T>& o, const T* u, const T* v,
                               T* omega, T* qpart, int nf, int lanes,
                               cudaStream_t s);
// rows: (chunk, lanes, 7), row `row` written; flags: (lanes, 3); ref_norm:
// (lanes,); part holds nparts blocks a lane, qpart lane_blocks(nf)
template <typename T>
cudaError_t launch_control(const T* part, int nparts, const T* qpart,
                           int sampled,
                           T* scal, T* rows, int row, int idx, int warmup,
                           T tol, int use_residual, int* flags, T* ref_norm,
                           T* u, T* v, T* p, const T* u_new, const T* v_new,
                           const T* p_new, int nf, int lanes, cudaStream_t s);
template <typename T>
cudaError_t launch_step_finish(const T* part, int nparts, const T* qpart,
                               T* metrics, int nf, int lanes, cudaStream_t s);

}  // namespace sg
