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

#include <cuda_bf16.h>
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
  P_DPART,    // (StageGeo::nparts, NDPART) next base's partials (chunk)
  P_QPART,    // (lane_blocks, NQPART) quadrature partial sums
  P_SCAL,     // (S_COUNT,) device scalars
  P_TAUU, P_TAUV, P_TAUP,              // FAS forcing; null without it
  P_METRICS,  // step: (6,) u_eq v_eq continuity energy enstrophy palinstrophy
  P_ROWS,     // chunk: (chunk, 7) rows in runner.METRIC_KEYS order
  P_FLAGS,    // chunk: int32 (done, conv_iter, converged)
  P_REFNORM,  // chunk: (1,) residual-criterion normalization
  P_CU, P_CV, P_CP,  // smoother: second output ping-pong (scratch)
  P_LSC,      // (lanes, H_COUNT) per-lane scalars in the working type
  P_X1B,      // x1 chunk: (lanes, 8, nf) border-strip constants (X1B_*)
  P_X1OPS,    // x1 chunk: the bf16 operator table (x1_op_offset)
  P_X1S,      // x1 chunk: (3, lanes, x1_state_elems) bf16 state copies
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
// The chunk step's last stage also sums the next step's base (the state it
// commits): max|u + su|, max|v + sv| (the total velocity's wave speeds),
// |u|^2 and |v|^2, all that the next step's dt and rel need.
constexpr int NDPART = 4;
// Quadrature partials: W(u^2+v^2), W w^2, W(|grad w|^2).
constexpr int NQPART = 3;

// Kernel counts reported to the wrapper's launch counters: the stage, the
// dt and sampled tails, the unsampled control, the x1 stage and x1
// sampled tail (matmul_algorithm=x1, float32; dt stays in C_DIAG), the
// resident chunk (sg_resident.cu: a whole chunk in one launch); then
// dt_kernel's launches alone (C_DT, also counted in C_DIAG).
enum Count { C_STAGE, C_DIAG, C_CONTROL, C_STAGE_X1, C_DIAG_X1, C_RESIDENT,
             C_DT, C_COUNT };

// dt_kernel's launch: a thread-block cluster of DT_CLUSTER blocks a lane
// (the portable size), DT_THREADS threads a block, so the lane's
// RED_THREADS slots of the reduction tree are spread over the cluster;
// DT_ILP elements of each field in flight a thread (at N=128 a slot folds
// 17 elements: 3 rounds of loads; 16 in flight took longer to N=128 and
// gained 3% at N=320, scripts/sg_tail_ab.py on an H100).
constexpr int DT_CLUSTER = 8;
constexpr int DT_THREADS = RED_THREADS / DT_CLUSTER;
constexpr int DT_ILP = 8;

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
  // matmul_algorithm=x1 (not a slot: the host entries take it as an
  // argument): bf16 tensor-core products, whole bands (ks = nf, depth 1)
  int x1;
};

// The x1 stage's bf16 bands: k rounded up to whole mma k steps (16) plus 8,
// so a band row is 4 (mod 8) words long and the 8 rows an ldmatrix
// touches fall in 8 different bank quads.
__host__ __device__ constexpr int x1_k16(int k) { return (k + 15) & ~15; }
__host__ __device__ constexpr int x1_kp(int k) { return x1_k16(k) + 8; }

// The x1 operands in device memory, all bf16 with k contiguous in rows of
// whole 16-byte chunks, zero past the operand (ops/sg_kernels.py writes
// them): the operator table, once a run (P_X1OPS), the velocity operators'
// hi halves over k < N, Dx, Dxx as (nf, x1_k16(N)) and DyT, DyyT
// transposed, then the pressure operators' over k < ni, Gx, Ix as (nf,
// x1_k16(ni)) and IyT, GyT transposed; and a lane's state copy (P_X1S), u
// and v rounded on [0, N)^2 in (x1_sld, x1_sld) row-major arrays and p in
// an (x1_pld, x1_pld) one, zero elsewhere (the border row and column N
// are the unrounded term's).
enum X1Op { X_DX, X_DXX, X_DY, X_DYY, X_GX, X_IX, X_IY, X_GY, X_COUNT };
__host__ __device__ inline size_t x1_op_offset(int q, int nf) {
  const size_t v = (size_t)nf * x1_k16(nf - 1), p = (size_t)nf * x1_k16(nf - 2);
  return q < X_GX ? q * v : 4 * v + (q - X_GX) * p;
}
__host__ __device__ constexpr int x1_sld(int nf) { return x1_k16(nf); }
__host__ __device__ constexpr int x1_pld(int nf) { return x1_k16(nf - 2); }
__host__ __device__ inline size_t x1_state_elems(int nf) {
  return 2 * (size_t)x1_sld(nf) * x1_sld(nf) +
         (size_t)x1_pld(nf) * x1_pld(nf);
}

// One lane's state (u, v, p float32) into its bf16 copy xs, by thread t of
// nt: each element rounded to nearest even, the padding left as it is.
// X1_ILP elements of each field are loaded before any is stored (a store
// may alias the next loads, so one at a time each would wait for memory).
constexpr int X1_ILP = 8;
__device__ __forceinline__ void x1_round_lane(const float* u, const float* v,
                                              const float* p,
                                              __nv_bfloat16* xs, int nf,
                                              int t, int nt) {
  const int n = nf - 1, ni = nf - 2, S = x1_sld(nf), Sp = x1_pld(nf);
  for (int e0 = t; e0 < n * n; e0 += X1_ILP * nt) {
    float a[X1_ILP], b[X1_ILP];
#pragma unroll
    for (int q = 0; q < X1_ILP; ++q) {
      const int e = e0 + q * nt, i = e / n, j = e - i * n;
      a[q] = e < n * n ? u[i * nf + j] : 0.f;
      b[q] = e < n * n ? v[i * nf + j] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < X1_ILP; ++q) {
      const int e = e0 + q * nt, i = e / n, j = e - i * n;
      if (e < n * n) {
        xs[i * S + j] = __float2bfloat16_rn(a[q]);
        xs[S * S + i * S + j] = __float2bfloat16_rn(b[q]);
      }
    }
  }
  for (int e0 = t; e0 < ni * ni; e0 += X1_ILP * nt) {
    float a[X1_ILP];
#pragma unroll
    for (int q = 0; q < X1_ILP; ++q) {
      const int e = e0 + q * nt;
      a[q] = e < ni * ni ? p[e] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < X1_ILP; ++q) {
      const int e = e0 + q * nt, i = e / ni, j = e - i * ni;
      if (e < ni * ni) xs[2 * S * S + i * Sp + j] = __float2bfloat16_rn(a[q]);
    }
  }
}

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
  // x1 only: (lanes, 8, nf) the velocity products on the constant border
  // strip, per run (rows X1B_*): Dx u, Dxx u, Dx v, Dxx v at column N,
  // u DyT, u DyyT, v DyT, v DyyT at row N
  const T* x1b;
  const __nv_bfloat16* x1ops;  // x1 only: the operator table (X1Op)
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
  o.x1b = c(P_X1B);
  o.x1ops = static_cast<const __nv_bfloat16*>(P[P_X1OPS]);
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
  T* scal;  // reads scal[S_DT]; writes it with dt_part
  T alpha;
  // Set on the first stage of a smoother step after the first: the
  // partials (lanes, nparts, NDPART) of the base, which the previous
  // step's last stage wrote. The stage takes dt from their maxima
  // (dt_of) in place of scal[S_DT], and block (0, 0) of each lane writes
  // it to scal[S_DT] for the step's later stages.
  const T* dt_part;
  T* part;        // non-null on the last stage
  // Set on the last stage of a chunk step, which writes the base in place
  // (u_out == u0, ...): a lane whose flags (lanes, 3) say done at the
  // step's start stores nothing (the freeze).
  const int* flags;
  // Set on the last stage of a chunk step and of every smoother step but
  // the last: the partials of the base the stage leaves (its output, read
  // back), from which the next step's dt comes.
  T* dpart;
  // x1 only: the bf16 copy of the stage input that the products read, and
  // where the copy of the stage output goes (lane 0's x1_state_elems)
  const __nv_bfloat16* x1_in;
  __nv_bfloat16* x1_out;
};

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// Two adjacent elements in one load (p aligned to their pair).
template <typename T>
__device__ __forceinline__ typename Vec2<T>::type ld2(const T* p) {
  return *reinterpret_cast<const typename Vec2<T>::type*>(p);
}

// acc[2 * rho + t] += a[rho] * b[t]: a 2x2 outer product, each output one
// fused multiply-add (the products' k-ascending chains of the stage and
// resident kernels)
template <typename T, typename V>
__device__ __forceinline__ void fma4(T* acc, const V& a, const V& b) {
  acc[0] += a.x * b.x; acc[1] += a.x * b.y;
  acc[2] += a.y * b.x; acc[3] += a.y * b.y;
}

// max that propagates NaN from either side (jnp.maximum / torch.maximum)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// The split cluster barrier: arrive publishes this thread's writes (shared
// memory included) to the cluster; wait returns once every thread of the
// cluster has arrived, and makes their writes visible. The relaxed arrive
// publishes nothing: a block arrives so that its peers may know it runs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Correctly rounded operations that the compiler may not contract or
// reorder (the CUDA intrinsics), for arithmetic whose bits two kernels
// must share.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

// The adaptive dt of models/spectral_sg.adaptive_dt from the base's
// max|u + su| and max|v + sv|, with lane scalars s (H_COUNT): dt_kernel
// and the chunk step's finish share it. Each operation is pinned, so both
// kernels give the same bits, and those of the dt kernel before the
// finish took it over: lam = fma(nu, idx * idx, (u + sqrt(fma(u, u,
// beta^2))) * idx), the contraction nvcc chose for that expression.
template <typename T>
__device__ __forceinline__ T dt_of(T umax, T vmax, const T* s) {
  const T u_max = nan_max(umax, s[H_LID]);
  const T v_max = nan_max(vmax, T(1e-10));
  const T wx = add_rn(u_max, sqrt_rn(fma_rn(u_max, u_max, s[H_BETA])));
  const T wy = add_rn(v_max, sqrt_rn(fma_rn(v_max, v_max, s[H_BETA])));
  const T lam_x = fma_rn(s[H_NU], mul_rn(s[H_IDX], s[H_IDX]),
                         mul_rn(s[H_IDX], wx));
  const T lam_y = fma_rn(s[H_NU], mul_rn(s[H_IDY], s[H_IDY]),
                         mul_rn(s[H_IDY], wy));
  return div_rn(s[H_CFL], add_rn(lam_x, lam_y));
}

// dt_of on the largest of columns 0 and 1 of a lane's nparts partials of a
// base (dl: the lane's (nparts, NDPART) table), in every lane of the
// calling warp: a maximum is exact in any order, so this is dt_kernel's dt
// of that base, bit for bit.
template <typename T>
__device__ __forceinline__ T warp_dt(const T* dl, int nparts, const T* lsc) {
  T um = T(0), vm = T(0);
#pragma unroll 4
  for (int b = threadIdx.x % 32; b < nparts; b += 32) {
    um = nan_max(um, dl[(size_t)b * NDPART]);
    vm = nan_max(vm, dl[(size_t)b * NDPART + 1]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    um = nan_max(um, __shfl_xor_sync(0xffffffffu, um, off));
    vm = nan_max(vm, __shfl_xor_sync(0xffffffffu, vm, off));
  }
  return dt_of(um, vm, lsc);
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

// What a step's tail finishes (every pointer lane 0's): the partial sums
// of the last stage, of the next base and of the quadratures, and where the
// results go. A chunk step (rows set) writes its history row, runs the
// convergence state machine and, from dpart, the next step's dt and base
// norms; a step or smoother (metrics set) writes the six metrics.
template <typename T>
struct Tail {
  const T* part;   // (lanes, nparts, NPART)
  int nparts;
  const T* dpart;  // (lanes, nparts, NDPART); chunk only
  T* qpart;        // (lanes, lane_blocks(nf), NQPART)
  T* scal;         // (lanes, S_COUNT)
  const T* lsc;    // (lanes, H_COUNT)
  T* metrics;      // step: (lanes, 6)
  T* rows;         // chunk: (chunk, lanes, 7), row `row` written
  int lanes, row, idx, warmup, use_residual;
  T tol;
  int* flags;      // chunk: (lanes, 3) done, conv_iter, converged
  T* ref_norm;     // chunk: (lanes,)
  int x1;          // the quadratures' products as x1 (float32 chunks)
};

// Slots of the 1024-thread tree that warp_tree reads: nb is at most
// TREE_PASSES * RED_THREADS (the tails check it).
constexpr int TREE_PASSES = 3;

template <bool MAX, typename T>
__device__ __forceinline__ T fold(T a, T b) {
  if constexpr (MAX) return nan_max(a, b);
  else return a + b;
}

// The fixed-order tree of the SG reductions over RED_THREADS slots: slot t
// first folds col[b * stride] for b = t, t + RED_THREADS, ... < nb, then
// level s = RED_THREADS / 2, ..., 1 folds slot t + s into slot t for t < s
// (the one-block dt kernel's shared-memory tree, whose bits the sums have
// kept). Lane 0 of the calling warp (l: the thread's lane) gets slot 0:
// lane l holds the
// slots l + 32 m, runs the tree's levels 512 .. 32 on them (they pair slot
// m with m + s / 32 of the same lane), then levels 16 .. 1 by shuffles,
// which pair lane l with l + s as the tree does. Slots past nb hold zeros,
// and adding or taking the max with them changes nothing, so the bits are
// the tree's. Every index is a constant after unrolling (counted loops),
// so the slots stay in registers, and the first pass's loads are issued
// together.
template <bool MAX, typename T>
__device__ __forceinline__ T warp_tree(const T* col, int stride, int nb,
                                       int l) {
  T v[32];
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    const int b = l + 32 * m;
    v[m] = fold<MAX>(T(0), b < nb ? col[(size_t)b * stride] : T(0));
  }
  if (nb > RED_THREADS) {
#pragma unroll
    for (int r = 1; r < TREE_PASSES; ++r) {
#pragma unroll
      for (int m = 0; m < 32; ++m) {
        const int b = l + 32 * m + r * RED_THREADS;
        if (b < nb) v[m] = fold<MAX>(v[m], col[(size_t)b * stride]);
      }
    }
  }
#pragma unroll
  for (int lv = 0; lv < 5; ++lv) {
    const int s = 16 >> lv;
#pragma unroll
    for (int m = 0; m < s; ++m) v[m] = fold<MAX>(v[m], v[m + s]);
  }
  T r = v[0];
#pragma unroll
  for (int lv = 0; lv < 5; ++lv)
    r = fold<MAX>(r, __shfl_down_sync(0xffffffffu, r, 16 >> lv));
  return r;
}

// A quadrature tile's 256 cell values summed in the fixed 256-slot tree
// (level s = 128, ..., 1 folds slot t + s into slot t), cell e read as
// at(e): lane l takes the tree's first three levels from its eight slots
// l + 32 j in the tree's pair order, then the last five by shuffles (lane
// l with l + s). Valid in lane 0.
template <typename T, typename At>
__device__ __forceinline__ T tile_tree(const At& at, int l) {
  T x = ((at(l) + at(l + 128)) + (at(l + 64) + at(l + 192))) +
        ((at(l + 32) + at(l + 160)) + (at(l + 96) + at(l + 224)));
#pragma unroll
  for (int lv = 0; lv < 5; ++lv)
    x += __shfl_down_sync(0xffffffffu, x, 16 >> lv);
  return x;
}

// tile_tree of the cells col[0, 256).
template <typename T>
__device__ __forceinline__ T tile_sum(const T* col, int l) {
  return tile_tree<T>([&](int e) { return col[e]; }, l);
}

// Columns of a lane's tail: the last stage's NPART, the next base's NDPART
// (a chunk step), the NQPART quadratures (a sampled step).
constexpr int TAIL_COLS = NPART + NDPART + NQPART;

// Columns [c0, c1) of a lane's partial tables into sums[c], one warp a
// column, by a whole block (whole warps); the next base's columns only
// where there are (a chunk), the quadratures only when sampled.
template <typename T>
__device__ void tail_sums(const Tail<T>& t, int lane, int nf, bool sampled,
                          int c0, int c1, T* sums) {
  const int nq = (int)lane_blocks(nf);
  const T* part = t.part + (size_t)lane * t.nparts * NPART;
  const T* dpart = t.dpart ? t.dpart + (size_t)lane * t.nparts * NDPART
                           : nullptr;
  const T* qpart = t.qpart + (size_t)lane * nq * NQPART;
  const int tid = threadIdx.x + threadIdx.y * blockDim.x;
  const int l = tid % 32, nw = blockDim.x * blockDim.y / 32;
  for (int c = c0 + tid / 32; c < c1; c += nw) {
    T r = T(0);
    if (c < NPART) {
      r = warp_tree<false>(part + c, NPART, t.nparts, l);
    } else if (c < NPART + NDPART) {
      const int q = c - NPART;
      if (!dpart) continue;
      r = q < 2 ? warp_tree<true>(dpart + q, NDPART, t.nparts, l)
                : warp_tree<false>(dpart + q, NDPART, t.nparts, l);
    } else {
      if (!sampled) continue;
      r = warp_tree<false>(qpart + (c - NPART - NDPART), NQPART, nq, l);
    }
    if (l == 0) sums[c] = r;
  }
}

// The tail of one lane's step from its column sums, in one thread: a step's
// six metrics, or a chunk step's row, state machine and next dt.
// Replaces the per-step tail of the chunk kernels' fori_loop body
// (anap3_tpu/ops/pallas_aligned.py make_aligned_chunk_runner, pallas_tiled.py
// make_tiled_chunk_runner; semantics: anap3_tpu/models/runner.py
// make_chunk_runner): rows, the rel_iter / residual criteria, the warmup
// gate, NaN divergence, conv_iter and done. A lane that is done writes NaN
// rows (its state was kept by the stage).
template <typename T>
__device__ void finish_lane(const Tail<T>& t, int lane, bool sampled,
                            const T* sums) {
  const T* qs = sums + NPART + NDPART;
  T* scal = t.scal + (size_t)lane * S_COUNT;
  if (t.metrics) {
    T* m = t.metrics + (size_t)lane * 6;
    m[0] = sqrt(sums[0]);
    m[1] = sqrt(sums[1]);
    m[2] = sqrt(sums[2]);
    m[3] = T(0.5) * qs[0];
    m[4] = T(0.5) * qs[1];
    m[5] = T(0.5) * qs[2];
  } else {
    if (sampled) {
      scal[S_E] = T(0.5) * qs[0];
      scal[S_Z] = T(0.5) * qs[1];
      scal[S_P] = T(0.5) * qs[2];
    }
    int* flags = t.flags + 3 * lane;
    T* rows = t.rows + ((size_t)t.row * t.lanes + lane) * 7;
    const int done = flags[0];
    const T rel = nan_max(sqrt(sums[3]) / (sqrt(scal[S_U0SQ]) + T(1e-12)),
                          sqrt(sums[4]) / (sqrt(scal[S_V0SQ]) + T(1e-12)));
    const T vals[7] = {rel, sqrt(sums[0]), sqrt(sums[1]), sqrt(sums[2]),
                       scal[S_E], scal[S_Z], scal[S_P]};
    const T nan = T(NAN);
    for (int c = 0; c < 7; ++c) rows[c] = done ? nan : vals[c];
    // the row's values (NaN once done) feed the criteria, as in
    // runner.make_chunk_runner
    const T rel_row = done ? nan : rel;
    const T cont = done ? nan : vals[3];
    T rn = t.ref_norm[lane];
    if (t.use_residual && t.idx == t.warmup) rn = cont;  // pinned
    const T crit = t.use_residual ? cont / nan_max(rn, T(1e-30)) : rel_row;
    if (!done) {
      const bool finite = isfinite(rel);
      const bool newly_conv = t.idx >= t.warmup && crit < t.tol && finite;
      if (newly_conv || !finite) {
        flags[0] = 1;
        flags[1] = t.idx + 1;
      }
      if (newly_conv) flags[2] = 1;
    }
    t.ref_norm[lane] = rn;
    // the next step's dt and base norms, from the base the last stage
    // left (dt_kernel's arithmetic on the same maxima)
    const T* ds = sums + NPART;
    scal[S_DT] = dt_of(ds[0], ds[1], t.lsc + (size_t)lane * H_COUNT);
    scal[S_U0SQ] = ds[2];
    scal[S_V0SQ] = ds[3];
  }
}

// Launch geometry of the resident chunk kernel (sg_resident.cu), which
// resident_geometry derives from the stage geometry: a lane is one
// thread-block cluster of `cluster` blocks (grid x; grid z = lanes), one
// block a row band of the stage geometry (8 rows), each block `sub`
// sub-blocks of RES_SUB_THREADS threads, one a column tile of the band:
// the stage kernel's tiles (16 columns) and threads (4 k groups of one
// warp each), the only tile and split the stage geometry chooses at the
// orders whose lane fits a cluster. `smem` is the dynamic shared memory of
// a block in bytes (res_layout).
constexpr int RES_TN = 16;
constexpr int RES_KSPLIT = 4;
constexpr int RES_SUB_THREADS = RES_KSPLIT * 32;
// values a thread's products hand on a round of the k groups' exchange:
// the 40 of the velocity and first pressure products go in two rounds
constexpr int RES_RED_VALS = 20;
// a point's partial-sum terms on a last stage (the k groups' exchange
// space holds them): R_u, R_v, R_p, u - u0, v - v0, the base's u, v and
// its total speeds |u + su|, |v + sv|
constexpr int RES_STAT = 9;
// a sub-block's exchange space: RES_RED_VALS values of each k group's 32
// threads
constexpr int RES_XR = RES_KSPLIT * RES_RED_VALS * 32;
// the shared memory a block starts with (bytes): its mbarriers (from byte
// RES_MBAR: state copy 0's, copy 1's, the vorticity's and the quadrature
// cells') and the lane's flags (4 ints from byte RES_FLAGS)
constexpr int RES_MBAR = 0;
constexpr int RES_FLAGS = 32;
constexpr int RES_HEADER = RES_FLAGS + 4 * 4;
// a tile's row of last-stage and next-base partials (NPART + NDPART
// values), padded to whole 16-byte units in both working types
constexpr int RES_PROW = 12;
// the most sub-blocks of a block: the kernel's launch bound leaves each
// thread 128 registers in float32 and 255 in float64
__host__ __device__ constexpr int res_max_sub(int elem) {
  return elem == 4 ? 4 : 2;
}

struct ResidentGeo {
  int cluster, sub, smem;
};

// Element offsets of a resident block's shared-memory regions (after the
// RES_HEADER bytes), each rounded up to 4 elements. Pairs a k step loads
// together are interleaved: u with v, Dx with Dxx, DyT with DyyT, Gx with
// Ix, IyT with GyT, Gx p with Ix p. A state copy is L rows of RW elements:
// row i holds the (u, v) pairs of grid row i, then from element 2 L the
// pressure row i - 1 (the row of grid row i's interior points), so a row
// band's state is one run; L is nf rounded up to 2, Lp ni rounded up to
// 4, and RW = 2 L + Lp rounded up to 4 (mod 8), so the rows of a warp's
// threads (2 apart) fall in different banks. Regions: DyT with DyyT and
// IyT with GyT whole ([k][j][2], ld L), then Dx whole, k-major ([k][i],
// ld L), for the quadratures; Dx with Dxx and Gx with Ix on the block's
// band of 8 rows, k-major ([k][r][2]); two state copies; the block's band
// of Gx p with Ix p ([k][r][2]); the vorticity (nf x Lo, Lo = nf rounded
// up to 4); the quadrature cells (nf rows of 3 x Lo: energy, enstrophy,
// palinstrophy), whose place the first dt's 4 x RED_THREADS slots take
// before the first step; the base's and the boundary values' (u, v) on
// the band (8 x L pairs each) and the base's p (8 x Lp); each sub-block's
// exchange space (RES_XR); the lane's last-stage and next-base partials (a
// RES_PROW row a tile); the quadrature partials (a row a 16 x 16 tile);
// the scalars and the lane's scalar table. resident_geometry and the
// kernel share it.
struct ResLayout {
  int L, Lp, RW, Lo;
  int ops, bops, f, fcopy, band, omega, uni, base, xr, part, qpart, small,
      elems;
};
__host__ __device__ inline int res_r4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline ResLayout res_layout(int nf, int sub, int tiles) {
  ResLayout y;
  const int ni = nf - 2, nq = (int)lane_blocks(nf);
  y.L = (nf + 1) & ~1;
  y.Lp = res_r4(ni);
  y.RW = 2 * y.L + y.Lp + ((2 * y.L + y.Lp) % 8 == 0 ? 4 : 0);
  y.Lo = res_r4(nf);
  const int L = y.L;
  int at = 0;
  y.ops = at;
  at += res_r4(3 * nf * L + 2 * ni * L);
  y.bops = at;
  at += res_r4(2 * STAGE_TM * (nf + ni));
  y.f = at;
  y.fcopy = L * y.RW;
  at += 2 * y.fcopy;
  y.band = at;
  at += res_r4(2 * STAGE_TM * ni);
  y.omega = at;
  at += nf * y.Lo;
  y.uni = at;
  at += res_r4(3 * nf * y.Lo > 4 * RED_THREADS ? 3 * nf * y.Lo
                                                : 4 * RED_THREADS);
  y.base = at;
  at += res_r4(STAGE_TM * (4 * L + y.Lp));
  y.xr = at;
  at += sub * RES_XR;
  y.part = at;
  at += res_r4(tiles * RES_PROW);
  y.qpart = at;
  at += res_r4(nq * NQPART);
  y.small = at;
  at += res_r4(S_COUNT + TAIL_COLS + 7 + 4 + 1 + H_COUNT);
  y.elems = at;
  return y;
}
__host__ __device__ inline size_t res_smem_bytes(int nf, int elem, int sub,
                                                 int tiles) {
  return RES_HEADER + (size_t)elem * res_layout(nf, sub, tiles).elems;
}

// What the resident chunk kernel runs on besides the operators: one
// chunk's state (in place), rows, flags and residual normalization (every
// pointer lane 0's, as the chunk entry's pointer table holds them) and its
// contract.
template <typename T>
struct ResArgs {
  T *u, *v, *p, *rows, *ref_norm;
  int* flags;
  int nf, lanes, chunk, start_iter, warmup, metrics_every, use_residual;
  T tol;
  int cluster, sub;
};

// Launchers, defined (and instantiated for float and double) in the .cu
// file of each kernel, each for `lanes` lanes at once; pointers are lane 0's.
// None synchronizes; each returns cudaGetLastError().
// The geometry from the host's int array, checked against what the stage
// kernel can take at order nf - 1 with elements of `elem` bytes;
// cudaErrorInvalidValue when it cannot.
// With x1, the geometry of the x1 stage (float32 only).
cudaError_t stage_geometry(const int* geo, int nf, int elem, int x1,
                           StageGeo* g);
template <typename T>
cudaError_t launch_stage(const Ops<T>& o, const StageArgs<T>& a, int nf,
                         int lanes, const StageGeo& g, cudaStream_t s);
// With x1s (float32 only), dt_kernel also rounds each lane's (u, v, p)
// into its bf16 copy x1s (lane 0's; x1_round_lane).
template <typename T>
cudaError_t launch_dt(const Ops<T>& o, const T* u, const T* v, T* scal,
                      int nf, int lanes, cudaStream_t s,
                      const T* p = nullptr, __nv_bfloat16* x1s = nullptr);
// (u, v, p) of each lane into its bf16 copy x1s, in one launch (the bench
// entry's x1 stage input).
cudaError_t launch_x1_round(const float* u, const float* v, const float* p,
                            __nv_bfloat16* x1s, int nf, int lanes,
                            cudaStream_t s);
// A chunk step's unsampled tail: one block a lane.
template <typename T>
cudaError_t launch_control(const Tail<T>& t, int nf, int lanes,
                           cudaStream_t s);
// A sampled tail: the quadratures of (u, v) and the finish, one cooperative
// launch of `blocks` blocks (at least `lanes`, at most tail_coresident, at
// most MAX_TAIL_ITEMS (tile, lane) items a block); t.x1 takes the x1
// instance.
template <typename T>
cudaError_t launch_tail(const Ops<T>& o, const T* u, const T* v, T* omega,
                        const Tail<T>& t, int nf, int lanes, int blocks,
                        cudaStream_t s);
// The resident geometry at order nf - 1 with elements of `elem` bytes
// under the stage geometry g (whose tiles it computes), where a lane fits
// one portable cluster's shared memory; cudaErrorInvalidValue where not.
cudaError_t resident_geometry(int nf, int elem, const StageGeo& g,
                              ResidentGeo* r);
// A whole chunk of `lanes` lanes in one launch: a cluster a lane.
template <typename T>
cudaError_t launch_resident(const Ops<T>& o, const ResArgs<T>& a,
                            const ResidentGeo& r, cudaStream_t s);
// Co-resident blocks of the tail kernel (its x1 instance with x1) on the
// current device; cudaErrorNotSupported on a card without cooperative
// launch.
template <typename T>
cudaError_t tail_coresident(int* blocks, int x1);
constexpr int MAX_TAIL_ITEMS = 128;

}  // namespace sg
