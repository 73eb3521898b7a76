// fv_pressure: the pressure stage and control of one SIMPLE iteration in
// one cooperative launch: Rhie-Chow, the separable pressure solve with its
// refinement, the gauge, the corrections, the metrics and the convergence
// state machine.
//
// Replaces: the body _make_iterate of anap3_tpu/ops/pallas_fv.py
//   (make_pallas_fv_step, make_pallas_fv_chunk_runner) from Rhie-Chow on:
//   the compact face fluxes and rhs_p = -div(mdot*); psolve at HIGHEST
//   precision, p' = V1 ((V1^T f V2) * inv_lam) V2^T, and its n_refine
//   refinement steps (one in float32); the p'[0,0] gauge; the corrections
//   and the new state; the FD-ghost metrics; and the tail of the chunk
//   runner's loop_body (rel_iter, rows NaN once done, the warmup gate, NaN
//   divergence, conv_iter = idx + 1, the done flag) or the step's metrics
//   vector. V1 = P.Vx is the y eigenbasis (ny, ny), V2 = P.Vy the x
//   eigenbasis (nx, nx), inv_lam (ny, nx). With a lane axis it also
//   replaces the row-stacked pressure stage and the per-lane state machine
//   of anap3_tpu/ops/pallas_fv_lanes.py make_fv_lane_runner. With
//   use_residual the criterion is the continuity norm over its value at
//   the warmup iteration (runner.control_step), each lane with its own
//   normalization; the Pallas kernels take rel_iter only.
//
// Bound on the card: latency. At N=128 a product is 2 x 128^3 = 4.2 MFLOP
//   (about 0.06 us at the card's float32 FMA rate) on operands that sit in
//   L2, and a stencil phase touches ~0.6 MB; the launch is a chain of 13
//   dependent phases in float32 (8 in float64), each reading what the one
//   before wrote across tiles. As separate launches they cost 3.1-3.6 us
//   each of launch floor (scripts/launch_floor.cu); a grid barrier costs
//   1.2-1.7 us.
// Design: one persistent cooperative launch (cudaLaunchAttributeCooperative)
//   of min(items, co-resident) blocks of 256 threads, an item a (16 x 16
//   tile, lane) pair; block b takes items b, b + grid, ... in the same
//   order in every phase, with grid.sync() between phases: Rhie-Chow | the
//   four products g1 = V1^T (rhs_p - mean), g2 = (g1 V2) * inv_lam,
//   g3 = V1 g2, p' = g3 V2^T | (per refinement: the residual | the four
//   products again, accumulating into p') | correct | metrics | control.
//   A phase that needs a lane sum (the means, control's sums) reduces the
//   previous phase's per-tile partials of its lane in a fixed order
//   (warp_col_sum; control's CTREE tree), so there are no atomics and a
//   run repeats bit for bit. The stencil phases and control are the
//   functions of fv_phases.cuh. Control takes whole lanes: block b runs
//   lanes b, b + grid, ...; the barrier before it also orders its flag
//   writes after every block's correction has read the start flag.
// Products: an item computes one 16 x 16 output tile. The A row band and
//   the B column band stream through shared memory in slabs of KS = 32 k by
//   cp.async, in a ring of NST slabs, so that later slabs' loads overlap
//   this slab's FMAs; the bases V1, V2 and inv_lam are shared by all lanes
//   and stay in L2. Each output is the FMA chain over k ascending from 0 in
//   the working type, over the depth padded to a multiple of 16 with exact
//   zeros. No tensor cores: the JAX kernel computes at HIGHEST, TF32 would
//   change the solution, and FP64 mma would change the sum order; the
//   stage is bound by latency, not by FMAs.
// No fallback: a card without cooperative launch, or a grid whose items do
//   not fit MAX_ITEMS a co-resident block, is refused with an error.
#include <cooperative_groups.h>

#include "fv_phases.cuh"

namespace fv {
namespace {

namespace cg = cooperative_groups;

constexpr int MAX_ITEMS = 64;   // (tile, lane) items a block may take
constexpr int KS = 32;          // k depth of a product slab
constexpr int NST = 3;          // slabs in flight
constexpr int KPAD = 16;        // the depth is padded to a multiple of this
// Co-resident blocks an SM, at least: 4 in float32 (at most 64 registers,
// so that B = 8 lanes of 128 x 128 take one item a block), 3 in float64
// (80); ptxas reports no spill and no stack frame in either.
template <typename T>
constexpr int MIN_BLOCKS = sizeof(T) == 4 ? 4 : 3;

template <typename T>
struct Smem {
  union {
    struct {  // product phases: the A and B slabs, k-major
      T a[NST][KS][TILE + 1];
      T b[NST][KS][TILE + 1];
    } ring;
    struct {  // stencil phases: haloed tiles, the partials' values
      T sm[2][HT][HT];
      T pgs[HT + 2][HT + 2];
      T vals[NPART_C * NT];
    } st;
    struct {  // control: the tree's slots and the lane's sums
      T vals[NPART_CQ * NT];
      T sums[NPART_CQ];
    } ctl;
  };
  T sum;  // a lane mean's column sum
};

// One element global -> shared by cp.async; `valid` false reads nothing and
// writes a zero.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? (int)sizeof(T) : 0;
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v, opaque to the compiler: what is computed from it (the thread's
// indices, the lane's strides) is computed within each item, not hoisted
// out of the item loops into registers held for the whole launch, which
// spilled in float64 at the 80 registers of 3 blocks an SM.
__device__ __forceinline__ int per_item(int v) {
  asm volatile("mov.b32 %0, %0;" : "+r"(v));
  return v;
}

// Operands of product q of a solve (f = rhs_p, or res when refining):
// 0: g1 = V1^T (f - mean); 1: g2 = (g1 V2) * inv_lam; 2: g3 = V1 g2;
// 3: p' = g3 V2^T (+= when refining). C (ny, nx) = op(A) op(B), depth K.
template <typename T>
struct Product {
  const T *A, *B;
  T* C;
  int K, transA, transB;
};

template <typename T>
__device__ __forceinline__ Product<T> product_of(int q, bool refine,
                                                 const Grid<T>& g,
                                                 const Work<T>& w) {
  switch (q) {
    case 0: return {w.V1, refine ? w.res : w.rhsp, w.g1, g.ny, 1, 0};
    case 1: return {w.g1, w.V2, w.g2, g.nx, 0, 0};
    case 2: return {w.V1, w.g2, w.g3, g.ny, 0, 0};
    default: return {w.g3, w.V2, w.pp, g.nx, 0, 1};
  }
}

// Slab s (k in [s KS, s KS + KS)) of the A row band and the B column band
// of the tile at (r0, c0) into ring slot `slot`, as one cp.async group; two
// elements of each a thread, neighbouring threads on neighbouring
// addresses. Elements outside the operands are zeros.
template <typename T>
__device__ void load_slab(const Product<T>& P, int M, int N,
                          const TileCell& c, int s, int slot, Smem<T>& S) {
  const int k0 = s * KS, r0 = c.j0, c0 = c.i0;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = c.tid + u * NT;
    // A (M x K): row r0 + r, depth k0 + kk
    int r, kk;
    if (P.transA) { kk = e / TILE; r = e % TILE; }
    else { r = e / KS; kk = e % KS; }
    bool ok = r0 + r < M && k0 + kk < P.K;
    const T* src = P.A + (ok ? (P.transA ? (size_t)(k0 + kk) * M + r0 + r
                                         : (size_t)(r0 + r) * P.K + k0 + kk)
                             : 0);
    cp_async(&S.ring.a[slot][kk][r], src, ok);
    // B (K x N): depth k0 + kk, column c0 + cc
    int cc;
    if (P.transB) { cc = e / KS; kk = e % KS; }
    else { kk = e / TILE; cc = e % TILE; }
    ok = k0 + kk < P.K && c0 + cc < N;
    src = P.B + (ok ? (P.transB ? (size_t)(c0 + cc) * P.K + k0 + kk
                                : (size_t)(k0 + kk) * N + c0 + cc)
                    : 0);
    cp_async(&S.ring.b[slot][kk][cc], src, ok);
  }
  cp_commit();
}

// B - mean on this thread's own valid elements of a slab, as the separate
// kernel subtracted it on load (the zeros outside B stay zeros).
template <typename T>
__device__ void subtract_mean(const Product<T>& P, int N, const TileCell& c,
                              int s, int slot, T mean, Smem<T>& S) {
  const int k0 = s * KS, c0 = c.i0;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = c.tid + u * NT;
    int kk, cc;
    if (P.transB) { cc = e / KS; kk = e % KS; }
    else { kk = e / TILE; cc = e % TILE; }
    if (k0 + kk < P.K && c0 + cc < N) S.ring.b[slot][kk][cc] -= mean;
  }
}

// One output tile of product q: acc = sum over k ascending of
// fma(A(row, k), B(k, col), acc), then the epilogue (* inv_lam for q = 1,
// p' + acc for q = 3 when refining).
template <typename T>
__device__ void product(int q, bool refine, const Grid<T>& g,
                        const Work<T>& w, const TileCell& c, Smem<T>& S) {
  const int M = g.ny, N = g.nx;
  const Product<T> P = product_of(q, refine, g, w);
  const int kp = (P.K + KPAD - 1) / KPAD * KPAD;
  const int nslab = (kp + KS - 1) / KS;
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nslab) load_slab(P, M, N, c, s, s, S);
    else cp_commit();
  }
  T mean = 0;
  if (q == 0) mean = lane_mean(refine ? w.part_m2 : w.part_m, g, &S.sum);
  T acc = 0;
  for (int s = 0; s < nslab; ++s) {
    const int next = s + NST - 1;
    if (next < nslab) load_slab(P, M, N, c, next, next % NST, S);
    else cp_commit();
    cp_wait<NST - 1>();
    const int slot = s % NST;
    if (q == 0) subtract_mean(P, N, c, s, slot, mean, S);
    __syncthreads();
    const T(*a)[TILE + 1] = S.ring.a[slot];
    const T(*b)[TILE + 1] = S.ring.b[slot];
#pragma unroll
    for (int kk = 0; kk < KPAD; ++kk) acc = fma(a[kk][c.ty], b[kk][c.tx], acc);
    if (kp - s * KS > KPAD) {
#pragma unroll
      for (int kk = KPAD; kk < KS; ++kk)
        acc = fma(a[kk][c.ty], b[kk][c.tx], acc);
    }
    __syncthreads();
  }
  if (c.j < M && c.i < N) {
    const size_t o = (size_t)c.j * N + c.i;
    if (q == 1) acc *= w.inv_lam[o];
    if (q == 3 && refine) acc = P.C[o] + acc;
    P.C[o] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, MIN_BLOCKS<T>)
pressure_kernel(Grid<T> g0, Work<T> w0, int n_refine, Control<T> ctl,
                int with_control) {
  __shared__ Smem<T> S;
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (g0.nx + TILE - 1) / TILE;
  const int items = g0.nb * g0.lanes;
  // the items of this block, in the same order in every phase
  auto each = [&](auto phase) {
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int lane = it / g0.nb;
      Grid<T> g = at_lane(g0, lane);
      g.ny = per_item(g.ny);
      g.nx = per_item(g.nx);
      g.nb = per_item(g.nb);
      const Work<T> w = at_lane(w0, lane, g.ny, g.nx, g.nb);
      phase(g, w, tile_at(it % g0.nb, tiles_x, per_item(threadIdx.x)));
    }
  };
  each([&](const Grid<T>& g, const Work<T>& w, const TileCell& c) {
    rhie_chow(g, w, c, S.st.sm, S.st.vals);
  });
  for (int r = 0; r <= n_refine; ++r) {
    if (r > 0) {
      grid.sync();
      each([&](const Grid<T>& g, const Work<T>& w, const TileCell& c) {
        residual(g, w, c, lane_mean(w.part_m, g, &S.sum), S.st.vals);
      });
    }
    for (int q = 0; q < 4; ++q) {
      grid.sync();
      each([&](const Grid<T>& g, const Work<T>& w, const TileCell& c) {
        product(q, r > 0, g, w, c, S);
      });
    }
  }
  grid.sync();
  each([&](const Grid<T>& g, const Work<T>& w, const TileCell& c) {
    correct(g, w, c, S.st.sm, S.st.pgs, S.st.vals);
  });
  grid.sync();
  each([&](const Grid<T>& g, const Work<T>& w, const TileCell& c) {
    metrics(g, w, c, S.st.sm, S.st.vals);
  });
  if (!with_control) return;
  grid.sync();
  for (int lane = blockIdx.x; lane < g0.lanes; lane += gridDim.x) {
    Grid<T> g = at_lane(g0, lane);
    g.nb = per_item(g.nb);
    const Work<T> w = at_lane(w0, lane, g.ny, g.nx, g.nb);
    control(g, w, ctl, per_item(threadIdx.x), S.ctl.vals, S.ctl.sums);
  }
}

}  // namespace

template <typename T>
cudaError_t pressure_coresident(int* blocks) {
  static int cached = 0;
  if (cached) {
    *blocks = cached;
    return cudaSuccess;
  }
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pressure_kernel<T>, NT, 0);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return err;
  cached = per_sm * sms;
  *blocks = cached;
  return cudaSuccess;
}

namespace {

// The rule of anap3_tpu_torch/ops/fv_kernels.py:pressure_grid: a block an
// item, at most every co-resident block, refused above MAX_ITEMS items a
// block.
template <typename T>
cudaError_t pressure_grid(int ny, int nx, int lanes, int* blocks) {
  int most = 0;
  const cudaError_t err = pressure_coresident<T>(&most);
  if (err != cudaSuccess) return err;
  const int items = ((ny + TILE - 1) / TILE) * ((nx + TILE - 1) / TILE)
                    * lanes;
  if (ny < 1 || nx < 1 || lanes < 1) return cudaErrorInvalidValue;
  *blocks = items < most ? items : most;
  if ((items + *blocks - 1) / *blocks > MAX_ITEMS)
    return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace

template <typename T>
cudaError_t launch_pressure(const Grid<T>& g, const Work<T>& w, int n_refine,
                            const Control<T>* ctl, cudaStream_t s) {
  int blocks = 0;
  cudaError_t err = pressure_grid<T>(g.ny, g.nx, g.lanes, &blocks);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Control<T> c = ctl ? *ctl : Control<T>{};
  err = cudaLaunchKernelEx(&cfg, pressure_kernel<T>, g, w, n_refine, c,
                           ctl ? 1 : 0);
  return err != cudaSuccess ? err : cudaGetLastError();
}

#define FV_INSTANTIATE(T)                                                   \
  template cudaError_t pressure_coresident<T>(int*);                        \
  template cudaError_t launch_pressure<T>(const Grid<T>&, const Work<T>&,   \
                                          int, const Control<T>*,           \
                                          cudaStream_t);
FV_INSTANTIATE(float)
FV_INSTANTIATE(double)
#undef FV_INSTANTIATE

}  // namespace fv
