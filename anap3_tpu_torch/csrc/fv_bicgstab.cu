// fv_bicgstab: the momentum predictor of one SIMPLE iteration, one
// cooperative launch: the assembly, then the fixed-count joint u/v
// Jacobi-BiCGSTAB.
//
// Replaces: the assembly part of the body _make_iterate of
//   anap3_tpu/ops/pallas_fv.py (make_pallas_fv_step,
//   make_pallas_fv_chunk_runner): cell_gradient, the momentum coefficients,
//   the psi == 1 deferred correction, the Patankar right-hand sides and r0;
//   then bicg_iter, its fori_loop body: K warm-started iterations with the
//   breakdown guard active = ||r||^2 > 1e-16 (||rhs||^2 + 1e-30), every
//   scalar frozen by sel() once inactive, 1e-30 in every divisor, and the
//   Pallas operation order in rho/beta/alpha/omega. The guard constants are
//   the Pallas kernel's float32 choices and stay the same in float64.
//
// Bound on the card: a chain of dependent grid-wide inner products
//   (<rh,r> and ||r||^2 -> rho and the guard; <rh,v> -> alpha; <t,s> and
//   <t,t> -> omega): three grid-wide barriers per iteration, 48 a solve at
//   K=16. The arithmetic (two 5-point applies on 2 x 16K cells at N=128) is
//   far below a microsecond; the chain is latency: a grid barrier costs
//   1.2-1.7 us at 64-512 blocks, a launch 3.1-3.6 us (scripts/
//   launch_floor.cu, H100 700 W), so one launch with 48 barriers (the
//   assembly's and the solve's 47) replaces 49 launches.
// Design: one persistent cooperative launch (cudaLaunchAttributeCooperative)
//   of min(tiles x lanes, co-resident) blocks of 256 threads, a thread a
//   cell of a 16 x 16 tile; block
//   blockIdx.x takes the (tile, lane) items blockIdx.x, blockIdx.x + grid,
//   ... in every phase: the assembly (fv_phases.cuh), then K x (direction,
//   stabilize, update), with a grid barrier between phases (the assembly
//   as a phase costs a 1.2-1.7 us barrier, as a launch 3.1-3.6 us). Each
//   phase starts by reducing the previous
//   phase's per-tile partials of its lane in every block, so every block
//   holds the same scalars without atomics; the direction phase computes p
//   on its haloed tile (from r, p_old, v_old of the previous phases) so v =
//   A M p needs no extra barrier; the stabilize phase does the same for s
//   and t = A M s; the update phase applies x and r and writes the next
//   <rh,r>, ||r||^2 partials. p and v alternate between two buffers so no
//   block overwrites a value another block still reads.
//   The reductions keep the three-launch kernel's bits: the partials are
//   indexed by tile, not by block, each tile's partial is the 256-slot
//   fixed-order tree of its cells, and each lane sum the 256-slot tree of
//   the thread sums over the tiles; a warp a column computes the tree's
//   first three levels from eight values and its last five by
//   __shfl_down_sync at strides 16..1, which pairs lane l with l + s as the
//   tree does (warp_col_sum and write_partials of fv_phases.cuh), so all
//   columns of a phase are summed in one pass with one __syncthreads
//   instead of 9 a column. The loads that do not depend on the phase's
//   scalars are issued before its lane sums, so that their latency
//   overlaps the reductions. The scalars of an iteration (rho,
//   alpha, omega, the guard) stay in shared memory per item across phases,
//   from the start values the assembly writes into the lane's slot.
// Lanes: a lane's items reduce their own lane's partials, so its rho,
//   alpha, omega and breakdown guard are its own (the per-lane scalars of
//   anap3_tpu/ops/pallas_fv_lanes.py make_fv_lane_runner's bicg_iter), and
//   lane b of a B-lane launch gives the bits of a one-lane launch.
// No fallback: a card without cooperative launch, or a grid whose items do
//   not fit MAX_ITEMS a co-resident block, is refused with an error.
#include <cooperative_groups.h>

#include "fv_phases.cuh"

namespace fv {
namespace {

namespace cg = cooperative_groups;

constexpr double kEps = 1e-30;
constexpr double kGuard = 1e-16;
constexpr int MAX_ITEMS = 64;  // (tile, lane) items a block may take

// Per-item scalars in shared memory: rho (rho_k, then rho1), alpha, omega,
// ||rhs||^2 + eps, and the guard (1 or 0).
enum Sc { SC_RHO, SC_ALPHA, SC_OMEGA, SC_RHSN2, SC_ACTIVE, SC_COUNT };

template <typename T>
struct Smem {
  T sm[4][HT][HT];             // haloed tiles of the applies
  T vals[6 * NT];              // the threads' values of a phase's partials
  T sums[8];                   // the lane sums a phase starts from
  T sc[MAX_ITEMS][SC_COUNT];   // per item scalars, across phases
};

// One of the two alternating p (or v) buffers. A select, not an index: an
// array member indexed at run time would put the kernel's lane-shifted
// copy of the whole Work on the stack.
template <typename T>
__device__ __forceinline__ T* buf(T* const (&pair)[2], int parity) {
  return (parity & 1) ? pair[1] : pair[0];
}

// 5-point apply on a shared haloed tile (zero outside the grid), with the
// cell's coefficients a = (aP_rel, aE, aW, aN, aS)
template <typename T>
__device__ T apply_A(const T (&a)[5], T (*f)[HT], int hj, int hi) {
  return a[0] * f[hj][hi] + a[1] * f[hj][hi + 1] + a[2] * f[hj][hi - 1]
         + a[3] * f[hj + 1][hi] + a[4] * f[hj - 1][hi];
}

// A cell of the haloed tile that thread tid + u NT fills (u < HSLOTS):
// its grid index, whether it is on the grid and whether it is the
// block's own.
constexpr int HSLOTS = (HT * HT + NT - 1) / NT;
struct HaloCell {
  size_t k;
  int hj, hi;
  bool used, in, mine;
};

__device__ __forceinline__ HaloCell halo_cell(int u, int ny, int nx,
                                              const TileCell& c) {
  HaloCell h;
  const int e = c.tid + u * NT;
  h.used = e < HT * HT;
  h.hj = e / HT;
  h.hi = e % HT;
  const int jj = c.j0 - 1 + h.hj, ii = c.i0 - 1 + h.hi;
  h.in = h.used && jj >= 0 && jj < ny && ii >= 0 && ii < nx;
  h.mine = h.in && h.hj >= 1 && h.hj <= TILE && h.hi >= 1 && h.hi <= TILE;
  h.k = h.in ? (size_t)jj * nx + ii : 0;
  return h;
}

// The own cell's coefficients (zeros off the grid).
template <typename T>
__device__ __forceinline__ void load_coefs(const Work<T>& w, bool own,
                                           size_t k0, T (&a)[5]) {
  const T* src[5] = {w.aPr, w.aE, w.aW, w.aN, w.aS};
#pragma unroll
  for (int q = 0; q < 5; ++q) a[q] = own ? src[q][k0] : T(0);
}

template <typename T>
__device__ bool own_cell(const Grid<T>& g, const TileCell& c) {
  return c.j < g.ny && c.i < g.nx;
}

// rho1, beta, p = r + beta (p - omega v), v = A M p. Every phase issues
// the loads that do not depend on the iteration's scalars before the lane
// sums, so that their latency overlaps the reductions.
template <typename T>
__device__ void direction(int k, const Grid<T>& g, const Work<T>& w,
                          const TileCell& c, T* sc, Smem<T>& S) {
  const int n = g.ny * g.nx, wp = c.tid / 32;
  const T eps = T(kEps);
  const T* pv_old = buf(w.pv, k);
  const T* vv_old = buf(w.vv, k);
  T* pv_new = buf(w.pv, k + 1);
  T* vv_new = buf(w.vv, k + 1);
  HaloCell hc[HSLOTS];
  T hr[HSLOTS][2], hp[HSLOTS][2], hv[HSLOTS][2], ha[HSLOTS];
#pragma unroll
  for (int u = 0; u < HSLOTS; ++u) {
    hc[u] = halo_cell(u, g.ny, g.nx, c);
    ha[u] = hc[u].in ? w.aPr[hc[u].k] : T(1);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const size_t o = (size_t)q * n + hc[u].k;
      hr[u][q] = hc[u].in ? w.r[o] : T(0);
      hp[u][q] = hc[u].in ? pv_old[o] : T(0);
      hv[u][q] = hc[u].in ? vv_old[o] : T(0);
    }
  }
  const bool own = own_cell(g, c);
  const size_t k0 = own ? (size_t)c.j * g.nx + c.i : 0;
  T a[5], rh[2], vo[2];
  load_coefs(w, own, k0, a);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    rh[q] = own ? w.rh[(size_t)q * n + k0] : T(0);
    vo[q] = own ? vv_old[(size_t)q * n + k0] : T(0);
  }
  // ||r||^2 and <rh,r> by component; at k = 0 also ||rhs||^2
  if (wp < 4) {
    const T v = warp_col_sum(w.part_r, 4, wp, g.nb);
    if (c.tid % 32 == 0) S.sums[wp] = v;
  } else if (k == 0 && wp < 6) {
    const T v = warp_col_sum(w.part_rhs, 2, wp - 4, g.nb);
    if (c.tid % 32 == 0) S.sums[wp] = v;
  }
  __syncthreads();
  const T rr = S.sums[0] + S.sums[1];
  const T rhr = S.sums[2] + S.sums[3];
  T rhsn2, rho_k, alpha_k, omega_k;
  if (k == 0) {  // the start values the assembly wrote
    rhsn2 = (S.sums[4] + S.sums[5]) + eps;
    rho_k = w.slots[SL_RHO];
    alpha_k = w.slots[SL_ALPHA];
    omega_k = w.slots[SL_OMEGA];
  } else {
    rhsn2 = sc[SC_RHSN2];
    rho_k = sc[SC_RHO];
    alpha_k = sc[SC_ALPHA];
    omega_k = sc[SC_OMEGA];
  }
  const bool active = rr > T(kGuard) * rhsn2;
  const T rho1 = active ? rhr : rho_k;
  const T beta = (rho1 / (rho_k + eps)) * (alpha_k / (omega_k + eps));
#pragma unroll
  for (int u = 0; u < HSLOTS; ++u) {
    if (!hc[u].used) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      T ph = 0;
      if (hc[u].in) {
        const T po = hp[u][q];
        const T pn = active ? hr[u][q] + beta * (po - omega_k * hv[u][q])
                            : po;
        if (hc[u].mine) pv_new[(size_t)q * n + hc[u].k] = pn;
        ph = pn / ha[u];
      }
      S.sm[q][hc[u].hj][hc[u].hi] = ph;
    }
  }
  __syncthreads();
  T pr[2] = {0, 0};
  if (own) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const T vn = active ? apply_A(a, S.sm[q], c.ty + 1, c.tx + 1) : vo[q];
      vv_new[(size_t)q * n + k0] = vn;
      pr[q] = rh[q] * vn;
    }
  }
  write_partials(pr, S.vals, w.part_v, c.b);  // every thread has read sc
  if (c.tid == 0) {
    sc[SC_RHO] = rho1;
    sc[SC_ALPHA] = alpha_k;
    sc[SC_OMEGA] = omega_k;
    sc[SC_RHSN2] = rhsn2;
    sc[SC_ACTIVE] = active ? T(1) : T(0);
  }
}

// alpha, s = r - alpha v, t = A M s
template <typename T>
__device__ void stabilize(int k, const Grid<T>& g, const Work<T>& w,
                          const TileCell& c, T* sc, Smem<T>& S) {
  const int n = g.ny * g.nx, wp = c.tid / 32;
  const T eps = T(kEps);
  const T* vv_new = buf(w.vv, k + 1);
  HaloCell hc[HSLOTS];
  T hr[HSLOTS][2], hv[HSLOTS][2], ha[HSLOTS];
#pragma unroll
  for (int u = 0; u < HSLOTS; ++u) {
    hc[u] = halo_cell(u, g.ny, g.nx, c);
    ha[u] = hc[u].in ? w.aPr[hc[u].k] : T(1);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const size_t o = (size_t)q * n + hc[u].k;
      hr[u][q] = hc[u].in ? w.r[o] : T(0);
      hv[u][q] = hc[u].in ? vv_new[o] : T(0);
    }
  }
  const bool own = own_cell(g, c);
  const size_t k0 = own ? (size_t)c.j * g.nx + c.i : 0;
  T a[5];
  load_coefs(w, own, k0, a);
  if (wp < 2) {
    const T v = warp_col_sum(w.part_v, 2, wp, g.nb);
    if (c.tid % 32 == 0) S.sums[wp] = v;
  }
  __syncthreads();
  const T rvv = S.sums[0] + S.sums[1];
  const bool active = sc[SC_ACTIVE] != T(0);
  const T alpha = active ? sc[SC_RHO] / (rvv + eps) : sc[SC_ALPHA];
#pragma unroll
  for (int u = 0; u < HSLOTS; ++u) {
    if (!hc[u].used) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      T s = 0, sh = 0;
      if (hc[u].in) {
        s = hr[u][q] - alpha * hv[u][q];
        sh = s / ha[u];
      }
      S.sm[q][hc[u].hj][hc[u].hi] = sh;
      S.sm[2 + q][hc[u].hj][hc[u].hi] = s;
    }
  }
  __syncthreads();
  T pr[4] = {0, 0, 0, 0};
  if (own) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const size_t o = (size_t)q * n + k0;
      const T s = S.sm[2 + q][c.ty + 1][c.tx + 1];
      const T t = apply_A(a, S.sm[q], c.ty + 1, c.tx + 1);
      w.s[o] = s;
      w.t[o] = t;
      pr[q] = t * s;
      pr[2 + q] = t * t;
    }
  }
  write_partials(pr, S.vals, w.part_t, c.b);
  if (c.tid == 0) sc[SC_ALPHA] = alpha;
}

// omega, x += alpha M p + omega M s, r = s - omega t; next <rh,r>, ||r||^2
template <typename T>
__device__ void update(int k, const Grid<T>& g, const Work<T>& w,
                       const TileCell& c, T* sc, Smem<T>& S) {
  const int n = g.ny * g.nx, wp = c.tid / 32;
  const T eps = T(kEps);
  const T* pv_new = buf(w.pv, k + 1);
  const bool own = own_cell(g, c);
  const size_t k0 = own ? (size_t)c.j * g.nx + c.i : 0;
  const T aPr = own ? w.aPr[k0] : T(1);
  T x[2], r[2], s[2], t[2], p[2], rh[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const size_t o = (size_t)q * n + k0;
    x[q] = own ? w.x[o] : T(0);
    r[q] = own ? w.r[o] : T(0);
    s[q] = own ? w.s[o] : T(0);
    t[q] = own ? w.t[o] : T(0);
    p[q] = own ? pv_new[o] : T(0);
    rh[q] = own ? w.rh[o] : T(0);
  }
  if (wp < 4) {
    const T v = warp_col_sum(w.part_t, 4, wp, g.nb);
    if (c.tid % 32 == 0) S.sums[wp] = v;
  }
  __syncthreads();
  const T ts = S.sums[0] + S.sums[1];
  const T tt = S.sums[2] + S.sums[3];
  const bool active = sc[SC_ACTIVE] != T(0);
  const T omega = active ? ts / (tt + eps) : sc[SC_OMEGA];
  const T alpha = sc[SC_ALPHA];
  T pr[4] = {0, 0, 0, 0};
  if (own) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const size_t o = (size_t)q * n + k0;
      T rn = r[q];
      if (active) {
        w.x[o] = x[q] + alpha * (p[q] / aPr) + omega * (s[q] / aPr);
        rn = s[q] - omega * t[q];
        w.r[o] = rn;
      }
      pr[q] = rn * rn;
      pr[2 + q] = rh[q] * rn;
    }
  }
  write_partials(pr, S.vals, w.part_r, c.b);
  if (c.tid == 0) sc[SC_OMEGA] = omega;
}

// `with_assembly` 0 skips the assembly and starts from the workspace's
// last solve (the bench entry's timing of the solve alone).
template <typename T>
__global__ void __launch_bounds__(NT)
bicg_kernel(Grid<T> g, Work<T> w0, int upwind, int with_assembly) {
  __shared__ Smem<T> S;
  cg::grid_group grid = cg::this_grid();
  const int tiles_x = (g.nx + TILE - 1) / TILE;
  const int items = g.nb * g.lanes;
  if (with_assembly) {
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int lane = it / g.nb;
      const Work<T> w = at_lane(w0, lane, g.ny, g.nx, g.nb);
      assemble(at_lane(g, lane), w, upwind, tile_at(it % g.nb, tiles_x),
               S.vals);
    }
    grid.sync();
  }
  // the items of this block, in the same order in every phase
  auto each = [&](auto phase) {
    for (int it = blockIdx.x, i = 0; it < items; it += gridDim.x, ++i) {
      const int lane = it / g.nb;
      const Work<T> w = at_lane(w0, lane, g.ny, g.nx, g.nb);
      phase(w, tile_at(it % g.nb, tiles_x), S.sc[i]);
    }
  };
  for (int k = 0; k < g.K; ++k) {
    each([&](const Work<T>& w, const TileCell& c, T* sc) {
      direction(k, g, w, c, sc, S);
    });
    grid.sync();
    each([&](const Work<T>& w, const TileCell& c, T* sc) {
      stabilize(k, g, w, c, sc, S);
    });
    grid.sync();
    each([&](const Work<T>& w, const TileCell& c, T* sc) {
      update(k, g, w, c, sc, S);
    });
    if (k + 1 < g.K) grid.sync();
  }
}

// Co-resident blocks of bicg_kernel<T> on the current device (0 with the
// error in *err when the card cannot launch it cooperatively).
template <typename T>
int coresident_blocks(cudaError_t* err) {
  static int blocks = 0;
  if (blocks) return blocks;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (*err == cudaSuccess && !coop) *err = cudaErrorNotSupported;
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bicg_kernel<T>, NT, 0);
  if (*err == cudaSuccess && per_sm < 1)
    *err = cudaErrorCooperativeLaunchTooLarge;
  if (*err != cudaSuccess) return 0;
  blocks = per_sm * sms;
  return blocks;
}

}  // namespace

template <typename T>
cudaError_t launch_bicg(const Grid<T>& g, const Work<T>& w, int upwind,
                        int with_assembly, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  const int most = coresident_blocks<T>(&err);
  if (!most) return err;
  const int items = g.nb * g.lanes;
  const int blocks = items < most ? items : most;
  if ((items + blocks - 1) / blocks > MAX_ITEMS)
    return cudaErrorCooperativeLaunchTooLarge;
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
  err = cudaLaunchKernelEx(&cfg, bicg_kernel<T>, g, w, upwind,
                           with_assembly);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template cudaError_t launch_bicg<float>(const Grid<float>&,
                                        const Work<float>&, int, int,
                                        cudaStream_t);
template cudaError_t launch_bicg<double>(const Grid<double>&,
                                         const Work<double>&, int, int,
                                         cudaStream_t);

}  // namespace fv
