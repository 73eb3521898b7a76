// Shared declarations of the FV-SIMPLE kernels (fv_bicgstab.cu,
// fv_pressure.cu: two cooperative launches an iteration) and their C host
// entries (fv_host.cu); the device functions that both kernels run are in
// fv_phases.cuh.
//
// Layout: cell fields are (ny, nx) row-major, index [j * nx + i]; the state's
// face fluxes are unpadded, mx (ny, nx-1) and my (ny-1, nx), as
// anap3_tpu_torch/models/fv.py holds them; the u/v pairs of the joint
// BiCGSTAB are (2, ny, nx). Every kernel is templated on the working type T
// (float or double) and accumulates in T.
//
// Tile kernels run one thread per cell on TILE x TILE tiles; a block that
// needs a field at its neighbours' cells computes it on the haloed
// (TILE+2)^2 tile into shared memory from values of the previous launch
// or of the phase before its last grid barrier. Grid-wide sums go through
// per-tile partials that the NEXT launch or phase reduces, in a fixed
// order, in every block: no atomics, and a run repeats bit for bit.
//
// Lanes: every kernel runs B independent solves ("lanes") of one grid in one
// launch, a block taking (tile, lane) items (and, in the control phase,
// whole lanes). The pressure solve's operators (V1, V2, inv_lam, A1, A2)
// are shared; the scalars (mu, alpha_uv, alpha_p, rho, lid), the boundary
// statics aP_bc and b_bc_u, the state, every work array, partial table,
// BiCGSTAB slot, flag and row are per lane, lane b at b times the lane
// stride of its buffer (at_lane below). A lane reads and writes nothing of
// another lane (its halo reads stop at its own grid's edge), and its
// arithmetic does not depend on B, so lane b of a B-lane call gives the
// bits of a one-lane call on its data. The single solves (step, chunk) are
// the B = 1 case.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fv {

constexpr int TILE = 16;
constexpr int NT = TILE * TILE;    // threads of a tile block
constexpr int HT = TILE + 2;       // haloed tile edge

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
  P_SLOTS,     // (SL_COUNT,) BiCGSTAB start values (see Slot)
  P_METRICS,   // step: (6,)
  P_ROWS,      // chunk: (chunk, lanes, 7) rows in runner.METRIC_KEYS order
  P_FLAGS,     // chunk: int32 (lanes, 3): done, conv_iter, converged
  P_REF,       // chunk: (lanes,) the residual criterion's normalization
  P_LSC,       // (lanes, H_COUNT) per-lane scalars in the working type
  P_COUNT
};

// Columns of the per-lane scalar table, in the order of
// fv_kernels.py:scalar_table (each the host double cast to T by torch).
enum Scal { H_MU, H_DX, H_DY, H_AUV, H_AP, H_RHO, H_LID, H_PAD, H_COUNT };

// The BiCGSTAB start values rho, alpha, omega = 1, 1, 1 of a lane: the
// assembly writes them, the solve reads them and keeps its scalars on chip.
enum Slot { SL_RHO, SL_ALPHA, SL_OMEGA, SL_COUNT };

// c1 partials: |u'|^2, |v'|^2, sum(u_n^2 + v_n^2), |u_n - u|^2,
// |v_n - v|^2, |u|^2, |v|^2.
constexpr int NPART_C = 7;
constexpr int NPART_Q = 3;

// Kernel counts reported to the wrapper's launch counters.
enum Count { C_BICG, C_PRESSURE, C_COUNT };

template <typename T>
struct Grid {
  int ny, nx, nb, K, lanes;
  const T* lsc;  // (lanes, H_COUNT)
  // lane b's scalars, set by at_lane
  T mu, dx, dy, auv, ap, rho, lid;
  T vol, Dxc, Dyc;
};

template <typename T>
Grid<T> make_grid(const void* const* P, int ny, int nx, int K, int lanes) {
  Grid<T> g;
  g.ny = ny;
  g.nx = nx;
  g.nb = ((ny + TILE - 1) / TILE) * ((nx + TILE - 1) / TILE);
  g.K = K;
  g.lanes = lanes;
  g.lsc = static_cast<const T*>(P[P_LSC]);
  g.mu = g.dx = g.dy = g.auv = g.ap = g.rho = g.lid = T(0);
  g.vol = g.Dxc = g.Dyc = T(0);
  return g;
}

// The grid as lane b sees it: its scalars, and the derived ones in the
// working type (the same IEEE operations as a host computation in T).
template <typename T>
__device__ __forceinline__ Grid<T> at_lane(Grid<T> g, int b) {
  const T* s = g.lsc + (size_t)b * H_COUNT;
  g.mu = s[H_MU]; g.dx = s[H_DX]; g.dy = s[H_DY];
  g.auv = s[H_AUV]; g.ap = s[H_AP]; g.rho = s[H_RHO]; g.lid = s[H_LID];
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
  T* ref_norm;
};

// The buffers as lane b sees them (shared operators stay). Rows are lane
// b's slot of row 0: row r is r * lanes * 7 further on. The one-lane
// entries pass null for the outputs they do not write, which lane 0 keeps
// (null + 0 is null), and a lane b > 0 exists only in a lane chunk, whose
// buffers are all allocated. No branch on b: each pointer is its lane-0
// value plus a product the compiler can recompute where it is used, which
// keeps the cooperative kernels' registers free of ~50 lane pointers.
template <typename T>
__device__ __forceinline__ Work<T> at_lane(Work<T> w, int b, int ny, int nx,
                                           int nb) {
  const size_t c = (size_t)ny * nx, B = (size_t)b;
  auto off = [&](auto* p, size_t stride) { return p + B * stride; };
  w.aP_bc = off(w.aP_bc, c); w.b_bc_u = off(w.b_bc_u, c);
  w.u = off(w.u, c); w.v = off(w.v, c); w.p = off(w.p, c);
  w.mx = off(w.mx, (size_t)ny * (nx - 1));
  w.my = off(w.my, (size_t)(ny - 1) * nx);
  w.gpx = off(w.gpx, c); w.gpy = off(w.gpy, c); w.aPr = off(w.aPr, c);
  w.aE = off(w.aE, c); w.aW = off(w.aW, c); w.aN = off(w.aN, c);
  w.aS = off(w.aS, c); w.Du = off(w.Du, c);
  w.x = off(w.x, 2 * c); w.r = off(w.r, 2 * c); w.rh = off(w.rh, 2 * c);
  w.pv[0] = off(w.pv[0], 2 * c); w.pv[1] = off(w.pv[1], 2 * c);
  w.vv[0] = off(w.vv[0], 2 * c); w.vv[1] = off(w.vv[1], 2 * c);
  w.s = off(w.s, 2 * c); w.t = off(w.t, 2 * c);
  w.mxs = off(w.mxs, c); w.mys = off(w.mys, c); w.rhsp = off(w.rhsp, c);
  w.res = off(w.res, c); w.g1 = off(w.g1, c); w.g2 = off(w.g2, c);
  w.g3 = off(w.g3, c); w.pp = off(w.pp, c);
  const size_t n = (size_t)nb;
  w.part_rhs = off(w.part_rhs, 2 * n); w.part_r = off(w.part_r, 4 * n);
  w.part_v = off(w.part_v, 2 * n); w.part_t = off(w.part_t, 4 * n);
  w.part_m = off(w.part_m, n); w.part_m2 = off(w.part_m2, n);
  w.part_c = off(w.part_c, NPART_C * n); w.part_q = off(w.part_q, NPART_Q * n);
  w.slots = off(w.slots, SL_COUNT);
  w.metrics = off(w.metrics, 6);
  w.rows = off(w.rows, 7);
  w.flags = off(w.flags, 3);
  w.ref_norm = off(w.ref_norm, 1);
  return w;
}

// max that propagates NaN from either side (torch.maximum / jnp.maximum)
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

// Tile-block geometry: this thread's cell (j, i) and its tile's index b.
struct TileCell {
  int j, i, ty, tx, tid, j0, i0, b;
};

// The convergence state machine's arguments of one iteration of a chunk
// (history row `row`, global iteration `idx`) or of a step (rows null).
// ref_norm (Work) is read and written only when use_residual is set.
template <typename T>
struct Control {
  int row, idx, warmup, use_residual;
  T tol;
};

// Launchers, defined and instantiated for float and double in the .cu file
// of each kernel, each for g.lanes lanes at once (pointers are lane 0's).
// None synchronizes; each returns cudaGetLastError(). Both launches are
// cooperative and refused (an error, never another path) where the card
// cannot launch them.
// The assembly (gradient, momentum coefficients, deferred correction,
// right-hand sides, r0 and the start values; skipped when with_assembly
// is 0, which only the bench entry asks for) and the whole K-iteration
// solve.
template <typename T>
cudaError_t launch_bicg(const Grid<T>& g, const Work<T>& w, int upwind,
                        int with_assembly, cudaStream_t s);
// Rhie-Chow, the pressure solve with n_refine refinement steps, the
// corrections, the metrics' partials and, unless `ctl` is null (the bench
// entry only), control: the metrics or the history row and the state
// machine. The grid is the rule of
// anap3_tpu_torch/ops/fv_kernels.py:pressure_grid; pressure_coresident
// gives the card's co-resident blocks of the kernel.
template <typename T>
cudaError_t launch_pressure(const Grid<T>& g, const Work<T>& w, int n_refine,
                            const Control<T>* ctl, cudaStream_t s);
template <typename T>
cudaError_t pressure_coresident(int* blocks);

}  // namespace fv
