// fv_stencil: the elementwise and 5-point phases of one SIMPLE iteration.
//
// Replaces: the stencil parts of the body _make_iterate of
//   anap3_tpu/ops/pallas_fv.py (make_pallas_fv_step, make_pallas_fv_chunk_
//   runner): cell_gradient, the momentum coefficients, the psi == 1
//   deferred correction, the Patankar right-hand sides and r0; Rhie-Chow
//   compact face fluxes and -div(mdot*); the refinement residual of the
//   pressure solve; the corrections; the FD-ghost metrics.
//
// Bound on the card: latency. At N=128 a phase touches ~10 (ny, nx) arrays
//   (~0.6 MB in float32, L2-resident) with 64 blocks of 256 threads, a few
//   microseconds that the launch and the dependent global loads dominate.
// Design: one templated kernel, five phases, one launch each. A phase that
//   needs a derived field at neighbouring cells (Rhie-Chow fluxes, u' and
//   v', the vorticity) computes it on the block's haloed tile into shared
//   memory from the previous launch's outputs, so every value a cell sees is
//   computed by one code path. The grid-wide sums (means, norms, metrics)
//   are per-block partials that the next launch reduces in a fixed order.
//   The correction phase updates the state in place, guarded by the done
//   flag the step started with, so a chunk needs no commit copy (it reads
//   no neighbour of the old state). The refinement residual A1 p' + p' A2^T
//   is the tridiagonal stencil it is, summed in the dense product's order
//   (k ascending, FMA), not a dense product: the rounding differs from
//   fv_dense's by the zero terms it skips, which are exact.
// Lanes: the lane is the grid's z axis; lane b's blocks run the one-lane
//   code on lane b's buffers and scalars (fv_common.cuh), which replaces
//   the row-stacked layout and the where-selects of
//   anap3_tpu/ops/pallas_fv_lanes.py make_fv_lane_runner: a halo read
//   outside a lane's grid is a zero, never a neighbour lane's cell.
#include "fv_common.cuh"

namespace fv {
namespace {

template <typename T>
struct Cells {
  const Grid<T>& g;
  __device__ bool in(int j, int i) const {
    return j >= 0 && j < g.ny && i >= 0 && i < g.nx;
  }
  // a cell field, zero outside the grid (the Pallas shifts' zero padding)
  __device__ T at(const T* a, int j, int i) const {
    return in(j, i) ? a[(size_t)j * g.nx + i] : T(0);
  }
  // padded face fluxes of the state: zero on the boundary faces
  __device__ T mx(const T* a, int j, int i) const {
    return (j >= 0 && j < g.ny && i >= 0 && i < g.nx - 1)
               ? a[(size_t)j * (g.nx - 1) + i] : T(0);
  }
  __device__ T my(const T* a, int j, int i) const {
    return (j >= 0 && j < g.ny - 1 && i >= 0 && i < g.nx)
               ? a[(size_t)j * g.nx + i] : T(0);
  }
};

// Unlimited central gradient with the pinned cell 0 (its neighbours skip
// it), one-sided at walls; f(j, i) reads the field.
template <typename T, typename F>
__device__ void grad_pinned(const Grid<T>& g, F f, int j, int i, T& gx,
                            T& gy) {
  const T phi = f(j, i);
  const bool he = i < g.nx - 1, hw = i > 0 && !(j == 0 && i == 1);
  const bool hn = j < g.ny - 1, hs = j > 0 && !(j == 1 && i == 0);
  const T sx = (he ? (f(j, i + 1) - phi) / g.dx : T(0))
               + (hw ? (phi - f(j, i - 1)) / g.dx : T(0));
  const int cx = int(he) + int(hw);
  gx = cx > 0 ? sx / T(cx) : T(0);
  const T sy = (hn ? (f(j + 1, i) - phi) / g.dy : T(0))
               + (hs ? (phi - f(j - 1, i)) / g.dy : T(0));
  const int cy = int(hn) + int(hs);
  gy = cy > 0 ? sy / T(cy) : T(0);
  if (j == 0 && i == 0) gx = gy = T(0);
}

// FD ghost derivative along x / y (ghost = 2 bc - interior; the side walls
// have bc = 0; two_bc is 2 bc on the top wall).
template <typename T, typename F>
__device__ T fd_dx(const Grid<T>& g, F f, int j, int i) {
  const T c = f(j, i), dx2 = T(2) * g.dx;
  if (i == 0) return (f(j, i + 1) + c) / dx2;
  if (i == g.nx - 1) return ((-c) - f(j, i - 1)) / dx2;
  return (f(j, i + 1) - f(j, i - 1)) / dx2;
}

template <typename T, typename F>
__device__ T fd_dy(const Grid<T>& g, F f, int j, int i, T two_bc) {
  const T c = f(j, i), dy2 = T(2) * g.dy;
  if (j == 0) return (f(j + 1, i) + c) / dy2;
  if (j == g.ny - 1) return ((two_bc - c) - f(j - 1, i)) / dy2;
  return (f(j + 1, i) - f(j - 1, i)) / dy2;
}

template <typename T>
__device__ void write_partial(T* part, int ncol, int col, T v, T* red,
                              const TileCell& c) {
  v = block_sum(v, red, c.tid, NT);
  if (c.tid == 0) part[(size_t)c.b * ncol + col] = v;
}

// (a) gradient, coefficients, deferred correction, rhs, r0 = rhs - A x0.
template <typename T>
__device__ void assemble(const Grid<T>& g, const Work<T>& w, int upwind,
                         T* red) {
  const TileCell c = tile_cell();
  const Cells<T> C{g};
  const int n = g.ny * g.nx;
  const bool own = C.in(c.j, c.i);
  const int j = c.j, i = c.i;
  const size_t k = (size_t)j * g.nx + i;
  T pr[6] = {0, 0, 0, 0, 0, 0};  // |rhs|^2, |r|^2, <rh,r> per component
  if (own) {
    T gpx, gpy;
    grad_pinned(g, [&](int jj, int ii) { return C.at(w.p, jj, ii); }, j, i,
                gpx, gpy);
    const bool he = i < g.nx - 1, hw = i > 0, hn = j < g.ny - 1, hs = j > 0;
    const T mxE = C.mx(w.mx, j, i), mxW = C.mx(w.mx, j, i - 1);
    const T myN = C.my(w.my, j, i), myS = C.my(w.my, j - 1, i);
    const T zero = T(0);
    const T aE = he ? -(fmax(-mxE, zero) + g.Dxc) : zero;
    const T aW = hw ? -(fmax(mxW, zero) + g.Dxc) : zero;
    const T aN = hn ? -(fmax(-myN, zero) + g.Dyc) : zero;
    const T aS = hs ? -(fmax(myS, zero) + g.Dyc) : zero;
    const T aP = (he ? fmax(mxE, zero) + g.Dxc : zero)
                 + (hw ? fmax(-mxW, zero) + g.Dxc : zero)
                 + (hn ? fmax(myN, zero) + g.Dyc : zero)
                 + (hs ? fmax(-myS, zero) + g.Dyc : zero) + w.aP_bc[k];
    const T aPr = aP / g.auv;
    T def[2] = {zero, zero};
    if (!upwind) {
      // psi == 1: the face source |m| (N - P) / 2 for both flux signs
      const T* phis[2] = {w.u, w.v};
      for (int q = 0; q < 2; ++q) {
        const T* ph = phis[q];
        auto dcx = [&](int jj, int ii) {
          return ii < g.nx - 1 ? (T(0.5) * fabs(C.mx(w.mx, jj, ii)))
                                     * (C.at(ph, jj, ii + 1) - C.at(ph, jj, ii))
                               : zero;
        };
        auto dcy = [&](int jj, int ii) {
          return jj < g.ny - 1 ? (T(0.5) * fabs(C.my(w.my, jj, ii)))
                                     * (C.at(ph, jj + 1, ii) - C.at(ph, jj, ii))
                               : zero;
        };
        def[q] = ((-dcx(j, i) + (hw ? dcx(j, i - 1) : zero)) - dcy(j, i))
                 + (hs ? dcy(j - 1, i) : zero);
      }
    }
    const T b_u = (w.b_bc_u[k] + def[0]) - gpx * g.vol;
    const T b_v = def[1] - gpy * g.vol;
    const T scale = (T(1) - g.auv) / g.auv;
    const T u = w.u[k], v = w.v[k];
    const T rhs[2] = {b_u + (scale * aP) * u, b_v + (scale * aP) * v};
    const T* xs[2] = {w.u, w.v};
    for (int q = 0; q < 2; ++q) {
      const T* x = xs[q];
      const T Ax = aPr * x[k] + aE * C.at(x, j, i + 1) + aW * C.at(x, j, i - 1)
                   + aN * C.at(x, j + 1, i) + aS * C.at(x, j - 1, i);
      const T r0 = rhs[q] - Ax;
      const size_t o = (size_t)q * n + k;
      w.x[o] = x[k];
      w.r[o] = r0;
      w.rh[o] = r0;
      w.pv[0][o] = zero;
      w.vv[0][o] = zero;
      pr[q] = rhs[q] * rhs[q];
      pr[2 + q] = r0 * r0;
      pr[4 + q] = r0 * r0;
    }
    w.gpx[k] = gpx;
    w.gpy[k] = gpy;
    w.aPr[k] = aPr;
    w.aE[k] = aE;
    w.aW[k] = aW;
    w.aN[k] = aN;
    w.aS[k] = aS;
    w.Du[k] = g.vol / (aP + T(1e-14));
  }
  write_partial(w.part_rhs, 2, 0, pr[0], red, c);
  write_partial(w.part_rhs, 2, 1, pr[1], red, c);
  for (int q = 0; q < 4; ++q) write_partial(w.part_r, 4, q, pr[2 + q], red, c);
  if (c.b == 0 && c.tid == 0) {
    w.slots[SL_RHO] = T(1);
    w.slots[SL_ALPHA] = T(1);
    w.slots[SL_OMEGA] = T(1);
  }
}

// (b) Rhie-Chow compact face fluxes mdot* and rhs_p = -div(mdot*).
template <typename T>
__device__ void rhie_chow(const Grid<T>& g, const Work<T>& w, T (*sm)[HT][HT],
                          T* red) {
  const TileCell c = tile_cell();
  const Cells<T> C{g};
  const int n = g.ny * g.nx;
  const T* us = w.x;
  const T* vs = w.x + n;
  for (int h = c.tid; h < HT * HT; h += NT) {
    const int hj = h / HT, hi = h % HT;
    const int jj = c.j0 - 1 + hj, ii = c.i0 - 1 + hi;
    T fx = 0, fy = 0;
    if (C.in(jj, ii) && ii < g.nx - 1) {
      const T ubar = T(0.5) * (C.at(us, jj, ii) + C.at(us, jj, ii + 1));
      const T De = T(0.5) * (C.at(w.Du, jj, ii) + C.at(w.Du, jj, ii + 1));
      const T dpdx = (C.at(w.p, jj, ii + 1) - C.at(w.p, jj, ii)) / g.dx;
      const T gf = T(0.5) * (C.at(w.gpx, jj, ii) + C.at(w.gpx, jj, ii + 1));
      fx = (g.rho * (ubar - De * (dpdx - gf))) * g.dy;
    }
    if (C.in(jj, ii) && jj < g.ny - 1) {
      const T vbar = T(0.5) * (C.at(vs, jj, ii) + C.at(vs, jj + 1, ii));
      const T Dn = T(0.5) * (C.at(w.Du, jj, ii) + C.at(w.Du, jj + 1, ii));
      const T dpdy = (C.at(w.p, jj + 1, ii) - C.at(w.p, jj, ii)) / g.dy;
      const T gf = T(0.5) * (C.at(w.gpy, jj, ii) + C.at(w.gpy, jj + 1, ii));
      fy = (g.rho * (vbar - Dn * (dpdy - gf))) * g.dx;
    }
    sm[0][hj][hi] = fx;
    sm[1][hj][hi] = fy;
  }
  __syncthreads();
  T sum = 0;
  if (C.in(c.j, c.i)) {
    const int hj = c.ty + 1, hi = c.tx + 1;
    const size_t k = (size_t)c.j * g.nx + c.i;
    const T fx = sm[0][hj][hi], fy = sm[1][hj][hi];
    const T fxW = c.i > 0 ? sm[0][hj][hi - 1] : T(0);
    const T fyS = c.j > 0 ? sm[1][hj - 1][hi] : T(0);
    const T rhs = -(((fx - fxW) + fy) - fyS);
    w.mxs[k] = fx;
    w.mys[k] = fy;
    w.rhsp[k] = rhs;
    sum = rhs;
  }
  write_partial(w.part_m, 1, 0, sum, red, c);
}

// refinement residual: res = (rhs_p - mean) - (A1 p' + p' A2^T)
template <typename T>
__device__ void residual(const Grid<T>& g, const Work<T>& w, T* red) {
  const TileCell c = tile_cell();
  const T mean = reduce_col(w.part_m, 1, 0, g.nb, red, c.tid, NT)
                 / T(g.ny * g.nx);
  T sum = 0;
  if (c.j < g.ny && c.i < g.nx) {
    const int j = c.j, i = c.i, nx = g.nx, ny = g.ny;
    const size_t k = (size_t)j * nx + i;
    T ap = 0, pa = 0;
    for (int q = max(j - 1, 0); q <= min(j + 1, ny - 1); ++q)
      ap = fma(w.A1[(size_t)j * ny + q], w.pp[(size_t)q * nx + i], ap);
    for (int q = max(i - 1, 0); q <= min(i + 1, nx - 1); ++q)
      pa = fma(w.pp[(size_t)j * nx + q], w.A2[(size_t)i * nx + q], pa);
    const T res = (w.rhsp[k] - mean) - (ap + pa);
    w.res[k] = res;
    sum = res;
  }
  write_partial(w.part_m2, 1, 0, sum, red, c);
}

// (c1) corrections with the gauged p', the new state (in place unless the
// step started done), and the partials of the norms and the energy.
template <typename T>
__device__ void correct(const Grid<T>& g, const Work<T>& w, T (*sm)[HT][HT],
                        T* red) {
  const TileCell c = tile_cell();
  const Cells<T> C{g};
  const int n = g.ny * g.nx;
  const T pp0 = w.pp[0];
  auto pg = [&](int jj, int ii) {
    return C.in(jj, ii) ? w.pp[(size_t)jj * g.nx + ii] - pp0 : T(0);
  };
  for (int h = c.tid; h < HT * HT; h += NT) {
    const int hj = h / HT, hi = h % HT;
    const int jj = c.j0 - 1 + hj, ii = c.i0 - 1 + hi;
    T up = 0, vp = 0;
    if (C.in(jj, ii)) {
      T gx, gy;
      grad_pinned(g, pg, jj, ii, gx, gy);
      const T du = w.Du[(size_t)jj * g.nx + ii];
      up = -du * gx;
      vp = -du * gy;
    }
    sm[0][hj][hi] = up;
    sm[1][hj][hi] = vp;
  }
  __syncthreads();
  T pr[NPART_C] = {0, 0, 0, 0, 0, 0, 0};
  if (C.in(c.j, c.i)) {
    const int j = c.j, i = c.i, hj = c.ty + 1, hi = c.tx + 1;
    const size_t k = (size_t)j * g.nx + i;
    const T up = sm[0][hj][hi], vp = sm[1][hj][hi];
    const T u_new = w.x[k] + up;
    const T v_new = w.x[n + k] + vp;
    const T u = w.u[k], v = w.v[k];
    const bool done = w.flags != nullptr && w.flags[0] != 0;
    if (!done) {
      w.u[k] = u_new;
      w.v[k] = v_new;
      w.p[k] = w.p[k] + g.ap * pg(j, i);
      if (i < g.nx - 1)
        w.mx[(size_t)j * (g.nx - 1) + i] =
            w.mxs[k] + ((g.rho * T(0.5)) * (up + sm[0][hj][hi + 1])) * g.dy;
      if (j < g.ny - 1)
        w.my[k] = w.mys[k] + ((g.rho * T(0.5)) * (vp + sm[1][hj + 1][hi])) * g.dx;
    }
    pr[0] = up * up;
    pr[1] = vp * vp;
    pr[2] = u_new * u_new + v_new * v_new;
    pr[3] = (u_new - u) * (u_new - u);
    pr[4] = (v_new - v) * (v_new - v);
    pr[5] = u * u;
    pr[6] = v * v;
  }
  for (int q = 0; q < NPART_C; ++q)
    write_partial(w.part_c, NPART_C, q, pr[q], red, c);
}

// (c2) mass imbalance, FD vorticity and its gradient of the new state.
template <typename T>
__device__ void metrics(const Grid<T>& g, const Work<T>& w, T (*sm)[HT][HT],
                        T* red) {
  const TileCell c = tile_cell();
  const Cells<T> C{g};
  auto u = [&](int jj, int ii) { return C.at(w.u, jj, ii); };
  auto v = [&](int jj, int ii) { return C.at(w.v, jj, ii); };
  const T two_lid = T(2) * g.lid;
  for (int h = c.tid; h < HT * HT; h += NT) {
    const int hj = h / HT, hi = h % HT;
    const int jj = c.j0 - 1 + hj, ii = c.i0 - 1 + hi;
    T om = 0;
    if (C.in(jj, ii))
      om = fd_dx(g, v, jj, ii) - fd_dy(g, u, jj, ii,
                                       jj == g.ny - 1 ? two_lid : T(0));
    sm[0][hj][hi] = om;
  }
  __syncthreads();
  T pr[NPART_Q] = {0, 0, 0};
  if (C.in(c.j, c.i)) {
    const int j = c.j, i = c.i;
    const T mass = ((C.mx(w.mx, j, i) - (i > 0 ? C.mx(w.mx, j, i - 1) : T(0)))
                    + C.my(w.my, j, i))
                   - (j > 0 ? C.my(w.my, j - 1, i) : T(0));
    auto om = [&](int jj, int ii) {
      return sm[0][jj - c.j0 + 1][ii - c.i0 + 1];
    };
    const T dwx = fd_dx(g, om, j, i);
    const T dwy = fd_dy(g, om, j, i, T(0));
    const T w0 = om(j, i);
    pr[0] = mass * mass;
    pr[1] = w0 * w0;
    pr[2] = dwx * dwx + dwy * dwy;
  }
  for (int q = 0; q < NPART_Q; ++q)
    write_partial(w.part_q, NPART_Q, q, pr[q], red, c);
}

template <typename T>
__global__ void __launch_bounds__(NT)
stencil_kernel(int phase, Grid<T> g0, Work<T> w0, int upwind) {
  const Grid<T> g = at_lane(g0, blockIdx.z);
  const Work<T> w = at_lane(w0, blockIdx.z, g.ny, g.nx, g.nb);
  __shared__ T sm[2][HT][HT];
  __shared__ T red[NT];
  switch (phase) {
    case PH_ASSEMBLE: assemble(g, w, upwind, red); break;
    case PH_RHIE_CHOW: rhie_chow(g, w, sm, red); break;
    case PH_RESIDUAL: residual(g, w, red); break;
    case PH_CORRECT: correct(g, w, sm, red); break;
    default: metrics(g, w, sm, red); break;
  }
}

}  // namespace

template <typename T>
cudaError_t launch_stencil(int phase, const Grid<T>& g, const Work<T>& w,
                           int upwind, cudaStream_t s) {
  const dim3 grid((g.nx + TILE - 1) / TILE, (g.ny + TILE - 1) / TILE,
                  g.lanes);
  stencil_kernel<T><<<grid, dim3(TILE, TILE), 0, s>>>(phase, g, w, upwind);
  return cudaGetLastError();
}

template cudaError_t launch_stencil<float>(int, const Grid<float>&,
                                           const Work<float>&, int,
                                           cudaStream_t);
template cudaError_t launch_stencil<double>(int, const Grid<double>&,
                                            const Work<double>&, int,
                                            cudaStream_t);

}  // namespace fv
