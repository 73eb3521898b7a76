// Device functions of the FV-SIMPLE kernels, so that every value is
// computed by one code path: the cell accessors, the pinned gradient and
// the FD-ghost derivatives, the (tile, lane) geometry of the cooperative
// launches and their fixed-order warp reductions, and the phases that are
// not the BiCGSTAB solve's: the assembly (the head of fv_bicgstab.cu's
// launch), and Rhie-Chow, the refinement residual, the correction, the
// metrics and control (fv_pressure.cu's), each on one 16 x 16 tile of one
// lane (control on one lane).
//
// A phase function runs on one item of a 256-thread block (TileCell from
// tile_at) and writes its grid-wide sums as per-tile partials that a later
// phase reduces in a fixed order. `vals` is NCOL x NT values of shared
// memory for write_partials; a phase that stages a haloed tile takes `sm`,
// two (TILE + 2)^2 tiles (and the correction `pgs`, one (TILE + 4)^2
// tile). Each phase ends with a block barrier inside write_partials, after
// which the block has read every shared value the phase wrote except the
// warps' column reads of `vals`; the next item's first shared write comes
// after another barrier.
#pragma once

#include "fv_common.cuh"

namespace fv {

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

// Thread `tid`'s cell of tile `tile` (row-major over the tiles) in a
// one-dimensional block of NT threads.
__device__ __forceinline__ TileCell tile_at(int tile, int tiles_x,
                                            int tid = threadIdx.x) {
  TileCell c;
  c.tid = tid;
  c.tx = c.tid % TILE;
  c.ty = c.tid / TILE;
  c.j0 = (tile / tiles_x) * TILE;
  c.i0 = (tile % tiles_x) * TILE;
  c.j = c.j0 + c.ty;
  c.i = c.i0 + c.tx;
  c.b = tile;
  return c;
}

// Column `col` of a lane's (nb, ncol) partial table, summed by one warp in
// the order of NT threads: thread t's running sum over b = t, t + NT, ...,
// then the NT-slot tree. Lane l holds the running sums of threads
// l + 32 j (j < 8), each over its b ascending, and adds them as the tree's
// first three levels pair them; the last five levels are shuffles. Valid
// in lane 0.
template <typename T>
__device__ T warp_col_sum(const T* part, int ncol, int col, int nb) {
  static_assert(NT == 256, "eight running sums a warp lane");
  const int l = threadIdx.x % 32;
  T a[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int b0 = l; b0 < nb; b0 += NT) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (b0 + 32 * j < nb) a[j] += part[(size_t)(b0 + 32 * j) * ncol + col];
  }
  T v = ((a[0] + a[4]) + (a[2] + a[6])) + ((a[1] + a[5]) + (a[3] + a[7]));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// NT values in shared memory (`col`) summed by one warp in the fixed order
// of the NT-slot tree (slot t += slot t + s for s = NT/2, ..., 1): lane l
// adds slots l + 32 j as the tree's first three levels pair them, the last
// five levels are shuffles. Valid in lane 0.
template <typename T>
__device__ __forceinline__ T col_tree(const T* col, int l = threadIdx.x % 32) {
  static_assert(NT == 256, "eight slots a warp lane");
  col += l;
  T x = ((col[0] + col[128]) + (col[64] + col[192]))
        + ((col[32] + col[160]) + (col[96] + col[224]));
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_down_sync(0xffffffffu, x, s);
  return x;
}

// The threads' values in shared memory (`vals`, NCOL x NT, thread t's
// value of column c at vals[c * NT + t]) summed per column in the NT-slot
// tree's order (col_tree: warp c adds column c), into
// part[tile * NCOL + c].
template <typename T, int NCOL>
__device__ void sum_partials(const T* vals, T* part, int tile) {
  const int wp = threadIdx.x / 32;
  __syncthreads();
  if (wp < NCOL) {
    const T x = col_tree(vals + wp * NT);
    if (threadIdx.x % 32 == 0) part[(size_t)tile * NCOL + wp] = x;
  }
}

// The threads' values v[0, NCOL) through `vals` into sum_partials.
template <typename T, int NCOL>
__device__ void write_partials(const T (&v)[NCOL], T* vals, T* part,
                               int tile) {
#pragma unroll
  for (int q = 0; q < NCOL; ++q) vals[q * NT + threadIdx.x] = v[q];
  sum_partials<T, NCOL>(vals, part, tile);
}

// The mean of a lane's field from its (nb, 1) partials, as every block
// computes it: warp 0 sums the column, the block reads it from `sum`.
// Starts and ends with a block barrier.
template <typename T>
__device__ T lane_mean(const T* part, const Grid<T>& g, T* sum) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const T v = warp_col_sum(part, 1, 0, g.nb);
    if (threadIdx.x == 0) *sum = v;
  }
  __syncthreads();
  return *sum / T(g.ny * g.nx);
}

// The assembly of an iteration (the head of the BiCGSTAB launch): the
// pinned pressure gradient, the momentum coefficients, the psi == 1
// deferred correction, the Patankar right-hand sides, the solve's start
// x = (u, v), r = rh = rhs - A x, p = v = 0, and the per-tile partials
// |rhs|^2 (part_rhs) and |r|^2, <rh, r> (part_r); lane tile 0 writes the
// solve's start values rho, alpha, omega = 1. Every value the cell reads
// is loaded first, so that the loads issue together. Reads the state with
// its halo; writes only this tile's cells. `vals` holds 6 x NT values.
template <typename T>
__device__ void assemble(const Grid<T>& g, const Work<T>& w, int upwind,
                         const TileCell& c, T* vals) {
  const Cells<T> C{g};
  const int n = g.ny * g.nx;
  const int j = c.j, i = c.i;
  const size_t k = (size_t)j * g.nx + i;
  // |rhs|^2 per component, then |r|^2 and <rh,r> per component
  T pr[6] = {0, 0, 0, 0, 0, 0};
  if (C.in(j, i)) {
    // the cell and its E, W, N, S neighbours (zero off the grid)
    auto five = [&](const T* a, T (&f)[5]) {
      f[0] = C.at(a, j, i);
      f[1] = C.at(a, j, i + 1);
      f[2] = C.at(a, j, i - 1);
      f[3] = C.at(a, j + 1, i);
      f[4] = C.at(a, j - 1, i);
    };
    T fp[5], fu[5], fv[5];
    five(w.p, fp);
    five(w.u, fu);
    five(w.v, fv);
    const T mxE = C.mx(w.mx, j, i), mxW = C.mx(w.mx, j, i - 1);
    const T myN = C.my(w.my, j, i), myS = C.my(w.my, j - 1, i);
    const T aPbc = w.aP_bc[k], bbcu = w.b_bc_u[k];
    T gpx, gpy;
    grad_pinned(g, [&](int jj, int ii) {
      return jj > j ? fp[3] : jj < j ? fp[4] : ii > i ? fp[1]
                    : ii < i ? fp[2] : fp[0];
    }, j, i, gpx, gpy);
    const bool he = i < g.nx - 1, hw = i > 0, hn = j < g.ny - 1, hs = j > 0;
    const T zero = T(0);
    const T aE = he ? -(fmax(-mxE, zero) + g.Dxc) : zero;
    const T aW = hw ? -(fmax(mxW, zero) + g.Dxc) : zero;
    const T aN = hn ? -(fmax(-myN, zero) + g.Dyc) : zero;
    const T aS = hs ? -(fmax(myS, zero) + g.Dyc) : zero;
    const T aP = (he ? fmax(mxE, zero) + g.Dxc : zero)
                 + (hw ? fmax(-mxW, zero) + g.Dxc : zero)
                 + (hn ? fmax(myN, zero) + g.Dyc : zero)
                 + (hs ? fmax(-myS, zero) + g.Dyc : zero) + aPbc;
    const T aPr = aP / g.auv;
    const T* fs[2] = {fu, fv};
    T def[2] = {zero, zero};
    if (!upwind) {
      // psi == 1: the face source |m| (N - P) / 2 for both flux signs
      for (int q = 0; q < 2; ++q) {
        const T* f = fs[q];
        const T dcxE = he ? (T(0.5) * fabs(mxE)) * (f[1] - f[0]) : zero;
        const T dcxW = (T(0.5) * fabs(mxW)) * (f[0] - f[2]);
        const T dcyN = hn ? (T(0.5) * fabs(myN)) * (f[3] - f[0]) : zero;
        const T dcyS = (T(0.5) * fabs(myS)) * (f[0] - f[4]);
        def[q] = ((-dcxE + (hw ? dcxW : zero)) - dcyN) + (hs ? dcyS : zero);
      }
    }
    const T b_u = (bbcu + def[0]) - gpx * g.vol;
    const T b_v = def[1] - gpy * g.vol;
    const T scale = (T(1) - g.auv) / g.auv;
    const T rhs[2] = {b_u + (scale * aP) * fu[0], b_v + (scale * aP) * fv[0]};
    for (int q = 0; q < 2; ++q) {
      const T* f = fs[q];
      const T Ax = aPr * f[0] + aE * f[1] + aW * f[2] + aN * f[3] + aS * f[4];
      const T r0 = rhs[q] - Ax;
      const size_t o = (size_t)q * n + k;
      w.x[o] = f[0];
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
  // the six columns in one pass (col_tree), into the two tables
  __syncthreads();  // the previous item's column reads of vals are done
#pragma unroll
  for (int q = 0; q < 6; ++q) vals[q * NT + c.tid] = pr[q];
  __syncthreads();
  const int wp = c.tid / 32;
  if (wp < 6) {
    const T x = col_tree(vals + wp * NT);
    if (c.tid % 32 == 0) {
      if (wp < 2) w.part_rhs[(size_t)c.b * 2 + wp] = x;
      else w.part_r[(size_t)c.b * 4 + wp - 2] = x;
    }
  }
  if (c.b == 0 && c.tid == 0) {
    w.slots[SL_RHO] = T(1);
    w.slots[SL_ALPHA] = T(1);
    w.slots[SL_OMEGA] = T(1);
  }
}

// Rhie-Chow compact face fluxes mdot* and rhs_p = -div(mdot*), with the
// per-tile sums of rhs_p (part_m).
template <typename T>
__device__ void rhie_chow(const Grid<T>& g, const Work<T>& w,
                          const TileCell& c, T (*sm)[HT][HT], T* vals) {
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
  T sum[1] = {0};
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
    sum[0] = rhs;
  }
  write_partials(sum, vals, w.part_m, c.b);
}

// Refinement residual res = (rhs_p - mean) - (A1 p' + p' A2^T), the
// tridiagonal stencil it is, summed in the dense product's order (k
// ascending, FMA): the terms it skips are exact zeros. `mean` is rhs_p's
// (lane_mean of part_m); per-tile sums of res into part_m2.
template <typename T>
__device__ void residual(const Grid<T>& g, const Work<T>& w,
                         const TileCell& c, T mean, T* vals) {
  T sum[1] = {0};
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
    sum[0] = res;
  }
  write_partials(sum, vals, w.part_m2, c.b);
}

// Corrections with the gauged p', the new state (in place unless the step
// started done), and the per-tile partials of the norms and the energy
// (part_c, NPART_C columns). The gauged p' is staged on the tile's
// two-cell halo (pgs), then u' and v' on its one-cell halo (sm), from
// which the face corrections read their neighbours.
template <typename T>
__device__ void correct(const Grid<T>& g, const Work<T>& w,
                        const TileCell& c, T (*sm)[HT][HT],
                        T (*pgs)[HT + 2], T* vals) {
  const Cells<T> C{g};
  const int n = g.ny * g.nx;
  const T pp0 = w.pp[0];
  for (int h = c.tid; h < (HT + 2) * (HT + 2); h += NT) {
    const int hj = h / (HT + 2), hi = h % (HT + 2);
    const int jj = c.j0 - 2 + hj, ii = c.i0 - 2 + hi;
    pgs[hj][hi] = C.in(jj, ii) ? w.pp[(size_t)jj * g.nx + ii] - pp0 : T(0);
  }
  __syncthreads();
  auto pg = [&](int jj, int ii) {
    return pgs[jj - c.j0 + 2][ii - c.i0 + 2];
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
  // the partials' values go to shared memory as they are formed, before
  // the state is written
  T* pr = vals + c.tid;  // column q at pr[q * NT]
#pragma unroll
  for (int q = 0; q < NPART_C; ++q) pr[q * NT] = T(0);
  if (C.in(c.j, c.i)) {
    const int j = c.j, i = c.i, hj = c.ty + 1, hi = c.tx + 1;
    const size_t k = (size_t)j * g.nx + i;
    const T up = sm[0][hj][hi], vp = sm[1][hj][hi];
    const T u_new = w.x[k] + up;
    const T v_new = w.x[n + k] + vp;
    const T u = w.u[k], v = w.v[k];
    pr[0] = up * up;
    pr[NT] = vp * vp;
    pr[2 * NT] = u_new * u_new + v_new * v_new;
    pr[3 * NT] = (u_new - u) * (u_new - u);
    pr[4 * NT] = (v_new - v) * (v_new - v);
    pr[5 * NT] = u * u;
    pr[6 * NT] = v * v;
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
  }
  sum_partials<T, NPART_C>(vals, w.part_c, c.b);
}

// Mass imbalance, FD vorticity and its gradient of the new state: the
// per-tile partials part_q (NPART_Q columns).
template <typename T>
__device__ void metrics(const Grid<T>& g, const Work<T>& w,
                        const TileCell& c, T (*sm)[HT][HT], T* vals) {
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
  write_partials(pr, vals, w.part_q, c.b);
}

// Slots of the tree the control phase sums a lane's metric partials in:
// thread t of CTREE first sums column q of tiles t, t + CTREE, ...
// ascending, then slot t += slot t + s for s = CTREE/2, ..., 1.
constexpr int CTREE = 1024;
constexpr int NPART_CQ = NPART_C + NPART_Q;  // part_c's columns, part_q's

// Column q of the lane's metric partials (part_c's columns, then
// part_q's) at tile b.
template <typename T>
__device__ __forceinline__ T metric_part(const Work<T>& w, int b, int q) {
  return q < NPART_C ? w.part_c[(size_t)b * NPART_C + q]
                     : w.part_q[(size_t)b * NPART_Q + q - NPART_C];
}

// The running sums of CTREE thread b0 (tiles b0, b0 + CTREE, ...
// ascending) of columns Q0 .. Q0 + NQ - 1.
template <int Q0, int NQ, typename T>
__device__ __forceinline__ void tree_sums(const Work<T>& w, int nb, int b0,
                                          T (&a)[NQ]) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) a[q] = 0;
  for (int b = b0; b < nb; b += CTREE) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) a[q] += metric_part(w, b, Q0 + q);
  }
}

// vals[q * NT + t] += A1 + A3 for columns Q0 .. Q0 + NQ - 1.
template <int Q0, int NQ, typename T>
__device__ __forceinline__ void add_odd_slots(const Work<T>& w, int nb,
                                              int t, T* vals) {
  T a[NQ], b[NQ];
  tree_sums<Q0>(w, nb, t + NT, a);
  tree_sums<Q0>(w, nb, t + 3 * NT, b);
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    vals[(Q0 + q) * NT + t] = vals[(Q0 + q) * NT + t] + (a[q] + b[q]);
}

// vals[q * NT + t] for every column q: slot t of the CTREE tree after its
// first two levels, (A0 + A2) + (A1 + A3), A_k the running sums of CTREE
// thread t + k NT. Ten columns at a time, then five (fewer live
// registers).
template <typename T>
__device__ __forceinline__ void control_slots(const Work<T>& w, int nb, int t,
                                              T* vals) {
  T a[NPART_CQ];
  tree_sums<0>(w, nb, t, a);
#pragma unroll
  for (int q = 0; q < NPART_CQ; ++q) vals[q * NT + t] = a[q];
  tree_sums<0>(w, nb, t + 2 * NT, a);
#pragma unroll
  for (int q = 0; q < NPART_CQ; ++q) vals[q * NT + t] = vals[q * NT + t] + a[q];
  add_odd_slots<0, NPART_CQ / 2>(w, nb, t, vals);
  add_odd_slots<NPART_CQ / 2, NPART_CQ - NPART_CQ / 2>(w, nb, t, vals);
}

// Control of one lane of an iteration (one block of NT threads): the
// lane's part_c and part_q columns summed in the CTREE-slot tree's order
// (thread t holds slots t, t + NT, t + 2 NT, t + 3 NT, combined as the
// tree's first two levels combine them, so the zero slots beyond the
// tiles are added as the tree adds them; warp c then adds column c's NT
// slots as col_tree), then the six metrics. On a step (no rows) it writes
// them to `metrics`. In a chunk it writes the history row (rel_iter = the
// larger relative change of u and v, then the metrics; NaN once the lane
// is done) and runs the convergence state machine: after the warmup a
// finite criterion below tol converges, a non-finite rel_iter diverges,
// both set done and conv_iter = idx + 1, and converged with the first.
// The criterion is rel_iter, or with use_residual the continuity norm over
// its value at the warmup iteration (ref_norm, pinned then). A done lane
// keeps its flags. `t` is the thread's index, `vals` holds NPART_CQ x NT
// values, `sums` NPART_CQ. Starts with a block barrier; the flags it
// writes are read by the next launch's correction, never by this one's (a
// grid barrier is between).
template <typename T>
__device__ void control(const Grid<T>& g, const Work<T>& w,
                        const Control<T>& ctl, int t, T* vals, T* sums) {
  const bool chunk = w.rows != nullptr;
  int done = 0;
  T rn = 0;
  __syncthreads();  // the block's earlier reads of shared memory are done
  control_slots(w, g.nb, t, vals);
  __syncthreads();
  for (int q = t / 32; q < NPART_CQ; q += NT / 32) {
    const T x = col_tree(vals + q * NT, t % 32);
    if (t % 32 == 0) sums[q] = x;
  }
  __syncthreads();
  if (t != 0) return;
  if (chunk) {
    done = w.flags[0];
    if (ctl.use_residual) rn = w.ref_norm[0];
  }
  const T* cs = sums;
  const T* qs = sums + NPART_C;
  const T dA = g.dx * g.dy;
  const T m[6] = {sqrt(cs[0]), sqrt(cs[1]), sqrt(qs[0]),
                  T(0.5) * cs[2] * dA, T(0.5) * qs[1] * dA,
                  T(0.5) * qs[2] * dA};
  if (!chunk) {
    for (int q = 0; q < 6; ++q) w.metrics[q] = m[q];
    return;
  }
  const T rel = nan_max(sqrt(cs[3]) / (sqrt(cs[5]) + T(1e-12)),
                        sqrt(cs[4]) / (sqrt(cs[6]) + T(1e-12)));
  const T nan = T(NAN);
  T* r = w.rows + (size_t)ctl.row * g.lanes * 7;
  r[0] = done ? nan : rel;
  for (int q = 0; q < 6; ++q) r[1 + q] = done ? nan : m[q];
  T crit = rel;
  if (ctl.use_residual) {
    const T cont = done ? nan : m[2];
    if (ctl.idx == ctl.warmup) rn = cont;
    crit = cont / nan_max(rn, T(1e-30));
    w.ref_norm[0] = rn;
  }
  if (!done) {
    const bool finite = isfinite(rel);
    const bool newly_conv = ctl.idx >= ctl.warmup && crit < ctl.tol && finite;
    if (newly_conv || !finite) {
      w.flags[0] = 1;
      w.flags[1] = ctl.idx + 1;
    }
    if (newly_conv) w.flags[2] = 1;
  }
}

}  // namespace fv
