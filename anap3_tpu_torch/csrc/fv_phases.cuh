// Device functions that more than one FV-SIMPLE kernel runs, so that every
// value is computed by one code path: the cell accessors, the pinned
// gradient and the FD-ghost derivatives (fv_stencil.cu's assembly and
// fv_pressure.cu), the (tile, lane) geometry of the cooperative launches
// and their fixed-order warp reductions (fv_bicgstab.cu, fv_pressure.cu),
// and the stencil phases of the pressure stage (fv_pressure.cu): Rhie-Chow,
// the refinement residual, the correction and the metrics, each on one
// 16 x 16 tile of one lane.
//
// A phase function runs on one item of a 256-thread block (TileCell from
// tile_at) and writes its grid-wide sums as per-tile partials that a later
// phase (or fv_control.cu) reduces in a fixed order. `vals` is NCOL x NT
// values of shared memory for write_partials; a phase that stages a haloed
// tile takes `sm`, two (TILE + 2)^2 tiles (and the correction `pgs`, one
// (TILE + 4)^2 tile). Each phase ends with a block barrier inside
// write_partials, after which the block has read every shared value the
// phase wrote except the warps' column reads of `vals`; the next item's
// first shared write comes after another barrier.
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

// Column `col` of a lane's (nb, ncol) partial table, summed by one warp as
// reduce_col sums it: thread t's running sum over b = t, t + NT, ...,
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

// The threads' values in shared memory (`vals`, NCOL x NT, thread t's
// value of column c at vals[c * NT + t]) summed per column as block_sum
// sums them, into part[tile * NCOL + c]: warp c adds column c (the tree's
// first three levels from eight slots, the last five as shuffles).
template <typename T, int NCOL>
__device__ void sum_partials(const T* vals, T* part, int tile) {
  const int wp = threadIdx.x / 32, l = threadIdx.x % 32;
  __syncthreads();
  if (wp < NCOL) {
    const T* col = vals + wp * NT + l;
    T x = ((col[0] + col[128]) + (col[64] + col[192]))
          + ((col[32] + col[160]) + (col[96] + col[224]));
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) x += __shfl_down_sync(0xffffffffu, x, s);
    if (l == 0) part[(size_t)tile * NCOL + wp] = x;
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

}  // namespace fv
