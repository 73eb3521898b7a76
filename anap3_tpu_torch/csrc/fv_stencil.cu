// fv_stencil: the assembly of one SIMPLE iteration.
//
// Replaces: the assembly part of the body _make_iterate of
//   anap3_tpu/ops/pallas_fv.py (make_pallas_fv_step, make_pallas_fv_chunk_
//   runner): cell_gradient, the momentum coefficients, the psi == 1
//   deferred correction, the Patankar right-hand sides and r0.
//
// Bound on the card: latency. At N=128 the phase reads the state (~0.3 MB
//   in float32, L2-resident) and writes ~0.6 MB with 64 blocks of 256
//   threads, a few microseconds that the launch and the dependent global
//   loads dominate.
// Design: one thread a cell of a 16 x 16 tile; the grid-wide sums the
//   BiCGSTAB launch starts from (|rhs|^2, |r0|^2, <rh, r0>) are per-block
//   partials that it reduces in a fixed order, and block 0 writes the
//   solve's start values. The rest of the iteration's stencil work (Rhie-
//   Chow, the refinement residual, the corrections, the metrics) runs in
//   fv_pressure.cu's cooperative launch, on the functions of
//   fv_phases.cuh, which this phase shares (the pinned gradient).
// Lanes: the lane is the grid's z axis; lane b's blocks run the one-lane
//   code on lane b's buffers and scalars (fv_common.cuh), which replaces
//   the row-stacked layout and the where-selects of
//   anap3_tpu/ops/pallas_fv_lanes.py make_fv_lane_runner: a halo read
//   outside a lane's grid is a zero, never a neighbour lane's cell.
#include "fv_phases.cuh"

namespace fv {
namespace {

template <typename T>
__device__ void write_partial(T* part, int ncol, int col, T v, T* red,
                              const TileCell& c) {
  v = block_sum(v, red, c.tid, NT);
  if (c.tid == 0) part[(size_t)c.b * ncol + col] = v;
}

// gradient, coefficients, deferred correction, rhs, r0 = rhs - A x0.
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

template <typename T>
__global__ void __launch_bounds__(NT)
stencil_kernel(Grid<T> g0, Work<T> w0, int upwind) {
  const Grid<T> g = at_lane(g0, blockIdx.z);
  const Work<T> w = at_lane(w0, blockIdx.z, g.ny, g.nx, g.nb);
  __shared__ T red[NT];
  assemble(g, w, upwind, red);
}

}  // namespace

template <typename T>
cudaError_t launch_stencil(const Grid<T>& g, const Work<T>& w, int upwind,
                           cudaStream_t s) {
  const dim3 grid((g.nx + TILE - 1) / TILE, (g.ny + TILE - 1) / TILE,
                  g.lanes);
  stencil_kernel<T><<<grid, dim3(TILE, TILE), 0, s>>>(g, w, upwind);
  return cudaGetLastError();
}

template cudaError_t launch_stencil<float>(const Grid<float>&,
                                           const Work<float>&, int,
                                           cudaStream_t);
template cudaError_t launch_stencil<double>(const Grid<double>&,
                                            const Work<double>&, int,
                                            cudaStream_t);

}  // namespace fv
