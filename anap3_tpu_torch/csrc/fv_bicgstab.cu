// fv_bicgstab: one iteration of the fixed-count joint u/v Jacobi-BiCGSTAB of
// the momentum predictor, in three launches.
//
// Replaces: bicg_iter, the fori_loop body of the body _make_iterate of
//   anap3_tpu/ops/pallas_fv.py (make_pallas_fv_step,
//   make_pallas_fv_chunk_runner): K warm-started iterations with the
//   breakdown guard active = ||r||^2 > 1e-16 (||rhs||^2 + 1e-30), every
//   scalar frozen by sel() once inactive, 1e-30 in every divisor, and the
//   Pallas operation order in rho/beta/alpha/omega. The guard constants are
//   the Pallas kernel's float32 choices and stay the same in float64.
//
// Bound on the card: a chain of dependent grid-wide inner products
//   (<rh,r> and ||r||^2 -> rho and the guard; <rh,v> -> alpha; <t,s> and
//   <t,t> -> omega): three global syncs per iteration, 48 launches per SIMPLE
//   iteration at K=16. The arithmetic (two 5-point applies on 2 x 16K cells
//   at N=128) is far below a microsecond, yet a launch takes ~5.5 us with
//   ~1.2 us between launches (torch.profiler, H100 700 W): the serial
//   in-block reductions at the start and end of each launch are the likely
//   cost, latency rather than bytes or flops.
// Design: a launch per sync. Each launch starts by reducing the previous
//   launch's per-block partials in a fixed order, in every block (no
//   atomics, no extra launch, bit-reproducible), so every block holds the
//   same scalars; block 0 records them in slot k+1 of a small device array,
//   which only later launches read. The direction launch computes p on its
//   haloed tile (from r, p_old, v_old of earlier launches) so v = A M p needs
//   no extra sync; the stabilize launch does the same for s and t = A M s;
//   the update launch applies x and r and writes the next <rh,r>, ||r||^2
//   partials. p and v alternate between two buffers so no block overwrites
//   a value another block still reads.
#include "fv_common.cuh"

namespace fv {
namespace {

constexpr double kEps = 1e-30;
constexpr double kGuard = 1e-16;

template <typename T>
__device__ T* slot(const Work<T>& w, int k) {
  return w.slots + (size_t)k * SL_COUNT;
}

// 5-point apply on a shared haloed tile (zero outside the grid)
template <typename T>
__device__ T apply_A(const Work<T>& w, size_t k, T (*f)[HT], int hj,
                     int hi) {
  return w.aPr[k] * f[hj][hi] + w.aE[k] * f[hj][hi + 1]
         + w.aW[k] * f[hj][hi - 1] + w.aN[k] * f[hj + 1][hi]
         + w.aS[k] * f[hj - 1][hi];
}

template <typename T>
__device__ void write_partial(T* part, int ncol, int col, T v, T* red,
                              const TileCell& c) {
  v = block_sum(v, red, c.tid, NT);
  if (c.tid == 0) part[(size_t)c.b * ncol + col] = v;
}

template <typename T>
__device__ bool own_cell(const Grid<T>& g, const TileCell& c) {
  return c.j < g.ny && c.i < g.nx;
}

// rho1, beta, p = r + beta (p - omega v), v = A M p
template <typename T>
__device__ void direction(int k, const Grid<T>& g, const Work<T>& w,
                          T (*sm)[HT][HT], T* red) {
  const TileCell c = tile_cell();
  const int n = g.ny * g.nx;
  const T eps = T(kEps);
  const T rr = reduce_col(w.part_r, 4, 0, g.nb, red, c.tid, NT)
               + reduce_col(w.part_r, 4, 1, g.nb, red, c.tid, NT);
  const T rhr = reduce_col(w.part_r, 4, 2, g.nb, red, c.tid, NT)
                + reduce_col(w.part_r, 4, 3, g.nb, red, c.tid, NT);
  T rhsn2;
  if (k == 0)
    rhsn2 = (reduce_col(w.part_rhs, 2, 0, g.nb, red, c.tid, NT)
             + reduce_col(w.part_rhs, 2, 1, g.nb, red, c.tid, NT)) + eps;
  else
    rhsn2 = slot(w, 0)[SL_ACTIVE];  // slot 0 has no guard; it keeps this
  const T* old = slot(w, k);
  const bool active = rr > T(kGuard) * rhsn2;
  const T rho_k = old[SL_RHO], alpha_k = old[SL_ALPHA], omega_k = old[SL_OMEGA];
  const T rho1 = active ? rhr : rho_k;
  const T beta = (rho1 / (rho_k + eps)) * (alpha_k / (omega_k + eps));
  const T* pv_old = w.pv[k & 1];
  const T* vv_old = w.vv[k & 1];
  T* pv_new = w.pv[(k + 1) & 1];
  T* vv_new = w.vv[(k + 1) & 1];
  for (int h = c.tid; h < HT * HT; h += NT) {
    const int hj = h / HT, hi = h % HT;
    const int jj = c.j0 - 1 + hj, ii = c.i0 - 1 + hi;
    const bool in = jj >= 0 && jj < g.ny && ii >= 0 && ii < g.nx;
    const bool mine = in && hj >= 1 && hj <= TILE && hi >= 1 && hi <= TILE;
    const size_t kk = (size_t)jj * g.nx + ii;
    for (int q = 0; q < 2; ++q) {
      T ph = 0;
      if (in) {
        const size_t o = (size_t)q * n + kk;
        const T po = pv_old[o];
        const T pn = active ? w.r[o] + beta * (po - omega_k * vv_old[o]) : po;
        if (mine) pv_new[o] = pn;
        ph = pn / w.aPr[kk];
      }
      sm[q][hj][hi] = ph;
    }
  }
  __syncthreads();
  T pr[2] = {0, 0};
  if (own_cell(g, c)) {
    const size_t k0 = (size_t)c.j * g.nx + c.i;
    for (int q = 0; q < 2; ++q) {
      const size_t o = (size_t)q * n + k0;
      const T vn = active ? apply_A(w, k0, sm[q], c.ty + 1, c.tx + 1)
                          : vv_old[o];
      vv_new[o] = vn;
      pr[q] = w.rh[o] * vn;
    }
  }
  write_partial(w.part_v, 2, 0, pr[0], red, c);
  write_partial(w.part_v, 2, 1, pr[1], red, c);
  if (c.b == 0 && c.tid == 0) {
    T* nw = slot(w, k + 1);
    nw[SL_RHO] = rho1;
    nw[SL_ACTIVE] = active ? T(1) : T(0);
    if (k == 0) slot(w, 0)[SL_ACTIVE] = rhsn2;
  }
}

// alpha, s = r - alpha v, t = A M s
template <typename T>
__device__ void stabilize(int k, const Grid<T>& g, const Work<T>& w,
                          T (*sm)[HT][HT], T* red) {
  const TileCell c = tile_cell();
  const int n = g.ny * g.nx;
  const T eps = T(kEps);
  const T rvv = reduce_col(w.part_v, 2, 0, g.nb, red, c.tid, NT)
                + reduce_col(w.part_v, 2, 1, g.nb, red, c.tid, NT);
  const T* nw = slot(w, k + 1);
  const bool active = nw[SL_ACTIVE] != T(0);
  const T alpha = active ? nw[SL_RHO] / (rvv + eps) : slot(w, k)[SL_ALPHA];
  const T* vv_new = w.vv[(k + 1) & 1];
  for (int h = c.tid; h < HT * HT; h += NT) {
    const int hj = h / HT, hi = h % HT;
    const int jj = c.j0 - 1 + hj, ii = c.i0 - 1 + hi;
    const bool in = jj >= 0 && jj < g.ny && ii >= 0 && ii < g.nx;
    const size_t kk = (size_t)jj * g.nx + ii;
    for (int q = 0; q < 2; ++q) {
      T s = 0, sh = 0;
      if (in) {
        const size_t o = (size_t)q * n + kk;
        s = w.r[o] - alpha * vv_new[o];
        sh = s / w.aPr[kk];
      }
      sm[q][hj][hi] = sh;
      sm[2 + q][hj][hi] = s;
    }
  }
  __syncthreads();
  T pr[4] = {0, 0, 0, 0};
  if (own_cell(g, c)) {
    const size_t k0 = (size_t)c.j * g.nx + c.i;
    for (int q = 0; q < 2; ++q) {
      const size_t o = (size_t)q * n + k0;
      const T s = sm[2 + q][c.ty + 1][c.tx + 1];
      const T t = apply_A(w, k0, sm[q], c.ty + 1, c.tx + 1);
      w.s[o] = s;
      w.t[o] = t;
      pr[q] = t * s;
      pr[2 + q] = t * t;
    }
  }
  for (int q = 0; q < 4; ++q) write_partial(w.part_t, 4, q, pr[q], red, c);
  if (c.b == 0 && c.tid == 0) slot(w, k + 1)[SL_ALPHA] = alpha;
}

// omega, x += alpha M p + omega M s, r = s - omega t; next <rh,r>, ||r||^2
template <typename T>
__device__ void update(int k, const Grid<T>& g, const Work<T>& w, T* red) {
  const TileCell c = tile_cell();
  const int n = g.ny * g.nx;
  const T eps = T(kEps);
  const T ts = reduce_col(w.part_t, 4, 0, g.nb, red, c.tid, NT)
               + reduce_col(w.part_t, 4, 1, g.nb, red, c.tid, NT);
  const T tt = reduce_col(w.part_t, 4, 2, g.nb, red, c.tid, NT)
               + reduce_col(w.part_t, 4, 3, g.nb, red, c.tid, NT);
  const T* nw = slot(w, k + 1);
  const bool active = nw[SL_ACTIVE] != T(0);
  const T omega = active ? ts / (tt + eps) : slot(w, k)[SL_OMEGA];
  const T alpha = nw[SL_ALPHA];
  const T* pv_new = w.pv[(k + 1) & 1];
  T pr[4] = {0, 0, 0, 0};
  if (own_cell(g, c)) {
    const size_t k0 = (size_t)c.j * g.nx + c.i;
    const T aPr = w.aPr[k0];
    for (int q = 0; q < 2; ++q) {
      const size_t o = (size_t)q * n + k0;
      T r = w.r[o];
      if (active) {
        const T s = w.s[o];
        w.x[o] = w.x[o] + alpha * (pv_new[o] / aPr) + omega * (s / aPr);
        r = s - omega * w.t[o];
        w.r[o] = r;
      }
      pr[q] = r * r;
      pr[2 + q] = w.rh[o] * r;
    }
  }
  for (int q = 0; q < 4; ++q) write_partial(w.part_r, 4, q, pr[q], red, c);
  if (c.b == 0 && c.tid == 0) slot(w, k + 1)[SL_OMEGA] = omega;
}

template <typename T>
__global__ void __launch_bounds__(NT)
bicg_kernel(int phase, int k, Grid<T> g, Work<T> w) {
  __shared__ T sm[4][HT][HT];
  __shared__ T red[NT];
  if (phase == BP_DIRECTION)
    direction(k, g, w, sm, red);
  else if (phase == BP_STABILIZE)
    stabilize(k, g, w, sm, red);
  else
    update(k, g, w, red);
}

}  // namespace

template <typename T>
cudaError_t launch_bicg(int phase, int k, const Grid<T>& g, const Work<T>& w,
                        cudaStream_t s) {
  const dim3 grid((g.nx + TILE - 1) / TILE, (g.ny + TILE - 1) / TILE);
  bicg_kernel<T><<<grid, dim3(TILE, TILE), 0, s>>>(phase, k, g, w);
  return cudaGetLastError();
}

template cudaError_t launch_bicg<float>(int, int, const Grid<float>&,
                                        const Work<float>&, cudaStream_t);
template cudaError_t launch_bicg<double>(int, int, const Grid<double>&,
                                         const Work<double>&, cudaStream_t);

}  // namespace fv
