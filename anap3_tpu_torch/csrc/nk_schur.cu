// nk_schur: the Schur-complement BiCGSTAB of the Newton steady solver's
// Stokes preconditioner, one cooperative launch a solve, stopping on the
// device.
//
// Replaces: jax.scipy.sparse.linalg.bicgstab(s_apply, rhs, tol=1e-8,
//   maxiter=schur_iters) inside the @jax.jit matvec_fused of
//   anap3_tpu/models/steady.py (_StokesPreconditioner._apply, :173; the
//   JAX module has no pallas_call: XLA compiles the while_loop, which stops
//   at its residual test). The plain version is
//   anap3_tpu_torch/ops/nk_kernels.py:schur_bicgstab, the same loop run to
//   its whole budget with masked updates. It computes dp, k for
//     S(pp) = inv_dt pp - beta^2 (Dxi hx + hy DyTi),
//     hx = H^{-1}(Gxr pp IyTr), hy = H^{-1}(Ixr pp GyTr),
//     H^{-1} f = Vx (((Vxi f) VyiT) * inv_hlam) VyT,
//   every matrix (ni x ni) float64, with JAX's semantics: x0 = 0, r0 = rhat
//   = b, the stop test ||r||^2 <= tol^2 ||b||^2 at the top of an iteration,
//   the exit on ||s||^2 < tol^2 ||b||^2 with its x and r updates, and the
//   breakdown codes -11 (omega == 0 or alpha == 0) and -10 (rho == 0).
//
// Bound on the card: 28 products of 2 ni^3 operations an iteration (14 an
//   S-apply), 0.115 GFLOP at ni = 127, 1.7 us at 67 TFLOP/s; the operators
//   are 1.3 MB, read from L2. The chain is latency: 15 dependent phases an
//   iteration, each a grid barrier (1.2-1.7 us, scripts/launch_floor.cu),
//   a round trip to L2 for the operand bands and a 127-deep FMA chain.
// Design: one persistent cooperative launch (cudaLaunchAttributeCooperative)
//   of min(2 x tiles, co-resident) blocks of 256 threads, a thread an
//   element of a 16 x 16 output tile; a phase is one level of the product
//   chain, the x and y branches side by side (item = branch x tiles +
//   tile; block b takes items b, b + grid, ...), with a grid barrier
//   between dependent levels:
//     1 Gxr v | Ixr v     (v = p or s, formed from r, p, q on the fly;
//                          the x item of a tile also stores v's tile)
//     2 . IyTr | . GyTr   3 Vxi . |   4 (. VyiT) * inv_hlam
//     5 . VyT             6 Vx .      7 inv_dt v - beta^2 (Dxi hx + hy DyTi)
//   twice an iteration (q = S p, t = S s), then the x and r update: 15
//   barriers an iteration. Each product sums k in order in one FMA chain;
//   the operator bands are staged in shared memory 128 deep (one L2 round
//   trip a product at ni <= 128); the vector updates and scalars use the
//   torch loop's operation order,
//   each rounded (__dmul_rn / __dadd_rn: no contraction), so they differ
//   from the plain version only through the products' and dot products'
//   sum order.
//   The dot-product partials are written, one row a tile (the 256-slot
//   fixed-order tree of its elements), in the epilogue of the phase that
//   produces the vector; every block sums them over the tiles in the same
//   fixed order, so every block holds the same scalars and takes the same
//   stop decision: none is left behind at a grid barrier (the pattern of
//   fv_bicgstab.cu). p alternates between two buffers, so no block
//   overwrites a p another block still reads.
// Left for later: folding operator products ahead of time (7 to 4 products
//   a branch, other rounding), f64 mma.sync (DMMA) and TMA.
// No fallback: a card without cooperative launch is refused with an error.
#include <cooperative_groups.h>

#include "nk_common.cuh"

namespace nk {
namespace {

namespace cg = cooperative_groups;

struct Smem {
  double A[TILE][KS + 1];
  double B[KS][TILE + 1];
  double red[3][NT];  // tree scratch of up to three sums
  double sc[3];       // the sums a phase starts from
};

// The element of a tile that this thread owns.
struct Elem {
  size_t e;
  bool in;
};

__device__ __forceinline__ Elem elem(const Schur& S, int tile) {
  const int i = (tile / S.nt) * TILE + threadIdx.x / TILE;
  const int j = (tile % S.nt) * TILE + threadIdx.x % TILE;
  Elem el;
  el.in = i < S.ni && j < S.ni;
  el.e = el.in ? (size_t)i * S.ni + j : 0;
  return el;
}

// acc + sum_k A[i][k] B(k, j) over k = 0 .. ni-1, in k order, one FMA a
// term, for the thread's element (i, j) of the tile at (i0, j0). The A row
// band and the B column band are staged KS deep at a time, every load of a
// slab issued before the first is waited on (one L2 round trip a slab: one
// for ni <= 128).
template <class LoadB>
__device__ __forceinline__ double tile_dot(double acc, const double* A,
                                           LoadB loadB, int ni, int i0,
                                           int j0, Smem& sm) {
  const int ty = threadIdx.x / TILE, tx = threadIdx.x % TILE;
  for (int k0 = 0; k0 < ni; k0 += KS) {
#pragma unroll
    for (int u = 0; u < KS * TILE / NT; ++u) {
      const int idx = threadIdx.x + u * NT;
      const int ar = idx / KS, ak = k0 + idx % KS;  // A: row, k
      const int bk = k0 + idx / TILE, bc = idx % TILE;  // B: k, column
      sm.A[ar][idx % KS] =
          (i0 + ar < ni && ak < ni) ? A[(size_t)(i0 + ar) * ni + ak] : 0.0;
      sm.B[idx / TILE][bc] =
          (bk < ni && j0 + bc < ni) ? loadB((size_t)bk * ni + j0 + bc) : 0.0;
    }
    __syncthreads();
    const int kn = ni - k0 < KS ? ni - k0 : KS;
    for (int kk = 0; kk < kn; ++kk) acc = fma(sm.A[ty][kk], sm.B[kk][tx], acc);
    __syncthreads();
  }
  return acc;
}

// The fixed-order tree of the block's values v0 (and v1 when c1 >= 0)
// into row[c0] (row[c1]).
__device__ __forceinline__ void block_partial(Smem& sm, double* row, int c0, double v0,
                              int c1, double v1) {
  const int tid = threadIdx.x;
  sm.red[0][tid] = v0;
  sm.red[1][tid] = v1;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) {
      sm.red[0][tid] += sm.red[0][tid + s];
      if (c1 >= 0) sm.red[1][tid] += sm.red[1][tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    row[c0] = sm.red[0][0];
    if (c1 >= 0) row[c1] = sm.red[1][0];
  }
  __syncthreads();
}

// Every block: the sums over the tiles of the partial columns c0, c1, c2
// (-1: unused), in one fixed order, into sm.sc[0..2].
__device__ __forceinline__ void tile_sums(const Schur& S, Smem& sm, int c0, int c1 = -1,
                          int c2 = -1) {
  const int tid = threadIdx.x;
  const int n = c2 >= 0 ? 3 : c1 >= 0 ? 2 : 1;
  __syncthreads();
  for (int u = 0; u < n; ++u) {
    const int c = u == 0 ? c0 : u == 1 ? c1 : c2;
    double a = 0.0;
    for (int t = tid; t < S.tiles; t += NT) a += S.part[(size_t)t * PT_COUNT + c];
    sm.red[u][tid] = a;
  }
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int u = 0; u < n; ++u) sm.red[u][tid] += sm.red[u][tid + s];
    __syncthreads();
  }
  if (tid < n) sm.sc[tid] = sm.red[tid][0];
  __syncthreads();
}

// p = r + beta (p_old - omega q), in the torch loop's operation order
struct PDir {
  const double *r, *p, *q;
  double beta, omega;
  __device__ double operator()(size_t e) const {
    return __dadd_rn(r[e],
                     __dmul_rn(beta, __dsub_rn(p[e], __dmul_rn(omega, q[e]))));
  }
};

// s = r - alpha q
struct SDir {
  const double *r, *q;
  double alpha;
  __device__ double operator()(size_t e) const {
    return __dsub_rn(r[e], __dmul_rn(alpha, q[e]));
  }
};

// Level 1: Gxr v | Ixr v, v formed on the fly; the x item of a tile stores
// v's tile into vout and, when col >= 0, the partial of v.v.
template <class V>
__device__ __forceinline__ void level1(const Schur& S, Smem& sm, V v, double* vout,
                       int col) {
  for (int item = blockIdx.x; item < 2 * S.tiles; item += gridDim.x) {
    const int br = item / S.tiles, tile = item % S.tiles;
    const int i0 = (tile / S.nt) * TILE, j0 = (tile % S.nt) * TILE;
    const double acc =
        tile_dot(0.0, br ? S.Ixr : S.Gxr, v, S.ni, i0, j0, sm);
    const Elem el = elem(S, tile);
    if (el.in) (br ? S.w[1][0] : S.w[0][0])[el.e] = acc;
    if (br == 0) {
      double val = 0.0;
      if (el.in) {
        val = v(el.e);
        vout[el.e] = val;
      }
      if (col >= 0)
        block_partial(sm, S.part + (size_t)tile * PT_COUNT, col,
                      __dmul_rn(val, val), -1, 0.0);
    }
  }
}

// Levels 2-6: C[br] = A[br] B[br] (times inv_hlam when hlam), both branches.
__device__ __forceinline__ void level(const Schur& S, Smem& sm, const double* A0,
                      const double* A1, const double* B0, const double* B1,
                      double* C0, double* C1, bool hlam) {
  for (int item = blockIdx.x; item < 2 * S.tiles; item += gridDim.x) {
    const int br = item / S.tiles, tile = item % S.tiles;
    const int i0 = (tile / S.nt) * TILE, j0 = (tile % S.nt) * TILE;
    const double* B = br ? B1 : B0;
    const double acc = tile_dot(
        0.0, br ? A1 : A0, [B](size_t e) { return B[e]; }, S.ni, i0, j0, sm);
    const Elem el = elem(S, tile);
    if (el.in)
      (br ? C1 : C0)[el.e] = hlam ? __dmul_rn(acc, S.inv_hlam[el.e]) : acc;
  }
}

// Level 7: out = inv_dt v - beta^2 (Dxi hx + hy DyTi), one item a tile,
// with the partials of b.out (mode 0: q) or of out.s and out.out (mode 1:
// t, v = s).
__device__ __forceinline__ void level7(const Schur& S, Smem& sm, double inv_dt,
                       const double* v, double* out, int mode) {
  const double* hx = S.w[0][1];
  const double* hy = S.w[1][1];
  const double* DyTi = S.DyTi;
  for (int tile = blockIdx.x; tile < S.tiles; tile += gridDim.x) {
    const int i0 = (tile / S.nt) * TILE, j0 = (tile % S.nt) * TILE;
    const double d1 = tile_dot(
        0.0, S.Dxi, [hx](size_t e) { return hx[e]; }, S.ni, i0, j0, sm);
    const double d2 = tile_dot(
        0.0, hy, [DyTi](size_t e) { return DyTi[e]; }, S.ni, i0, j0, sm);
    const Elem el = elem(S, tile);
    double o = 0.0, vv = 0.0;
    if (el.in) {
      vv = v[el.e];
      o = __dsub_rn(__dmul_rn(inv_dt, vv),
                    __dmul_rn(S.beta_sq, __dadd_rn(d1, d2)));
      out[el.e] = o;
    }
    double* row = S.part + (size_t)tile * PT_COUNT;
    if (mode == 0)
      block_partial(sm, row, PT_RHQ, el.in ? __dmul_rn(S.b[el.e], o) : 0.0,
                    -1, 0.0);
    else
      block_partial(sm, row, PT_TS, __dmul_rn(o, vv), PT_TT, __dmul_rn(o, o));
  }
}

// One S-apply after level 1: levels 2-7, each behind a grid barrier.
__device__ __forceinline__ void chain(const Schur& S, Smem& sm, cg::grid_group& grid,
                      double inv_dt, const double* v, double* out,
                      int mode) {
  auto& w = S.w;
  grid.sync();
  level(S, sm, w[0][0], w[1][0], S.IyTr, S.GyTr, w[0][1], w[1][1], false);
  grid.sync();
  level(S, sm, S.Vxi, S.Vxi, w[0][1], w[1][1], w[0][0], w[1][0], false);
  grid.sync();
  level(S, sm, w[0][0], w[1][0], S.VyiT, S.VyiT, w[0][1], w[1][1], true);
  grid.sync();
  level(S, sm, w[0][1], w[1][1], S.VyT, S.VyT, w[0][0], w[1][0], false);
  grid.sync();
  level(S, sm, S.Vx, S.Vx, w[0][0], w[1][0], w[0][1], w[1][1], false);
  grid.sync();
  level7(S, sm, inv_dt, v, out, mode);
  grid.sync();
}

__global__ void __launch_bounds__(NT) schur_kernel(Schur S) {
  __shared__ Smem sm;
  cg::grid_group grid = cg::this_grid();
  const double inv_dt = *S.inv_dt;

  // x = 0, r = p = q = b, and the partials of b.b
  for (int tile = blockIdx.x; tile < S.tiles; tile += gridDim.x) {
    const Elem el = elem(S, tile);
    double bb = 0.0;
    if (el.in) {
      const double bv = S.b[el.e];
      S.x[el.e] = 0.0;
      S.r[el.e] = bv;
      S.p[0][el.e] = bv;
      S.q[el.e] = bv;
      bb = __dmul_rn(bv, bv);
    }
    block_partial(sm, S.part + (size_t)tile * PT_COUNT, PT_RR, bb, PT_RHR,
                  bb);
  }
  grid.sync();
  tile_sums(S, sm, PT_RR);
  const double atol2 = __dmul_rn(S.tol2, sm.sc[0]);

  double rho = 1.0, alpha = 1.0, omega = 1.0;
  int k = 0;
  for (int it = 0; it < S.maxiter; ++it) {
    tile_sums(S, sm, PT_RR, PT_RHR);
    const double rr = sm.sc[0], rho_ = sm.sc[1];
    if (!(rr > atol2 && k >= 0)) break;  // the same in every block
    const double beta = __ddiv_rn(__dmul_rn(__ddiv_rn(rho_, rho), alpha),
                                  omega);
    // selects, not indices: a parameter array indexed at run time would
    // be copied to the stack
    const double* p_old = (it & 1) ? S.p[1] : S.p[0];
    double* p = (it & 1) ? S.p[0] : S.p[1];

    level1(S, sm, PDir{S.r, p_old, S.q, beta, omega}, p, -1);
    chain(S, sm, grid, inv_dt, p, S.q, 0);  // q = S p

    tile_sums(S, sm, PT_RHQ);
    const double alpha_ = __ddiv_rn(rho_, sm.sc[0]);
    level1(S, sm, SDir{S.r, S.q, alpha_}, S.s, PT_SS);
    chain(S, sm, grid, inv_dt, S.s, S.t, 1);  // t = S s

    tile_sums(S, sm, PT_SS, PT_TS, PT_TT);
    const bool exit_early = sm.sc[0] < atol2;
    const double omega_ = __ddiv_rn(sm.sc[1], sm.sc[2]);
    for (int tile = blockIdx.x; tile < S.tiles; tile += gridDim.x) {
      const Elem el = elem(S, tile);
      double rn = 0.0, rh = 0.0;
      if (el.in) {
        const size_t e = el.e;
        const double ap = __dmul_rn(alpha_, p[e]);
        const double sv = S.s[e];
        S.x[e] = exit_early
                     ? __dadd_rn(S.x[e], ap)
                     : __dadd_rn(S.x[e], __dadd_rn(ap, __dmul_rn(omega_, sv)));
        rn = exit_early ? sv : __dsub_rn(sv, __dmul_rn(omega_, S.t[e]));
        S.r[e] = rn;
        rh = __dmul_rn(S.b[e], rn);
        rn = __dmul_rn(rn, rn);
      }
      block_partial(sm, S.part + (size_t)tile * PT_COUNT, PT_RR, rn, PT_RHR,
                    rh);
    }
    int k_ = (omega_ == 0.0 || alpha_ == 0.0) ? -11 : k + 1;
    if (rho_ == 0.0) k_ = -10;
    rho = rho_;
    alpha = alpha_;
    omega = omega_;
    k = k_;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *S.k = k;
}

// Co-resident blocks of schur_kernel on the current device (asked once,
// by the first launch: a graph captures launches after an eager warm-up).
cudaError_t schur_coresident(int* blocks) {
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, schur_kernel,
                                                        NT, 0);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return err;
  cached = per_sm * sms;
  *blocks = cached;
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_schur(const Schur& S, cudaStream_t s) {
  int most = 0;
  cudaError_t err = schur_coresident(&most);
  if (err != cudaSuccess) return err;
  const int items = 2 * S.tiles;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items < most ? items : most);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, schur_kernel, S);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace nk
