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
// Bound on the card: 28 products of 2 ni^3 operations an iteration in the
//   unfolded form (0.115 GFLOP at ni = 127, 1.7 us at 67 TFLOP/s); the
//   operators are 1.3 MB, read from L2. The chain is latency: every
//   dependent product level is a grid barrier (1.2-1.7 us,
//   scripts/launch_floor.cu) and a round trip to L2 for a vector's band.
// Design: one persistent cooperative launch (cudaLaunchAttributeCooperative)
//   of 256-thread blocks. The operators are folded ahead of time on the
//   host (ops/nk_kernels.py:SchurOps, zero-padded to np = 16 nt):
//     Lx = Vxi Gxr, Ly = Vxi Ixr, Rx = IyTr VyiT, Ry = GyTr VyiT,
//     Cx = Dxi Vx, Ey = VyT DyTi,
//   so an S-apply is 4 product levels, each a phase behind a grid barrier,
//   the x and y branches side by side (item = branch x tiles + tile):
//     1 Lx v | Ly v       (v = p or s, formed from r, p, q on the fly; the
//                          x item of a tile also stores v's tile)
//     2 (. Rx) * inv_hlam | (. Ry) * inv_hlam
//     3 Cx . | Vx .
//     4 inv_dt v - beta^2 (ax VyT + ay Ey)   (x items only; one product
//                          of [ax ay] and [VyT; Ey], 2 np deep)
//   twice an iteration (q = S p, t = S s), then the x and r update: 9
//   barriers an iteration (15 unfolded), 16 products (28).
//   Where 2 x tiles blocks fit on the card at once and np <= 128 (N <=
//   129), each block owns one item for the whole launch and holds its
//   operator bands in shared memory (RES: an x item the row bands of Lx
//   and Cx and the column bands of Rx, VyT and Ey, a y item those of Ly,
//   Vx and Ry); after a barrier only the vector's band comes from L2, by
//   cp.async. Above that the blocks loop over the items and stream every
//   band, 128 deep a slab, as the operands of one phase are final.
//   A 16 x 16 output tile is four 8 x 8 f64 tensor-core products
//   (mma.sync m8n8k4, DMMA); the 8 warps split k into contiguous blocks,
//   and the warp partials are summed in warp order, compensated.
//   The vector updates and scalars use the torch loop's operation order,
//   each rounded (__dmul_rn / __dadd_rn: no contraction), so they differ
//   from the plain version only through the fold and the products' and dot
//   products' sum order.
//   The dot-product partials are written, one row a tile (a fixed-order
//   warp-shuffle tree of the block's elements), in the epilogue of the
//   phase that produces the vector; every warp of every block sums them
//   over the tiles in the same fixed order (a butterfly that leaves the
//   same bits in every lane), so every block holds the same scalars and
//   takes the same stop decision: none is left behind at a grid barrier
//   (the pattern of fv_bicgstab.cu). p alternates between two buffers, so
//   no block overwrites a p another block still reads.
// No fallback: a card without cooperative launch is refused with an error.
#include <cooperative_groups.h>

#include "nk_common.cuh"

namespace nk {
namespace {

namespace cg = cooperative_groups;

constexpr int SA = KS + 4;     // row stride of an A (row) band, doubles
constexpr int SB = TILE + 4;   // row stride of a B (column) band
constexpr int A_BAND = TILE * SA;
constexpr int B_BAND = KS * SB;
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory, in doubles: the resident operator bands (RES
// only), the staged bands, the warp partials of a tile and the tree
// scratch of two block sums.
template <bool RES>
struct Lay {
  static constexpr int RA = 0;                              // 2 A bands
  static constexpr int RB = RES ? 2 * A_BAND : 0;           // 3 B bands
  static constexpr int AS = RB + (RES ? 3 * B_BAND : 0);    // 2 A bands
  static constexpr int BS = AS + 2 * A_BAND;                // 2 B bands
  static constexpr int CB = BS + 2 * B_BAND;                // WARPS x NT
  static constexpr int RED = CB + WARPS * NT;               // 2 x WARPS
  static constexpr int SIZE = RED + 2 * WARPS;
};

extern __shared__ __align__(16) double smem[];

// The element of a tile that this thread owns: e in the (np x np)
// workspace, eu in the (ni x ni) operands.
struct Elem {
  size_t e, eu;
  bool in;
};

__device__ __forceinline__ Elem elem(const Schur& S, int tile) {
  const int i = (tile / S.nt) * TILE + threadIdx.x / TILE;
  const int j = (tile % S.nt) * TILE + threadIdx.x % TILE;
  Elem el;
  el.in = i < S.ni && j < S.ni;
  el.e = (size_t)i * S.np + j;
  el.eu = el.in ? (size_t)i * S.ni + j : 0;
  return el;
}

__device__ __forceinline__ const double* op(const Schur& S, int o) {
  return S.ops + (size_t)o * S.np * S.np;
}

__device__ __forceinline__ void cp16(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Wait for every cp.async this thread issued; a __syncthreads must follow
// before another thread reads them.
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Rows i0 .. i0+15, columns k0 .. k0+kn-1 of the (np x np) matrix M into an
// A band (kn a multiple of 16: every row start is 16-byte aligned).
__device__ __forceinline__ void load_a(double* dst, const double* M, int np,
                                       int i0, int k0, int kn) {
  const int per_row = kn / 2;
  for (int idx = threadIdx.x; idx < TILE * per_row; idx += NT) {
    const int r = idx / per_row, c = idx % per_row;
    cp16(dst + r * SA + 2 * c, M + (size_t)(i0 + r) * np + k0 + 2 * c);
  }
}

// Rows k0 .. k0+kn-1, columns j0 .. j0+15 of M into a B band.
__device__ __forceinline__ void load_b(double* dst, const double* M, int np,
                                       int k0, int kn, int j0) {
  for (int idx = threadIdx.x; idx < kn * (TILE / 2); idx += NT) {
    const int r = idx / (TILE / 2), c = idx % (TILE / 2);
    cp16(dst + r * SB + 2 * c, M + (size_t)(k0 + r) * np + j0 + 2 * c);
  }
}

// The B band of the vector v (formed element by element), zero beyond ni.
template <class V>
__device__ __forceinline__ void form_b(double* dst, const Schur& S, V v,
                                       int k0, int kn, int j0) {
  for (int idx = threadIdx.x; idx < kn * TILE; idx += NT) {
    const int r = idx / TILE, c = idx % TILE;
    const int i = k0 + r, j = j0 + c;
    dst[r * SB + c] =
        (i < S.ni && j < S.ni) ? v((size_t)i * S.np + j) : 0.0;
  }
}

// c += a b on the f64 tensor cores: one 8x8x4 product of the warp (a: row
// lane/4, column lane%4; b: row lane%4, column lane/4; c: row lane/4,
// columns 2 (lane%4) and 2 (lane%4) + 1).
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, "
      "{%3}, {%0,%1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// acc += A B over this warp's k steps of a slab kn deep (A an A band, B a
// B band): the 16 x 16 tile as 2 x 2 products of 8 x 8. Warp w takes the
// w-th of 8 contiguous blocks of the slab's kn / 4 k steps.
__device__ __forceinline__ void mma_slab(double (&acc)[2][2][2],
                                         const double* A, const double* B,
                                         int kn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int steps = kn / 4, per = (steps + WARPS - 1) / WARPS;
  const int lo = warp * per, hi = min(steps, lo + per);
  for (int ks = lo; ks < hi; ++ks) {
    const int k = ks * 4 + t;
    const double a0 = A[g * SA + k], a1 = A[(g + 8) * SA + k];
    const double b0 = B[k * SB + g], b1 = B[k * SB + 8 + g];
    dmma(acc[0][0], a0, b0);
    dmma(acc[0][1], a0, b1);
    dmma(acc[1][0], a1, b0);
    dmma(acc[1][1], a1, b1);
  }
}

__device__ __forceinline__ void zero(double (&acc)[2][2][2]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) acc[m][n][0] = acc[m][n][1] = 0.0;
}

// The tile's product for this thread's element (threadIdx / 16,
// threadIdx % 16): the warps' partials summed in warp order, compensated
// (each addition's rounding error, by TwoSum, added at the end).
template <bool RES>
__device__ __forceinline__ double combine(const double (&acc)[2][2][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  double* cb = smem + Lay<RES>::CB;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      double* at = cb + warp * NT + (m * 8 + g) * TILE + n * 8 + 2 * t;
      at[0] = acc[m][n][0];
      at[1] = acc[m][n][1];
    }
  __syncthreads();
  double sum = cb[threadIdx.x], err = 0.0;
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    const double p = cb[w * NT + threadIdx.x];
    const double s = __dadd_rn(sum, p), bp = __dsub_rn(s, sum);
    err = __dadd_rn(err, __dadd_rn(__dsub_rn(sum, __dsub_rn(s, bp)),
                                   __dsub_rn(p, bp)));
    sum = s;
  }
  __syncthreads();
  return __dadd_rn(sum, err);
}

// The fixed-order tree of a warp's values: lane 0 holds the sum.
__device__ __forceinline__ double warp_tree(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// The sum of the block's values v0 (and v1 when c1 >= 0) into row[c0]
// (row[c1]): each warp's tree, then the warp sums in warp order.
template <bool RES>
__device__ __forceinline__ void block_partial(double* row, int c0, double v0,
                                              int c1, double v1) {
  double* red = smem + Lay<RES>::RED;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v0 = warp_tree(v0);
  v1 = warp_tree(v1);
  __syncthreads();  // the last call's reads are done
  if (lane == 0) {
    red[warp] = v0;
    red[WARPS + warp] = v1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double a = red[0], b = red[WARPS];
    for (int w = 1; w < WARPS; ++w) {
      a += red[w];
      b += red[WARPS + w];
    }
    row[c0] = a;
    if (c1 >= 0) row[c1] = b;
  }
}

// Every warp: the sum over the tiles of the partial column c, in one fixed
// order (each lane's tiles in order, then a butterfly, whose every lane
// ends with the same bits: a + b == b + a). No shared memory, no barrier.
__device__ __forceinline__ double tile_sum(const Schur& S, int c) {
  double a = 0.0;
  for (int t = threadIdx.x & 31; t < S.tiles; t += 32)
    a += S.part[(size_t)t * PT_COUNT + c];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(FULL, a, o);
  return a;
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

// The resident bands of this block's item (RES: one item a block).
__device__ __forceinline__ void load_resident(const Schur& S) {
  const int br = blockIdx.x / S.tiles, tile = blockIdx.x % S.tiles;
  const int i0 = (tile / S.nt) * TILE, j0 = (tile % S.nt) * TILE;
  double* ra = smem + Lay<true>::RA;
  double* rb = smem + Lay<true>::RB;
  load_a(ra, op(S, O_LX + br), S.np, i0, 0, S.np);
  load_a(ra + A_BAND, op(S, br ? O_VX : O_CX), S.np, i0, 0, S.np);
  load_b(rb, op(S, O_RX + br), S.np, 0, S.np, j0);
  if (br == 0) {
    load_b(rb + B_BAND, op(S, O_VYT), S.np, 0, S.np, j0);
    load_b(rb + 2 * B_BAND, op(S, O_EY), S.np, 0, S.np, j0);
  }
}

// Level 1: Lx v | Ly v, v formed on the fly; the x item of a tile stores
// v's tile into vout and, when col >= 0, the partial of v.v.
template <bool RES, class V>
__device__ __forceinline__ void level1(const Schur& S, V v, double* vout,
                                       int col) {
  using L = Lay<RES>;
  for (int item = blockIdx.x; item < 2 * S.tiles; item += gridDim.x) {
    const int br = item / S.tiles, tile = item % S.tiles;
    const int i0 = (tile / S.nt) * TILE, j0 = (tile % S.nt) * TILE;
    double acc[2][2][2];
    zero(acc);
    for (int k0 = 0; k0 < S.np; k0 += KS) {
      const int kn = S.np - k0 < KS ? S.np - k0 : KS;
      const double* A = smem + (RES ? L::RA : L::AS);
      if (!RES) load_a(smem + L::AS, op(S, O_LX + br), S.np, i0, k0, kn);
      form_b(smem + L::BS, S, v, k0, kn, j0);
      cp_wait();
      __syncthreads();
      mma_slab(acc, A, smem + L::BS, kn);
      __syncthreads();
    }
    const double d = combine<RES>(acc);
    const Elem el = elem(S, tile);
    // selects, not indices: a parameter array indexed at run time would
    // be copied to the stack
    (br ? S.w[1][0] : S.w[0][0])[el.e] = el.in ? d : 0.0;
    if (br == 0) {
      const double val = el.in ? v(el.e) : 0.0;
      vout[el.e] = val;
      if (col >= 0)
        block_partial<RES>(S.part + (size_t)tile * PT_COUNT, col,
                           __dmul_rn(val, val), -1, 0.0);
    }
  }
}

// Level 2: (w Rx) * inv_hlam | (w Ry) * inv_hlam.
template <bool RES>
__device__ __forceinline__ void level2(const Schur& S) {
  using L = Lay<RES>;
  for (int item = blockIdx.x; item < 2 * S.tiles; item += gridDim.x) {
    const int br = item / S.tiles, tile = item % S.tiles;
    const int i0 = (tile / S.nt) * TILE, j0 = (tile % S.nt) * TILE;
    double acc[2][2][2];
    zero(acc);
    for (int k0 = 0; k0 < S.np; k0 += KS) {
      const int kn = S.np - k0 < KS ? S.np - k0 : KS;
      const double* B = smem + (RES ? L::RB : L::BS);
      load_a(smem + L::AS, br ? S.w[1][0] : S.w[0][0], S.np, i0, k0, kn);
      if (!RES) load_b(smem + L::BS, op(S, O_RX + br), S.np, k0, kn, j0);
      cp_wait();
      __syncthreads();
      mma_slab(acc, smem + L::AS, B, kn);
      __syncthreads();
    }
    const double d = combine<RES>(acc);
    const Elem el = elem(S, tile);
    (br ? S.w[1][1] : S.w[0][1])[el.e] =
        el.in ? __dmul_rn(d, S.inv_hlam[el.eu]) : 0.0;
  }
}

// Level 3: Cx z | Vx z.
template <bool RES>
__device__ __forceinline__ void level3(const Schur& S) {
  using L = Lay<RES>;
  for (int item = blockIdx.x; item < 2 * S.tiles; item += gridDim.x) {
    const int br = item / S.tiles, tile = item % S.tiles;
    const int i0 = (tile / S.nt) * TILE, j0 = (tile % S.nt) * TILE;
    double acc[2][2][2];
    zero(acc);
    for (int k0 = 0; k0 < S.np; k0 += KS) {
      const int kn = S.np - k0 < KS ? S.np - k0 : KS;
      const double* A = smem + (RES ? L::RA + A_BAND : L::AS);
      if (!RES)
        load_a(smem + L::AS, op(S, br ? O_VX : O_CX), S.np, i0, k0, kn);
      load_b(smem + L::BS, br ? S.w[1][1] : S.w[0][1], S.np, k0, kn, j0);
      cp_wait();
      __syncthreads();
      mma_slab(acc, A, smem + L::BS, kn);
      __syncthreads();
    }
    const double d = combine<RES>(acc);
    const Elem el = elem(S, tile);
    (br ? S.w[1][2] : S.w[0][2])[el.e] = el.in ? d : 0.0;
  }
}

// Level 4: out = inv_dt v - beta^2 (ax VyT + ay Ey), one item a tile (the
// x items), with the partials of b.out (mode 0: q) or of out.s and
// out.out (mode 1: t, v = s).
template <bool RES>
__device__ __forceinline__ void level4(const Schur& S, double inv_dt,
                                       const double* v, double* out,
                                       int mode) {
  using L = Lay<RES>;
  for (int tile = blockIdx.x; tile < S.tiles; tile += gridDim.x) {
    const int i0 = (tile / S.nt) * TILE, j0 = (tile % S.nt) * TILE;
    double acc[2][2][2];
    zero(acc);
    for (int k0 = 0; k0 < S.np; k0 += KS) {
      const int kn = S.np - k0 < KS ? S.np - k0 : KS;
      const double* B0 = smem + (RES ? L::RB + B_BAND : L::BS);
      const double* B1 = smem + (RES ? L::RB + 2 * B_BAND : L::BS + B_BAND);
      load_a(smem + L::AS, S.w[0][2], S.np, i0, k0, kn);
      load_a(smem + L::AS + A_BAND, S.w[1][2], S.np, i0, k0, kn);
      if (!RES) {
        load_b(smem + L::BS, op(S, O_VYT), S.np, k0, kn, j0);
        load_b(smem + L::BS + B_BAND, op(S, O_EY), S.np, k0, kn, j0);
      }
      cp_wait();
      __syncthreads();
      mma_slab(acc, smem + L::AS, B0, kn);
      mma_slab(acc, smem + L::AS + A_BAND, B1, kn);
      __syncthreads();
    }
    const double d = combine<RES>(acc);
    const Elem el = elem(S, tile);
    double o = 0.0, vv = 0.0;
    if (el.in) {
      vv = v[el.e];
      o = __dsub_rn(__dmul_rn(inv_dt, vv), __dmul_rn(S.beta_sq, d));
    }
    out[el.e] = o;
    double* row = S.part + (size_t)tile * PT_COUNT;
    if (mode == 0)
      block_partial<RES>(row, PT_RHQ, el.in ? __dmul_rn(S.b[el.eu], o) : 0.0,
                         -1, 0.0);
    else
      block_partial<RES>(row, PT_TS, __dmul_rn(o, vv), PT_TT,
                         __dmul_rn(o, o));
  }
}

// One S-apply: levels 1-4, each behind a grid barrier.
template <bool RES, class V>
__device__ __forceinline__ void s_apply(const Schur& S, cg::grid_group& grid,
                                        double inv_dt, V v, double* vout,
                                        int col, double* out, int mode) {
  level1<RES>(S, v, vout, col);
  grid.sync();
  level2<RES>(S);
  grid.sync();
  level3<RES>(S);
  grid.sync();
  level4<RES>(S, inv_dt, vout, out, mode);
  grid.sync();
}

template <bool RES>
__global__ void __launch_bounds__(NT) schur_kernel(Schur S) {
  cg::grid_group grid = cg::this_grid();
  const double inv_dt = *S.inv_dt;
  if (RES) load_resident(S);  // waited on by the first level's cp_wait

  // x = 0, r = p = q = b, and the partials of b.b
  for (int tile = blockIdx.x; tile < S.tiles; tile += gridDim.x) {
    const Elem el = elem(S, tile);
    const double bv = el.in ? S.b[el.eu] : 0.0;
    if (el.in) S.x[el.eu] = 0.0;
    S.r[el.e] = bv;
    S.p[0][el.e] = bv;
    S.q[el.e] = bv;
    const double bb = __dmul_rn(bv, bv);
    block_partial<RES>(S.part + (size_t)tile * PT_COUNT, PT_RR, bb, PT_RHR,
                       bb);
  }
  grid.sync();
  const double atol2 = __dmul_rn(S.tol2, tile_sum(S, PT_RR));

  double rho = 1.0, alpha = 1.0, omega = 1.0;
  int k = 0;
  for (int it = 0; it < S.maxiter; ++it) {
    const double rr = tile_sum(S, PT_RR), rho_ = tile_sum(S, PT_RHR);
    if (!(rr > atol2 && k >= 0)) break;  // the same in every block
    const double beta = __ddiv_rn(__dmul_rn(__ddiv_rn(rho_, rho), alpha),
                                  omega);
    // selects, not indices: a parameter array indexed at run time would
    // be copied to the stack
    const double* p_old = (it & 1) ? S.p[1] : S.p[0];
    double* p = (it & 1) ? S.p[0] : S.p[1];

    s_apply<RES>(S, grid, inv_dt, PDir{S.r, p_old, S.q, beta, omega}, p, -1,
                 S.q, 0);  // q = S p
    const double alpha_ = __ddiv_rn(rho_, tile_sum(S, PT_RHQ));
    s_apply<RES>(S, grid, inv_dt, SDir{S.r, S.q, alpha_}, S.s, PT_SS, S.t,
                 1);  // t = S s

    const bool exit_early = tile_sum(S, PT_SS) < atol2;
    const double omega_ = __ddiv_rn(tile_sum(S, PT_TS), tile_sum(S, PT_TT));
    for (int tile = blockIdx.x; tile < S.tiles; tile += gridDim.x) {
      const Elem el = elem(S, tile);
      double rn = 0.0, rh = 0.0;
      if (el.in) {
        const size_t e = el.e;
        const double ap = __dmul_rn(alpha_, p[e]);
        const double sv = S.s[e];
        S.x[el.eu] = exit_early ? __dadd_rn(S.x[el.eu], ap)
                                : __dadd_rn(S.x[el.eu],
                                            __dadd_rn(ap, __dmul_rn(omega_, sv)));
        rn = exit_early ? sv : __dsub_rn(sv, __dmul_rn(omega_, S.t[e]));
        rh = __dmul_rn(S.b[el.eu], rn);
      }
      S.r[el.e] = rn;
      block_partial<RES>(S.part + (size_t)tile * PT_COUNT, PT_RR,
                         __dmul_rn(rn, rn), PT_RHR, rh);
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

// Co-resident blocks of schur_kernel<RES> on the current device, with its
// dynamic shared memory allowed first (asked once, by the first launch: a
// graph captures launches after an eager warm-up).
template <bool RES>
cudaError_t schur_coresident(int* blocks) {
  static int cached = 0;
  if (cached) {
    *blocks = cached;
    return cudaSuccess;
  }
  constexpr int bytes = Lay<RES>::SIZE * (int)sizeof(double);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(schur_kernel<RES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, schur_kernel<RES>, NT, bytes);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return err;
  cached = per_sm * sms;
  *blocks = cached;
  return cudaSuccess;
}

template <bool RES>
cudaError_t launch(const Schur& S, int grid, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Lay<RES>::SIZE * sizeof(double);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, schur_kernel<RES>, S);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The geometry launch_schur takes for order ni: the resident one (one item
// a block, the operator bands in shared memory) where np <= KS and 2 x
// tiles blocks fit at once, else the streamed one on every co-resident
// block (grid blocks).
cudaError_t schur_geometry(int ni, int* resident, int* grid) {
  const int nt = (ni + TILE - 1) / TILE;
  const int items = 2 * nt * nt;
  int most = 0;
  cudaError_t err;
  if (nt * TILE <= KS) {
    err = schur_coresident<true>(&most);
    if (err != cudaSuccess) return err;
    if (items <= most) {
      *resident = 1;
      *grid = items;
      return cudaSuccess;
    }
  }
  err = schur_coresident<false>(&most);
  if (err != cudaSuccess) return err;
  *resident = 0;
  *grid = items < most ? items : most;
  return cudaSuccess;
}

cudaError_t launch_schur(const Schur& S, cudaStream_t s) {
  int resident = 0, grid = 0;
  const cudaError_t err = schur_geometry(S.ni, &resident, &grid);
  if (err != cudaSuccess) return err;
  return resident ? launch<true>(S, grid, s) : launch<false>(S, grid, s);
}

}  // namespace nk
