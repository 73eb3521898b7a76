// sg_resident: a whole SG chunk in ONE launch, at the orders where a lane's
// operators and state fit in one thread-block cluster's shared memory
// (resident_geometry below: float32 to N = 51, float64 to N = 31).
//
// Replaces, at those orders: the launches of sg_chunk_run and
//   sg_lanes_chunk_run (sg_host.cu: dt_kernel at a chunk's first step,
//   then four stage_kernel launches and one control_kernel or tail_kernel
//   a step), i.e. the fori_loop of anap3_tpu/ops/pallas_aligned.py
//   make_aligned_chunk_runner, pallas_tiled.py make_tiled_chunk_runner,
//   pallas_lanes.py make_lane_chunk_runner and pallas_lanes_aligned.py
//   make_aligned_lane_runner (PERF.md rows #1, #3, #9, #10). Semantics:
//   anap3_tpu/models/runner.py make_chunk_runner.
//
// Bound on the card: at N = 48 a stage is ~2.8 MFLOP and a step's
//   operands ~0.2 MB, so neither the FMA pipes nor HBM bound it (0.00017
//   ms a step); the multi-launch chunk spends ~0.05 ms a step in five
//   launches, each waiting for its clusters, loading its operator bands
//   from L2 again and writing the state back for the next to read. Here a
//   stage is bound by the issue of its k chains on the cluster's few SMs
//   (at N = 48, 7 SMs of 16 warps), then by the exchange of the state.
// Design:
//   - a lane is one cluster, one block a row band of 8 rows (the stage
//     geometry's rows: at most 8, a portable cluster), lanes the grid's z
//     axis; the launch loads the operators and the chunk's state into
//     every block's shared memory once and marches every step there.
//   - each block holds the column-side operators whole, the row-side ones
//     on its band, and two copies of the state (a stage reads one and
//     writes the other); pairs loaded together are interleaved (u with v,
//     Dx with Dxx, ...), so a k step of a thread's 2 x 2 takes 5 vector
//     loads for its 32 fused multiply-adds; a sub-block of 4 warps (the 4
//     k groups) computes one of the band's 16-column tiles with the stage
//     kernel's threads.
//   - a stage: the band's own rows' products (u DyT, ...); the wait for
//     the previous stage's bands; the column products (Dx u, ...) and Gx
//     p, Ix p; each point's sums over the k groups, one point a thread,
//     through shared memory; a block barrier (the band of Gx p, Ix p); the
//     pressure chains and their sums; the epilogue, one point a thread;
//     on the last stage the tiles' partials (k group 0's warp trees); a
//     block barrier; then one thread a peer copies the band's state rows
//     (one run: a state row holds its p row) and on the last stage the
//     tiles' partials into every peer by cp.async.bulk, completing on the
//     peer's mbarrier of that copy. No cluster barrier in the step: a
//     block's bands arriving are the only wait, and they also tell it that
//     every peer is done reading the copy it next writes.
//   - the step's finish: on a sampled step each block computes the
//     vorticity of its band and gathers the others' (bulk copies, an
//     mbarrier), then energy, enstrophy and palinstrophy on its band,
//     gathered the same way, and sums every 16 x 16 tile; then every
//     block runs the tail's reductions and state machine (finish_lane) on
//     its own copies; block 0 writes the rows. The chunk's first dt is
//     dt_kernel's tree, which every block runs on its copy of the base.
//   - at the end each block writes its band of the state back, block 0
//     the flags and the residual normalization, and a cluster barrier
//     keeps every block until no copy can still read it.
// Bits: every output equals the multi-launch chunk's. Each product is the
//   stage kernel's chain: k group g takes k = g, g + 4, ... ascending in
//   fused multiply-adds (fma4), and a point's sum adds the groups in group
//   order; the epilogue's expressions are the stage kernel's; each tile's
//   partials are its warp tree (the terms added in the stage kernel's
//   point order and contraction); the quadratures are the tail kernel's
//   k-ascending chains and 256-slot tile trees; the lane sums are
//   warp_tree's over the same rows; the finish is finish_lane; the first
//   dt is dt_kernel's slots and tree. Only the order of independent work
//   differs, never a sum's.
#include <cooperative_groups.h>

#include "sg_common.cuh"

namespace sg {
namespace cg = cooperative_groups;

cudaError_t resident_geometry(int nf, int elem, const StageGeo& g,
                              ResidentGeo* r) {
  if (nf < 3 || (elem != 4 && elem != 8)) return cudaErrorInvalidValue;
  // a block a row band, a sub-block a column tile of it
  const ResidentGeo y{g.rows, g.cluster,
                      (int)res_smem_bytes(nf, elem, g.cluster, g.nparts)};
  const bool ok = !g.x1 && g.tn == RES_TN && g.ksplit == RES_KSPLIT &&
                  y.cluster <= MAX_CLUSTER && y.sub <= res_max_sub(elem) &&
                  y.smem <= MAX_SMEM;
  if (!ok) return cudaErrorInvalidValue;
  *r = y;
  return cudaSuccess;
}

namespace {

// the low-storage RK4 stage weights (sg_host.cu:kAlphas), as doubles
__device__ __forceinline__ double res_alpha(int st) {
  return st == 0 ? 0.25 : st == 1 ? 1.0 / 3.0 : st == 2 ? 0.5 : 1.0;
}

// The 128 threads of sub-block `bar - 1` (named barrier `bar`).
__device__ __forceinline__ void sub_sync(int bar) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(RES_SUB_THREADS)
               : "memory");
}

// The cluster address of this block's shared-memory address a in block
// `rank` of the cluster.
__device__ __forceinline__ unsigned peer_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The mbarrier of a state copy: one arrival a phase (the block's own
// expectation of the bytes its peers send), the peers' bulk copies
// completing the bytes.
__device__ __forceinline__ void mbar_init(unsigned a) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned a, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(a),
      "r"(bytes)
      : "memory");
}
// Returns once the phase of the given parity has completed; traps (a
// launch failure the host entry reports) after two seconds without, which
// only a fault of the exchange could cause.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait(unsigned a, unsigned parity) {
  unsigned done = 0;
  unsigned long long t0 = 0;
  for (unsigned spins = 0; !done; ++spins) {
    if ((spins & 1023u) == 1023u) {
      const unsigned long long t = global_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 2000000000ull) __trap();
    }
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// `bytes` of this block's shared memory from src (16-byte units) to dst
// in a peer's, completing on the peer's mbarrier mbar.
__device__ __forceinline__ void bulk_to_peer(unsigned dst, unsigned src,
                                             unsigned bytes, unsigned mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

// This thread's shared-memory writes, visible to the bulk copies after the
// next block barrier.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ typename Vec2<T>::type pair(T a, T b) {
  typename Vec2<T>::type r;
  r.x = a;
  r.y = b;
  return r;
}

// Two adjacent pairs (x0, y0, x1, y1) in one load where the element type
// allows (16 bytes): x = (x0, x1), y = (y0, y1). p aligned to 4 elements.
__device__ __forceinline__ void ld4(const float* p, float2& x, float2& y) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  x = make_float2(w.x, w.z);
  y = make_float2(w.y, w.w);
}
__device__ __forceinline__ void ld4(const double* p, double2& x,
                                    double2& y) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  x = make_double2(a.x, b.x);
  y = make_double2(a.y, b.y);
}

// A lane's partial-sum column col[b * stride], b < nb <= 32, as
// warp_tree<MAX> sums it (with at most 32 slots filled, its first pass and
// register levels leave slot l's value as it is), in lane 0.
template <bool MAX, typename T>
__device__ __forceinline__ T short_tree(const T* col, int stride, int nb,
                                        int l) {
  T r = fold<MAX>(T(0), l < nb ? col[l * stride] : T(0));
#pragma unroll
  for (int lv = 0; lv < 5; ++lv)
    r = fold<MAX>(r, __shfl_down_sync(0xffffffffu, r, 16 >> lv));
  return r;
}

// tile_tree of a quadrature tile's cells read from a grid g (leading
// dimension ld) at the tile's origin (i0, j0), zero off the nf x nf grid.
template <typename T>
__device__ __forceinline__ T tile_sum_grid(const T* g, int ld, int i0, int j0,
                                           int nf, int l) {
  return tile_tree<T>(
      [&](int e) {
        const int i = i0 + e / TILE, j = j0 + e % TILE;
        return i < nf && j < nf ? g[i * ld + j] : T(0);
      },
      l);
}

template <typename T>
__global__ void __launch_bounds__(RES_SUB_THREADS * res_max_sub(sizeof(T)), 1)
    resident_chunk_kernel(Ops<T> o0, ResArgs<T> a) {
  using V = typename Vec2<T>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = blockIdx.z, nf = a.nf, ni = nf - 2;
  const Ops<T> o = at_lane(o0, lane, nf);
  const int C = a.cluster, S = a.sub, ntiles = C * S;
  const ResLayout y = res_layout(nf, S, ntiles);
  const int L = y.L, Lp = y.Lp, RW = y.RW, Lo = y.Lo, P0 = 2 * L;
  const int rank = (int)cluster.block_rank();  // the block's row band
  const int tid = threadIdx.x, nt = blockDim.x;
  const int sb = tid / RES_SUB_THREADS, st0 = tid % RES_SUB_THREADS;
  const int kg = st0 / 32, t0 = st0 % 32, bar = 1 + sb;
  const int r0 = (t0 / (RES_TN / 2)) * 2, c = (t0 % (RES_TN / 2)) * 2;
  const int nt1 = tiles(nf), nq = nt1 * nt1;
  const int row0 = rank * STAGE_TM, col0 = sb * RES_TN;
  const int rows = min(STAGE_TM, nf - row0);  // the band's rows on the grid
  const int i0 = row0 + r0, j0 = col0 + c;     // this thread's 2 x 2
  const int ii = min(i0, L - 2), jj = min(j0, L - 2), jp = min(j0, Lp - 2);
  // the point of the 2 x 2 whose sums and epilogue are this thread's
  const int q = kg, pi = i0 + q / 2, pj = j0 + q % 2;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // mbarriers: state copy 0, copy 1, the vorticity, the quadrature cells
  const unsigned mb0 = smem_u32(smem_raw + RES_MBAR);
  const unsigned mbo = mb0 + 16, mbc = mb0 + 24;
  int* flags = reinterpret_cast<int*>(smem_raw + RES_FLAGS);
  T* const sm = reinterpret_cast<T*>(smem_raw + RES_HEADER);
  T* const DY = sm + y.ops;        // [k][j]: DyT, DyyT
  T* const IG = DY + 2 * nf * L;   // [k][j]: IyT, GyT (k < ni)
  T* const DxT = IG + 2 * ni * L;  // [k][i]: Dx[i][k]
  T* const DXB = sm + y.bops;      // [k][r]: Dx, Dxx at row row0 + r
  T* const GIB = DXB + 2 * STAGE_TM * nf;  // [k][r]: Gx, Ix (k < ni)
  T* const F0 = sm + y.f;  // [i]: (u, v)[i][j], then p[i - 1][j]
  T* const F1 = F0 + y.fcopy;
  T* const GPB = sm + y.band;     // [k][r]: (Gx p, Ix p)[row0 + r][k]
  T* const omega = sm + y.omega;  // [i][j] (ld Lo), a sampled step's
  T* const vals = sm + y.uni;     // [i][3][j] (ld Lo): the cells
  T* const tree = sm + y.uni;     // [4][RED_THREADS], the first dt's
  T* const B0 = sm + y.base;    // [r][j]: the base's (u, v) on the band
  T* const BC = B0 + 2 * STAGE_TM * L;  // [r][j]: (bc_u, bc_v) on the band
  T* const bp0 = BC + 2 * STAGE_TM * L;  // [r][j]: p of grid row row0 + r
  T* const xr = sm + y.xr + sb * RES_XR;  // [k group][value][32]
  T* const part = sm + y.part;  // [tile][RES_PROW]: NPART, then NDPART
  T* const qpart = sm + y.qpart;  // [quadrature tile][NQPART]
  T* const scal = sm + y.small;
  T* const sums = scal + S_COUNT;
  T* const dummy = sums + TAIL_COLS;  // the rows of the blocks but 0
  T* const res = dummy + 7;
  T* const refn = res + 4;
  T* const lsc = refn + 1;  // the lane's scalar table (H_COUNT)

  // the bytes the peers send a stage (their bands' state rows, and on a
  // step's last stage their tiles' partials) and a sampled step (their
  // bands' vorticity, then their bands' cells)
  unsigned in_band = 0, in_omega = 0;
  for (int r = 0; r < C; ++r)
    if (r != rank) {
      const int n = min(STAGE_TM, nf - r * STAGE_TM);
      in_band += (unsigned)(n * RW * sizeof(T));
      in_omega += (unsigned)(n * Lo * sizeof(T));
    }
  const unsigned in_last =
      in_band + (unsigned)((C - 1) * S * RES_PROW * sizeof(T));
  const unsigned in_cells = 3 * in_omega;
  // the run [x, x + n) of this block's shared memory into every peer's,
  // completing on the peer's mbarrier mb: peer r's copy issued by lane 0
  // of warp r (a block has 4 warps a tile, at least as many as bands)
  auto send = [&](const T* x, int n, unsigned mb) {
    const int r = tid / 32;
    if (tid % 32 == 0 && r < C && r != rank) {
      const unsigned src = smem_u32(x);
      bulk_to_peer(peer_addr(src, r), src, (unsigned)(n * sizeof(T)),
                   peer_addr(mb, r));
    }
  };

  // ---- load: zero both copies, then the operators, the base into copy
  // 0, the base and boundary values on the band, the flags, the residual
  // normalization, the lane's scalars; the mbarriers, expecting the first
  // stage into each copy and the first sampled step's vorticity and cells
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) mbar_init(mb0 + 8 * k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(mb0 + 8, in_band);  // stage 0 writes copy 1
    mbar_expect(mb0, in_band);      // stage 1 writes copy 0
    mbar_expect(mbo, in_omega);
    mbar_expect(mbc, in_cells);
  }
  for (int e = tid; e < 2 * y.fcopy; e += nt) F0[e] = T(0);
  for (int e = tid; e < nf * L; e += nt) {
    const int k = e / L, i = e % L;
    const bool in = i < nf;
    DxT[e] = in ? o.Dx[i * nf + k] : T(0);
    DY[2 * e] = in ? o.DyT[k * nf + i] : T(0);
    DY[2 * e + 1] = in ? o.DyyT[k * nf + i] : T(0);
  }
  for (int e = tid; e < ni * L; e += nt) {
    const int k = e / L, i = e % L;
    const bool in = i < nf;
    IG[2 * e] = in ? o.IyT[k * nf + i] : T(0);
    IG[2 * e + 1] = in ? o.GyT[k * nf + i] : T(0);
  }
  for (int e = tid; e < STAGE_TM * nf; e += nt) {
    const int k = e / STAGE_TM, i = row0 + e % STAGE_TM;
    DXB[2 * e] = i < nf ? o.Dx[i * nf + k] : T(0);
    DXB[2 * e + 1] = i < nf ? o.Dxx[i * nf + k] : T(0);
    if (k < ni) {
      GIB[2 * e] = i < nf ? o.Gx[i * ni + k] : T(0);
      GIB[2 * e + 1] = i < nf ? o.Ix[i * ni + k] : T(0);
    }
  }
  for (int e = tid; e < STAGE_TM * L; e += nt) {
    const int i = row0 + e / L, j = e % L;
    const bool in = i < nf && j < nf;
    BC[2 * e] = in ? o.bc_u[i * nf + j] : T(0);
    BC[2 * e + 1] = in ? o.bc_v[i * nf + j] : T(0);
  }
  for (int e = tid; e < ntiles * RES_PROW; e += nt) part[e] = T(0);
  if (tid < 3) flags[tid] = a.flags[3 * lane + tid];
  if (tid == 0) refn[0] = a.ref_norm[lane];
  if (tid < S_COUNT) scal[tid] = T(0);
  if (tid < H_COUNT) lsc[tid] = o0.lsc[(size_t)lane * H_COUNT + tid];
  __syncthreads();
  T* const ug = a.u + (size_t)lane * lane_full(nf);
  T* const vg = a.v + (size_t)lane * lane_full(nf);
  T* const pg = a.p + (size_t)lane * lane_inner(nf);
  for (int e = tid; e < nf * nf; e += nt) {
    const int i = e / nf, j = e % nf;
    F0[i * RW + 2 * j] = ug[e];
    F0[i * RW + 2 * j + 1] = vg[e];
  }
  for (int e = tid; e < ni * ni; e += nt) {
    const int r = e / ni, j = e % ni;
    F0[(r + 1) * RW + P0 + j] = pg[e];
  }
  __syncthreads();
  for (int e = tid; e < 2 * STAGE_TM * L; e += nt)
    B0[e] = row0 + e / (2 * L) < nf
                ? F0[(row0 + e / (2 * L)) * RW + e % (2 * L)]
                : T(0);
  for (int e = tid; e < STAGE_TM * Lp; e += nt) {
    const int i = row0 + e / Lp;  // grid row; p row i - 1
    bp0[e] = i > 0 && i < nf - 1 ? F0[i * RW + P0 + e % Lp] : T(0);
  }
  // the chunk's first dt and base norms: dt_kernel's slots (slot s folds
  // the flat indices s, s + RED_THREADS, ... in order) and tree
  for (int s = tid; s < RED_THREADS; s += nt) {
    T umax = 0, vmax = 0, usq = 0, vsq = 0;
    for (int k = s; k < nf * nf; k += RED_THREADS) {
      const int i = k / nf, j = k % nf;
      T aa = F0[i * RW + 2 * j], bb = F0[i * RW + 2 * j + 1];
      usq += aa * aa;
      vsq += bb * bb;
      if (o.su) {  // wave speeds belong to the TOTAL velocity
        aa += o.su[k];
        bb += o.sv[k];
      }
      umax = nan_max(umax, (T)fabs(aa));
      vmax = nan_max(vmax, (T)fabs(bb));
    }
    tree[s] = umax;
    tree[RED_THREADS + s] = vmax;
    tree[2 * RED_THREADS + s] = usq;
    tree[3 * RED_THREADS + s] = vsq;
  }
  __syncthreads();
  {
    const int w = tid / 32, l = tid % 32;
    if (w < 4) {
      const T r = w < 2
                      ? warp_tree<true>(tree + w * RED_THREADS, 1, RED_THREADS, l)
                      : warp_tree<false>(tree + w * RED_THREADS, 1, RED_THREADS,
                                         l);
      if (l == 0) res[w] = r;
    }
  }
  __syncthreads();
  if (tid == 0) {
    scal[S_DT] = dt_of(res[0], res[1], lsc);
    scal[S_U0SQ] = res[2];
    scal[S_V0SQ] = res[3];
  }
  // every block runs, is loaded and has its mbarriers before any copy
  // into another
  fence_async_shared();
  cluster_arrive();
  cluster_wait();

  const T nu = lsc[H_NU], beta_sq = lsc[H_BETA];
  Tail<T> tl = {};
  tl.scal = scal;
  tl.lsc = lsc;
  tl.metrics = nullptr;
  tl.rows = rank == 0 ? a.rows + (size_t)lane * 7 : dummy;
  tl.lanes = rank == 0 ? a.lanes : 1;
  tl.warmup = a.warmup;
  tl.use_residual = a.use_residual;
  tl.tol = a.tol;
  tl.flags = flags;
  tl.ref_norm = refn;
  tl.x1 = 0;
  // the parity of the next phase of each mbarrier
  unsigned ph0 = 0, ph1 = 0, pho = 0, phc = 0;

  for (int it = 0; it < a.chunk; ++it) {
    const int idx = a.start_iter + it;
    const bool sampled = it == 0 || idx % a.metrics_every == 0;
    for (int st = 0; st < 4; ++st) {
      const T* in = (st & 1) ? F1 : F0;
      T* const fout = (st & 1) ? F0 : F1;
      const bool last = st == 3;
      // a chunk step's last stage leaves the base of a lane that began
      // the step done as it is (runner.freeze)
      const bool keep = last && flags[0];

      // 1. the k group's chains of the tile's 2 x 2: product m at
      // (r0 + rho, c + tt) in w[4 m + 2 rho + tt]: Dx u, Dxx u, Dx v,
      // Dxx v, u DyT, u DyyT, v DyT, v DyyT (k < nf), then Gx p, Ix p
      // (k < ni, the tile's column slice of the band's). The band's own
      // rows' products first: they read no peer's band, so the peers'
      // copies of the previous stage land meanwhile.
      T w[2 * RES_RED_VALS];
#pragma unroll
      for (int e = 0; e < 2 * RES_RED_VALS; ++e) w[e] = T(0);
#pragma unroll 2
      for (int k = kg; k < nf; k += RES_KSPLIT) {
        V ur, vr, dy, dyy;
        const V a0 = ld2(in + ii * RW + 2 * k);
        const V a1 = ld2(in + (ii + 1) * RW + 2 * k);
        ur = pair(a0.x, a1.x);
        vr = pair(a0.y, a1.y);
        ld4(DY + 2 * (k * L + jj), dy, dyy);
        fma4(w + 16, ur, dy);   // u DyT
        fma4(w + 20, ur, dyy);  // u DyyT
        fma4(w + 24, vr, dy);   // v DyT
        fma4(w + 28, vr, dyy);  // v DyyT
      }
      if (st > 0) {  // every band of the input is here
        const int x = (st & 1) ? 1 : 0;
        mbar_wait(mb0 + 8 * x, x ? ph1 : ph0);
        if (x) ph1 ^= 1u;
        else ph0 ^= 1u;
        // the copy's next phase: stage st + 1 writes it (copy 0: a last
        // stage, with the partials)
        if (tid == 0) mbar_expect(mb0 + 8 * x, x ? in_band : in_last);
      }
#pragma unroll 2
      for (int k = kg; k < nf; k += RES_KSPLIT) {
        V dx, dxx, uc, vc;
        ld4(DXB + 2 * (k * STAGE_TM + r0), dx, dxx);
        ld4(in + k * RW + 2 * jj, uc, vc);
        fma4(w, dx, uc);        // Dx u
        fma4(w + 4, dxx, uc);   // Dxx u
        fma4(w + 8, dx, vc);    // Dx v
        fma4(w + 12, dxx, vc);  // Dxx v
      }
#pragma unroll 4
      for (int k = kg; k < ni; k += RES_KSPLIT) {
        V gx, ix;
        ld4(GIB + 2 * (k * STAGE_TM + r0), gx, ix);
        const V pc = ld2(in + (k + 1) * RW + P0 + jp);
        fma4(w + 32, gx, pc);
        fma4(w + 36, ix, pc);
      }
      // 2. each point's sums over the k groups, in group order (the stage
      // kernel's reduce_groups), at the point of thread (q, t0): product m
      // in tot[m]; two rounds of RES_RED_VALS values through xr
      T tot[12];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < RES_RED_VALS; ++e)
          xr[(kg * RES_RED_VALS + e) * 32 + t0] = w[RES_RED_VALS * r + e];
        sub_sync(bar);
#pragma unroll
        for (int m = 0; m < RES_RED_VALS / 4; ++m) {
          const T* x = xr + (4 * m + q) * 32 + t0;
          T s = x[0];
#pragma unroll
          for (int g = 1; g < RES_KSPLIT; ++g) s += x[g * RES_RED_VALS * 32];
          tot[RES_RED_VALS / 4 * r + m] = s;
        }
        if (r == 0) sub_sync(bar);
      }
      // the point's Gx p and Ix p (pressure column pj) into the band
      if (pj < ni) {
        T* g = GPB + 2 * (pj * STAGE_TM + (pi - row0));
        g[0] = tot[8];
        g[1] = tot[9];
      }
      __syncthreads();  // the band of Gx p and Ix p is whole

      // 3. (Gx p) IyT and (Ix p) GyT (k < ni): dp[4 m + 2 rho + tt]
      {
        T dp[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) dp[e] = T(0);
#pragma unroll 4
        for (int k = kg; k < ni; k += RES_KSPLIT) {
          V gk, ik, iy, gy;
          ld4(GPB + 2 * (k * STAGE_TM + r0), gk, ik);
          ld4(IG + 2 * (k * L + jj), iy, gy);
          fma4(dp, gk, iy);
          fma4(dp + 4, ik, gy);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e)
          xr[(kg * RES_RED_VALS + e) * 32 + t0] = dp[e];
        sub_sync(bar);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const T* x = xr + (4 * m + q) * 32 + t0;
          T s = x[0];
#pragma unroll
          for (int g = 1; g < RES_KSPLIT; ++g) s += x[g * RES_RED_VALS * 32];
          tot[10 + m] = s;
        }
      }

      // 4. the point's residuals, RK update and BC select, in the stage
      // kernel's expressions, into the band of the output copy; on the
      // last stage the base on the band and the point's partial-sum terms
      T tm[RES_STAT];
#pragma unroll
      for (int e = 0; e < RES_STAT; ++e) tm[e] = T(0);
      if (pi < nf && pj < nf) {
        const int i = pi, j = pj;
        const bool inner = i > 0 && i < nf - 1 && j > 0 && j < nf - 1;
        const int kk = i * nf + j;
        const int bi = 2 * ((i - row0) * L + j);   // the band's point
        const int bq = (i - row0) * Lp + (j - 1);  // its p
        const T u = in[i * RW + 2 * j], v = in[i * RW + 2 * j + 1];
        const T u0 = B0[bi], v0 = B0[bi + 1];
        const T p0 = inner ? bp0[bq] : T(0);
        const T bu = BC[bi], bv = BC[bi + 1];
        T su = T(0), sv = T(0);
        const T du_dx = tot[0], dv_dx = tot[2];
        const T u_dy = tot[4], v_dy = tot[6];
        const T lap_u = tot[1] + tot[5];
        const T lap_v = tot[3] + tot[7];
        T conv_u, conv_v;
        if (o.su) {
          // singular subtraction: convect with the TOTAL velocity; the
          // singular derivatives are the sampled fields
          su = o.su[kk];
          sv = o.sv[kk];
          const T U = u + su, Vt = v + sv;
          conv_u = U * (du_dx + o.sdudx[kk]) + Vt * (u_dy + o.sdudy[kk]);
          conv_v = U * (dv_dx + o.sdvdx[kk]) + Vt * (v_dy + o.sdvdy[kk]);
        } else {
          conv_u = u * du_dx + v * u_dy;
          conv_v = u * dv_dx + v * v_dy;
        }
        const T R_u = -conv_u - tot[10] + nu * lap_u;
        const T R_v = -conv_v - tot[11] + nu * lap_v;
        const T adt = T(res_alpha(st)) * scal[S_DT];
        const T u_new = inner ? u0 + adt * R_u : bu;
        const T v_new = inner ? v0 + adt * R_v : bv;
        const T us = keep ? u0 : u_new, vs = keep ? v0 : v_new;
        fout[i * RW + 2 * j] = us;
        fout[i * RW + 2 * j + 1] = vs;
        if (inner) {
          const T R_p = -beta_sq * (du_dx + v_dy);
          const T p_new = p0 + adt * R_p;
          fout[i * RW + P0 + (j - 1)] = keep ? p0 : p_new;
          if (last && !keep) bp0[bq] = p_new;
          tm[2] = R_p;
        }
        tm[0] = R_u;
        tm[1] = R_v;
        tm[3] = u_new - u0;
        tm[4] = v_new - v0;
        if (last) {
          if (!keep) {
            B0[bi] = u_new;
            B0[bi + 1] = v_new;
          }
          // the base this stage leaves: |u|^2, |v|^2, max|u + su|,
          // max|v + sv|, as dt_kernel takes them
          tm[5] = us;
          tm[6] = vs;
          tm[7] = (T)fabs(o.su ? us + su : us);
          tm[8] = (T)fabs(o.su ? vs + sv : vs);
        }
      }
      if (last) {
        // the tile's partials, as the stage kernel sums them: k group 0's
        // thread t0 adds its 2 x 2's terms in point order, then a fixed
        // warp tree, into the tile's row of `part`
        sub_sync(bar);  // every k group is done with xr
#pragma unroll
        for (int e = 0; e < RES_STAT; ++e)
          xr[(e * RES_KSPLIT + q) * 32 + t0] = tm[e];
        sub_sync(bar);
        if (kg == 0) {
          T s5[NPART] = {T(0), T(0), T(0), T(0), T(0)};
          T ds[NDPART] = {T(0), T(0), T(0), T(0)};
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            T x[RES_STAT];
#pragma unroll
            for (int e = 0; e < RES_STAT; ++e)
              x[e] = xr[(e * RES_KSPLIT + qq) * 32 + t0];
            s5[2] += x[2] * x[2];
            s5[0] += x[0] * x[0];
            s5[1] += x[1] * x[1];
            s5[3] += x[3] * x[3];
            s5[4] += x[4] * x[4];
            ds[2] += x[5] * x[5];
            ds[3] += x[6] * x[6];
            ds[0] = nan_max(ds[0], x[7]);
            ds[1] = nan_max(ds[1], x[8]);
          }
          T* prow = part + (rank * S + sb) * RES_PROW;
#pragma unroll
          for (int e = 0; e < NPART; ++e) {
            T sq = s5[e];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              sq += __shfl_down_sync(0xffffffffu, sq, off);
            T out = T(0);
            out += sq;
            if (t0 == 0) prow[e] = out;
          }
#pragma unroll
          for (int e = 0; e < NDPART; ++e) {
            T sq = ds[e];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              const T ot = __shfl_down_sync(0xffffffffu, sq, off);
              sq = e < 2 ? nan_max(sq, ot) : sq + ot;
            }
            T out = T(0);
            out = e < 2 ? nan_max(out, sq) : out + sq;
            if (t0 == 0) prow[NPART + e] = out;
          }
        }
      }
      fence_async_shared();
      __syncthreads();  // the band of the output is whole
      // the band's state rows (and on the last stage its tiles' partials)
      // into every peer's copy
      const unsigned mb = mb0 + ((st & 1) ? 0 : 8);
      send(fout + row0 * RW, rows * RW, mb);
      if (last) send(part + rank * S * RES_PROW, S * RES_PROW, mb);
    }
    // the last stage's copies (copy 0) and partials are here; the copy's
    // next phase is stage 1's
    mbar_wait(mb0, ph0);
    ph0 ^= 1u;
    if (tid == 0) mbar_expect(mb0, in_band);

    if (sampled) {
      // the quadratures of the state the step left (copy 0): the tail
      // kernel's omega = Dx v - u DyT on the band, gathered from every
      // block; energy, enstrophy and palinstrophy on the band, gathered;
      // then every block sums every 16 x 16 tile (tile_sum)
      const T* uv = F0;
      for (int e = tid; e < rows * nf; e += nt) {
        const int i = row0 + e / nf, j = e % nf;
        T dvdx = 0, dudy = 0;
        for (int k = 0; k < nf; ++k) {
          dvdx += DxT[k * L + i] * uv[k * RW + 2 * j + 1];
          dudy += uv[i * RW + 2 * k] * DY[2 * (k * L + j)];
        }
        omega[i * Lo + j] = dvdx - dudy;
      }
      fence_async_shared();
      __syncthreads();
      send(omega + row0 * Lo, rows * Lo, mbo);
      mbar_wait(mbo, pho);
      pho ^= 1u;
      if (tid == 0) mbar_expect(mbo, in_omega);
      for (int e = tid; e < rows * nf; e += nt) {
        const int i = row0 + e / nf, j = e % nf;
        const int kk = i * nf + j;
        T ut = uv[i * RW + 2 * j], vt = uv[i * RW + 2 * j + 1];
        const T wt = o.W2d[kk];
        T omt = omega[i * Lo + j];
        if (o.su) {
          ut += o.su[kk];
          vt += o.sv[kk];
          omt += o.sw[kk];
        }
        T dwx = 0, dwy = 0;
        for (int k = 0; k < nf; ++k) {
          dwx += DxT[k * L + i] * omega[k * Lo + j];
          dwy += omega[i * Lo + k] * DY[2 * (k * L + j)];
        }
        if (o.su) {
          dwx += o.sdwx[kk];
          dwy += o.sdwy[kk];
        }
        T* cell = vals + i * 3 * Lo + j;
        cell[0] = wt * (ut * ut + vt * vt);
        cell[Lo] = wt * omt * omt;
        cell[2 * Lo] = wt * (dwx * dwx + dwy * dwy);
      }
      fence_async_shared();
      __syncthreads();
      send(vals + row0 * 3 * Lo, rows * 3 * Lo, mbc);
      mbar_wait(mbc, phc);
      phc ^= 1u;
      if (tid == 0) mbar_expect(mbc, in_cells);
      for (int wq = tid / 32; wq < nq * NQPART; wq += nt / 32) {
        const int qt = wq / NQPART, g = wq % NQPART;
        const T sum = tile_sum_grid(vals + g * Lo, 3 * Lo, (qt / nt1) * TILE,
                                    (qt % nt1) * TILE, nf, tid % 32);
        if (tid % 32 == 0) qpart[wq] = sum;
      }
      __syncthreads();
    }

    // the step's finish, in every block on its own copies: the lane's
    // column sums (tail_sums' trees: at most 32 partials a column), then
    // rows (block 0 writes the lane's), state machine and the next step's
    // dt (finish_lane)
    for (int cc = tid / 32; cc < TAIL_COLS; cc += nt / 32) {
      const int l = tid % 32;
      T r = T(0);
      if (cc < NPART) {
        r = short_tree<false>(part + cc, RES_PROW, ntiles, l);
      } else if (cc < NPART + NDPART) {
        r = cc < NPART + 2
                ? short_tree<true>(part + cc, RES_PROW, ntiles, l)
                : short_tree<false>(part + cc, RES_PROW, ntiles, l);
      } else {
        if (!sampled) break;
        r = short_tree<false>(qpart + (cc - NPART - NDPART), NQPART, nq, l);
      }
      if (l == 0) sums[cc] = r;
    }
    tl.row = rank == 0 ? it : 0;
    tl.idx = idx;
    __syncthreads();
    if (tid == 0) finish_lane(tl, 0, sampled, sums);
    __syncthreads();
  }

  // ---- the chunk's state back from the block's band, and the lane's
  // flags and residual normalization from block 0; no block leaves while
  // a copy may still read it
  for (int e = tid; e < rows * nf; e += nt) {
    const int i = row0 + e / nf, j = e % nf;
    ug[i * nf + j] = F0[i * RW + 2 * j];
    vg[i * nf + j] = F0[i * RW + 2 * j + 1];
  }
  for (int e = tid; e < rows * ni; e += nt) {
    const int i = row0 + e / ni, j = e % ni;  // grid row i: p row i - 1
    if (i > 0 && i < nf - 1) pg[(i - 1) * ni + j] = F0[i * RW + P0 + j];
  }
  if (rank == 0 && tid < 3) a.flags[3 * lane + tid] = flags[tid];
  if (rank == 0 && tid == 0) a.ref_norm[lane] = refn[0];
  cluster_arrive();
  cluster_wait();
}

}  // namespace

template <typename T>
cudaError_t launch_resident(const Ops<T>& o, const ResArgs<T>& a,
                            const ResidentGeo& r, cudaStream_t s) {
  if (a.lanes < 1 || a.lanes > 65535 || a.chunk < 0 || a.metrics_every < 1)
    return cudaErrorInvalidValue;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        resident_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(r.cluster, 1, a.lanes);
  cfg.blockDim = dim3(r.sub * RES_SUB_THREADS);
  cfg.dynamicSmemBytes = r.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = r.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // ask whether the card can schedule such a cluster before the first
  // launch of each geometry, and refuse it if not
  static ResidentGeo checked = {0, 0, 0};
  if (checked.cluster != r.cluster || checked.sub != r.sub ||
      checked.smem != r.smem) {
    int n = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveClusters(&n, resident_chunk_kernel<T>, &cfg);
    if (err == cudaSuccess && n < 1) err = cudaErrorInvalidClusterSize;
    if (err != cudaSuccess) return err;
    checked = r;
  }
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, resident_chunk_kernel<T>, o, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template cudaError_t launch_resident<float>(const Ops<float>&,
                                            const ResArgs<float>&,
                                            const ResidentGeo&, cudaStream_t);
template cudaError_t launch_resident<double>(const Ops<double>&,
                                             const ResArgs<double>&,
                                             const ResidentGeo&, cudaStream_t);

}  // namespace sg
