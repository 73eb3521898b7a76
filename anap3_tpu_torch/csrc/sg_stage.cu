// sg_stage: one low-storage RK stage of the PN-PN-2 artificial-compressibility
// step (anap3_tpu/models/spectral_sg.py: residuals + the stage update of
// sg_step, with the masked BC select), in ONE launch per stage.
//
// Replaces: the stage body that the Pallas kernels run four times per step,
//   anap3_tpu/ops/pallas_tiled.py _stage_machinery (make_tiled_sg_step,
//   make_tiled_chunk_runner) and anap3_tpu/ops/pallas_aligned.py run_stage
//   (make_aligned_chunk_runner, make_aligned_tau_step). The bordered core,
//   the 32-padding, the stacked operators and the bf16 hi/lo splits of those
//   kernels are TPU layout devices and are not carried over: this kernel
//   works on the unpadded (N+1)^2 velocity and (N-1)^2 pressure grids in
//   exact FMA arithmetic of the working type (no TF32).
//
// Bound on the card: one stage is twelve small dense products (8 of
//   nf^3 and 4 pressure products; ~45 MFLOP at N=128) on operands that sit
//   in the 50 MB L2, so neither HBM nor the FMA pipes bound it: the time
//   goes to latency (a launch floor of ~3 us, serial copy-then-compute
//   steps, barriers, the epilogue's loads), to the shared-memory reads
//   that feed the FMAs, and to few blocks at B = 1 (PERF.md section 5).
// Design:
//   - one kernel computes the residuals, the RK update with alpha * dt read
//     from a device scalar (no host sync), the interior/BC select, p_out
//     and, on the last stage, the per-block partial sums of R_u^2, R_v^2,
//     R_p^2, |u-u0|^2, |v-v0|^2 (reduced by the step's tail in a second
//     pass, without atomics). The last stage of a chunk step writes the
//     chunk's state in place (each point is read as the base and written
//     by the same thread; the products read only the stage input), skips
//     the stores of a lane that began the step done, and also sums the base
//     it leaves (max|u + su|, max|v + sv|, |u|^2, |v|^2: the next step's dt
//     and rel), so no state copy and no dt pass follow it. No scratch
//     round trip: the velocity products
//     Dx u, Dxx u, Dx v, Dxx v of a tile take only the Dx/Dxx row band and
//     the u/v column band of the tile, so the block computes them itself
//     beside u DyT, u DyyT, v DyT, v DyyT.
//   - the pressure chain (Gx p) IyT, (Ix p) GyT needs the whole row band of
//     Gx p and Ix p: the blocks of one row band form a thread-block cluster
//     (grid x = cluster size: <= 8, portable, up to N = 383; 9-16 blocks of
//     48 columns, non-portable, for N = 384-767, where the launcher sets
//     cudaFuncAttributeNonPortableClusterSizeAllowed and asks
//     cudaOccupancyMaxActiveClusters whether the card can schedule one
//     before the geometry's first launch); each computes its column slice
//     of Gx p and Ix p into its shared memory, the cluster syncs, and each
//     gathers the band from its peers through distributed shared memory
//     before contracting it with its IyT/GyT column band.
//   - operand bands reach shared memory by cp.async, zero-filled on ragged
//     edges: where one wave of blocks holds the whole band (ks >= nf), in
//     one burst and one wait a phase; otherwise through a ring of 2-3
//     k-slabs, so the next slab's copy overlaps the FMAs on the current
//     one and a block's shared memory stays small. The IyT/GyT copies are
//     issued before the cluster barrier, so they fly while the band is
//     gathered.
//   - each thread computes 2 x 2 outputs (STAGE_RM x STAGE_RN) of every
//     product from two vector reads (two rows of the k-major row band, two
//     columns of the column band), so a shared read feeds 4 FMAs; ksplit
//     warp groups share each contraction, group g taking k = g, g + ksplit,
//     ..., and group 0 adds their sums in group order. The tile is
//     STAGE_TM = 8 rows by tn = 16, 32 or 48 columns, chosen per order by
//     ops/sg_kernels.py:stage_geometry, which also sizes the ring and
//     checks the shared memory; at N = 96 / 128 that is 91 / 85 blocks for
//     B = 1, each of 128 threads.
//   - every sum runs in one fixed order (k ascending, then a fixed warp tree
//     for the partials), so a run reproduces bit for bit.
// Lanes: the lane is the grid's z axis, so one launch advances every lane of
//   a sweep by one stage (anap3_tpu/ops/pallas_lanes.py
//   make_lane_chunk_runner, pallas_lanes_aligned.py
//   make_aligned_lane_runner); lane b's blocks run the one-lane code on lane
//   b's buffers and scalars, and a cluster never spans two lanes.
#include <cooperative_groups.h>

#include "sg_common.cuh"

namespace sg {
namespace cg = cooperative_groups;

// Shared-memory layout of a stage block, in elements: the block's own
// slices of Gx p and Ix p (2 x TM x tn), the gathered bands (2 x nip x TM,
// k-major), the k groups' reduction space, then `depth` ring slots of the
// largest phase's slab. A slab holds its row bands k-major ([q][k][TM], so
// a thread's two rows are one vector read) and then its column bands
// ([q][k][tn]). The host check and the kernel share these.
__host__ __device__ inline int stage_nip(int nf) { return (nf - 2) | 1; }
__host__ __device__ inline int slab_elems(int na, int nb, int ks, int tn) {
  return na * ks * STAGE_TM + nb * ks * tn;
}
__host__ __device__ inline int red_elems(int tn, int ksplit) {
  const int nt0 = stage_group_threads(tn);
  const int groups = (ksplit - 1) * 32 * nt0;  // 32 sums a thread
  const int warps = ksplit * nt0 / 32 * (NPART + NDPART);
  // an even count keeps the ring's vector reads aligned
  return ((groups > warps ? groups : warps) + 1) & ~1;
}
__host__ __device__ inline size_t stage_smem_elems(int nf, int tn, int ks,
                                                   int depth, int ksplit) {
  return (size_t)2 * STAGE_TM * tn + (size_t)2 * STAGE_TM * stage_nip(nf) +
         red_elems(tn, ksplit) + (size_t)depth * slab_elems(4, 4, ks, tn);
}

cudaError_t stage_geometry(const int* geo, int nf, int elem, StageGeo* g) {
  if (!geo || nf < 3) return cudaErrorInvalidValue;
  const StageGeo s{geo[G_TN], geo[G_CLUSTER], geo[G_ROWS], geo[G_KS],
                   geo[G_DEPTH], geo[G_SMEM], geo[G_NPARTS], geo[G_KSPLIT]};
  const bool tile =
      (s.tn == 16 || s.tn == 32 || s.tn == 48) && s.cluster >= 1 &&
      s.cluster <= (s.tn == 48 ? MAX_CLUSTER_NP : MAX_CLUSTER) &&
      s.cluster * s.tn >= nf &&
      (s.cluster - 1) * s.tn < nf &&
      s.rows == (nf + STAGE_TM - 1) / STAGE_TM &&
      s.nparts == s.cluster * s.rows;
  const bool groups =
      (s.ksplit == 1 || s.ksplit == 2 || s.ksplit == 4 || s.ksplit == 8) &&
      s.ksplit * stage_group_threads(s.tn) <= stage_max_threads(elem, s.tn);
  const bool staging = s.depth >= 1 && s.depth <= 3 && s.ks >= 1 &&
                       (s.ks >= nf || s.ks % s.ksplit == 0);
  if (!tile || !groups || !staging || s.smem > MAX_SMEM ||
      (size_t)s.smem !=
          stage_smem_elems(nf, s.tn, s.ks, s.depth, s.ksplit) * elem)
    return cudaErrorInvalidValue;
  *g = s;
  return cudaSuccess;
}

namespace {

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

template <typename T>
__device__ __forceinline__ typename Vec2<T>::type ld2(const T* p) {
  return *reinterpret_cast<const typename Vec2<T>::type*>(p);
}

// acc[base + 2 * rho + t] += a[rho] * b[t]: a 2x2 outer product
template <typename T, typename V>
__device__ __forceinline__ void fma4(T* acc, const V& a, const V& b) {
  acc[0] += a.x * b.x; acc[1] += a.x * b.y;
  acc[2] += a.y * b.x; acc[3] += a.y * b.y;
}

// One element global -> shared by cp.async; `valid` false reads nothing and
// writes a zero.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? (int)sizeof(T) : 0;
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The split cluster barrier: arrive publishes this thread's writes (shared
// memory included) to the cluster; wait returns once every thread of the
// cluster has arrived, and makes their writes visible.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The operands of one contraction over k < K: NA row bands a[q][row0 + r][k]
// (leading dim lda, rows < m) and NB column bands b[q][k][col0 + c]
// (leading dim ldb, columns < n).
template <typename T, int NA, int NB>
struct Bands {
  const T* a[NA > 0 ? NA : 1];
  const T* b[NB];
  int lda, m, row0, ldb, n, col0, K;
};

// Slab [k0, k0 + ks) of every band into one slot, as one cp.async group
// issued by the whole block: row band q at slot[(q * ks + k) * TM + r],
// column band q at slot[NA * ks * TM + (q * ks + k) * tn + c]. A thread
// keeps one row r (one column c) and steps k, so an element costs a copy
// and a pointer step; rows and columns outside the operand are zero, k
// outside it is not copied (no phase reads past K).
template <typename T, int TN, int NA, int NB>
__device__ __forceinline__ void load_slab(T* slot, int ks,
                                          const Bands<T, NA, NB>& d, int k0) {
  constexpr int TM = STAGE_TM;
  const int nt = blockDim.x, tid = threadIdx.x;
  const int kn = min(ks, d.K - k0);
  if constexpr (NA > 0) {
    const int r = tid % TM, step = nt / TM;
    const bool ok = d.row0 + r < d.m;
    const size_t off = ok ? (size_t)(d.row0 + r) * d.lda + k0 : 0;
#pragma unroll 1
    for (int k = tid / TM; k < kn; k += step) {
#pragma unroll
      for (int q = 0; q < NA; ++q)
        cp_async(slot + (q * ks + k) * TM + r, d.a[q] + off + (ok ? k : 0),
                 ok);
    }
  }
  T* bs = slot + NA * ks * TM;
  const int c = tid % TN, step = nt / TN;
  const bool ok = d.col0 + c < d.n;
  const T* src[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q)
    src[q] = d.b[q] + (ok ? (size_t)k0 * d.ldb + d.col0 + c : 0);
  const size_t stride = ok ? (size_t)step * d.ldb : 0;
  int k = tid / TN;
#pragma unroll
  for (int q = 0; q < NB; ++q) src[q] += ok ? (size_t)k * d.ldb : 0;
#pragma unroll 1
  for (; k < kn; k += step) {
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      cp_async(bs + (q * ks + k) * TN + c, src[q], ok);
      src[q] += stride;
    }
  }
  cp_commit();
}

// The slabs of one contraction: start issues the first min(depth, n) slabs
// and returns the slab count n (slab s in slot s % depth); wait(s) waits for
// slab s, leaving the later ones in flight, and returns its slot; next(s)
// frees the slot and issues slab s + depth into it.
template <typename T, int TN, int NA, int NB>
__device__ __forceinline__ int ring_start(T* slots, int ks, int depth,
                                          const Bands<T, NA, NB>& d) {
  const int n = (d.K + ks - 1) / ks, se = slab_elems(NA, NB, ks, TN);
  for (int s = 0; s < n && s < depth; ++s)
    load_slab<T, TN>(slots + s * se, ks, d, s * ks);
  return n;
}

template <typename T, int TN, int NA, int NB>
__device__ __forceinline__ T* ring_wait(T* slots, int ks, int depth, int n,
                                        int s) {
  const int pending = min(n, s + depth) - s - 1;
  if (pending >= 2)
    cp_wait<2>();
  else if (pending == 1)
    cp_wait<1>();
  else
    cp_wait<0>();
  __syncthreads();
  return slots + (s % depth) * slab_elems(NA, NB, ks, TN);
}

template <typename T, int TN, int NA, int NB>
__device__ __forceinline__ void ring_next(T* slot, int ks, int depth,
                                          const Bands<T, NA, NB>& d, int n,
                                          int s) {
  __syncthreads();
  if (s + depth < n) load_slab<T, TN>(slot, ks, d, (s + depth) * ks);
}

// Group 0 ends with the sums of every group, added in group order through
// `red`; the other groups keep their own.
template <typename T, int NT0, int N>
__device__ __forceinline__ void reduce_groups(T (&v)[N], T* red, int kg,
                                              int t0, int ksplit) {
  if (ksplit == 1) return;
  if (kg > 0) {
#pragma unroll
    for (int q = 0; q < N; ++q) red[((kg - 1) * N + q) * NT0 + t0] = v[q];
  }
  __syncthreads();
  if (kg == 0) {
    for (int gg = 1; gg < ksplit; ++gg) {
#pragma unroll
      for (int q = 0; q < N; ++q) v[q] += red[((gg - 1) * N + q) * NT0 + t0];
    }
  }
  __syncthreads();
}

// The inputs of the epilogue's four outputs (i0 + a / 2, j0 + a % 2) of
// lane offsets lf, lq: zeros where `mine` is false or off the grid.
template <typename T>
__device__ __forceinline__ void load_inputs(
    const StageArgs<T>& a0, const Ops<T>& o0, int nf, size_t lf, size_t lq,
    bool mine, int i0, int j0, T (&u)[4], T (&v)[4], T (&u0)[4],
    T (&v0)[4], T (&bu)[4], T (&bv)[4], T (&p0)[4]) {
  const int ni = nf - 2;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + a / 2, j = j0 + a % 2;
    const bool ok = mine && i < nf && j < nf;
    const bool in = ok && i > 0 && i < nf - 1 && j > 0 && j < nf - 1;
    const size_t kk = lf + (ok ? (size_t)i * nf + j : 0);
    u[a] = v[a] = u0[a] = v0[a] = bu[a] = bv[a] = p0[a] = T(0);
    if (ok) {
      u[a] = a0.u_in[kk]; v[a] = a0.v_in[kk];
      u0[a] = a0.u0[kk]; v0[a] = a0.v0[kk];
      bu[a] = o0.bc_u[kk]; bv[a] = o0.bc_v[kk];
    }
    if (in) p0[a] = a0.p0[lq + (size_t)(i - 1) * ni + (j - 1)];
  }
}

template <typename T, int TN>
__global__ void __launch_bounds__(stage_max_threads(sizeof(T), TN))
    stage_kernel(Ops<T> o0, StageArgs<T> a0, int nf, StageGeo g) {
  constexpr int TM = STAGE_TM, NT0 = stage_group_threads(TN);
  static_assert(STAGE_RM == 2 && STAGE_RN == 2 && NT0 % 32 == 0,
                "2 x 2 outputs a thread, whole warps a group");
  using V = typename Vec2<T>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = blockIdx.z, ni = nf - 2, nip = stage_nip(nf);
  const size_t lf = lane * lane_full(nf), lq = lane * lane_inner(nf);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int kg = tid / NT0, t0 = tid % NT0;
  const int r0 = (t0 / (TN / 2)) * 2, c = (t0 % (TN / 2)) * 2;
  const int row0 = blockIdx.y * TM, col0 = blockIdx.x * TN;
  const int ksplit = g.ksplit, ks = g.ks, depth = g.depth;
  // a chunk step's last stage leaves the base of a lane that began the
  // step done as it is (runner.freeze; the Pallas pl.when(~done))
  const bool keep = a0.flags && a0.flags[3 * lane];

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* gp_own = reinterpret_cast<T*>(smem_raw);  // (Gx p)[I, J] [TM][TN]
  T* ip_own = gp_own + TM * TN;                // (Ix p)[I, J]
  T* gp_band = ip_own + TM * TN;               // (Gx p)[I, :] [nip][TM]
  T* ip_band = gp_band + TM * nip;             // (Ix p)[I, :]
  T* red = ip_band + TM * nip;
  T* ring = red + red_elems(TN, ksplit);

  Bands<T, 2, 1> d1;  // Gx, Ix row bands; this block's p columns
  d1.a[0] = o0.Gx; d1.a[1] = o0.Ix; d1.b[0] = a0.p_in + lq;
  d1.lda = ni; d1.m = nf; d1.row0 = row0;
  d1.ldb = ni; d1.n = ni; d1.col0 = col0; d1.K = ni;
  Bands<T, 4, 4> d2;  // Dx, Dxx, u, v row bands; u, v, DyT, DyyT columns
  d2.a[0] = o0.Dx; d2.a[1] = o0.Dxx; d2.a[2] = a0.u_in + lf;
  d2.a[3] = a0.v_in + lf;
  d2.b[0] = a0.u_in + lf; d2.b[1] = a0.v_in + lf; d2.b[2] = o0.DyT;
  d2.b[3] = o0.DyyT;
  d2.lda = nf; d2.m = nf; d2.row0 = row0;
  d2.ldb = nf; d2.n = nf; d2.col0 = col0; d2.K = nf;
  Bands<T, 0, 2> d3;  // IyT, GyT columns
  d3.a[0] = nullptr; d3.b[0] = o0.IyT; d3.b[1] = o0.GyT;
  d3.lda = 0; d3.m = 0; d3.row0 = 0;
  d3.ldb = nf; d3.n = nf; d3.col0 = col0; d3.K = ni;

  // 1. this block's column slice of Gx p and Ix p (k < ni), published to
  // the cluster; the barrier completes while phase 2 runs
  {
    T v[8];  // Gx p, Ix p at (r0 + rho, c + t): v[4 q + 2 rho + t]
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = T(0);
    const int n1 = ring_start<T, TN>(ring, ks, depth, d1);
    for (int s = 0; s < n1; ++s) {
      T* slot = ring_wait<T, TN, 2, 1>(ring, ks, depth, n1, s);
      const int kn = min(ks, ni - s * ks);
      const T* A = slot + r0;
      const T* B = slot + 2 * ks * TM + c;
#pragma unroll 4
      for (int k = kg; k < kn; k += ksplit) {
        const V gx = ld2(A + k * TM), ix = ld2(A + (ks + k) * TM);
        const V pc = ld2(B + k * TN);
        fma4(v, gx, pc);
        fma4(v + 4, ix, pc);
      }
      ring_next<T, TN>(slot, ks, depth, d1, n1, s);
    }
    reduce_groups<T, NT0>(v, red, kg, t0, ksplit);
    if (kg == 0) {
#pragma unroll
      for (int rho = 0; rho < 2; ++rho)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          gp_own[(r0 + rho) * TN + c + t] = v[2 * rho + t];
          ip_own[(r0 + rho) * TN + c + t] = v[4 + 2 * rho + t];
        }
    }
  }
  cluster_arrive();

  // 2. Dx u, Dxx u, Dx v, Dxx v, u DyT, u DyyT, v DyT, v DyyT (k < nf) at
  // (r0 + rho, c + t): acc[4 q + 2 rho + t]
  T acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = T(0);
  {
    const int n2 = ring_start<T, TN>(ring, ks, depth, d2);
    for (int s = 0; s < n2; ++s) {
      T* slot = ring_wait<T, TN, 4, 4>(ring, ks, depth, n2, s);
      const int kn = min(ks, nf - s * ks);
      const T* A = slot + r0;
      const T* B = slot + 4 * ks * TM + c;
#pragma unroll 1
      for (int k = kg; k < kn; k += ksplit) {
        const V dx = ld2(A + k * TM), dxx = ld2(A + (ks + k) * TM);
        const V ur = ld2(A + (2 * ks + k) * TM);
        const V vr = ld2(A + (3 * ks + k) * TM);
        const V uc = ld2(B + k * TN), vc = ld2(B + (ks + k) * TN);
        const V dy = ld2(B + (2 * ks + k) * TN);
        const V dyy = ld2(B + (3 * ks + k) * TN);
        fma4(acc, dx, uc);        // Dx u
        fma4(acc + 4, dxx, uc);   // Dxx u
        fma4(acc + 8, dx, vc);    // Dx v
        fma4(acc + 12, dxx, vc);  // Dxx v
        fma4(acc + 16, ur, dy);   // u DyT
        fma4(acc + 20, ur, dyy);  // u DyyT
        fma4(acc + 24, vr, dy);   // v DyT
        fma4(acc + 28, vr, dyy);  // v DyyT
      }
      ring_next<T, TN>(slot, ks, depth, d2, n2, s);
    }
    reduce_groups<T, NT0>(acc, red, kg, t0, ksplit);
  }

  // 3. (Gx p) IyT and (Ix p) GyT (k < ni): the IyT/GyT slabs are in flight
  // while the block gathers the Gx p and Ix p row bands from its cluster,
  // four elements a thread in flight at a time
  const int n3 = ring_start<T, TN>(ring, ks, depth, d3);
  cluster_wait();  // every slice of the band is written
  for (int e0 = tid; e0 < ni * TM; e0 += 4 * nt) {
    T gv[4], iv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * nt;
      if (e < ni * TM) {
        const int k = e / TM, r = e % TM, peer = k / TN;
        const int kc = r * TN + k - peer * TN;
        gv[u] = cluster.map_shared_rank(gp_own, peer)[kc];
        iv[u] = cluster.map_shared_rank(ip_own, peer)[kc];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int e = e0 + u * nt;
      if (e < ni * TM) {
        gp_band[e] = gv[u];  // e = k * TM + r
        ip_band[e] = iv[u];
      }
    }
  }
  cluster_arrive();  // this block is done with its peers' slices
  T dp[8];  // dp/dx, dp/dy at (r0 + rho, c + t): dp[4 q + 2 rho + t]
#pragma unroll
  for (int q = 0; q < 8; ++q) dp[q] = T(0);
  for (int s = 0; s < n3; ++s) {
    // the barrier in ring_wait also publishes the gathered bands
    T* slot = ring_wait<T, TN, 0, 2>(ring, ks, depth, n3, s);
    const int k0 = s * ks, kn = min(ks, ni - k0);
    const T* GA = gp_band + k0 * TM + r0;
    const T* IA = ip_band + k0 * TM + r0;
    const T* B = slot + c;
#pragma unroll 4
    for (int k = kg; k < kn; k += ksplit) {
      const V gk = ld2(GA + k * TM), ik = ld2(IA + k * TM);
      const V iy = ld2(B + k * TN), gy = ld2(B + (ks + k) * TN);
      fma4(dp, gk, iy);
      fma4(dp + 4, ik, gy);
    }
    ring_next<T, TN>(slot, ks, depth, d3, n3, s);
  }
  reduce_groups<T, NT0>(dp, red, kg, t0, ksplit);

  // 4. residuals, RK update, BC select (k group 0), partial sums at
  // (r0 + rho, c + t), index a = 2 rho + t. Lane offsets are added at each
  // access, so no lane view of the pointer tables is held in registers.
  // (Loaded before phase 3, the inputs took the registers that let
  // several blocks share an SM; see PERF.md.)
  const int i0 = row0 + r0, j0 = col0 + c;
  T u[4], v[4], u0[4], v0[4], bu[4], bv[4], p0[4];
  load_inputs(a0, o0, nf, lf, lq, kg == 0, i0, j0, u, v, u0, v0, bu, bv,
              p0);
  const T* lsc = o0.lsc + (size_t)lane * H_COUNT;
  const T nu = lsc[H_NU], beta_sq = lsc[H_BETA];
  const T adt = a0.alpha * a0.scal[(size_t)lane * S_COUNT + S_DT];
  T sums[NPART] = {T(0), T(0), T(0), T(0), T(0)};
  if (kg == 0) {
    // the optional fields (FAS forcing, sampled singular derivatives),
    // all loaded before the first store
    T tu[4], tv[4], tp[4], U[4], Vt[4], sux[4], suy[4], svx[4], svy[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + a / 2, j = j0 + a % 2;
      const bool ok = i < nf && j < nf;
      const bool in = ok && i > 0 && i < nf - 1 && j > 0 && j < nf - 1;
      const size_t kk = lf + (ok ? (size_t)i * nf + j : 0);
      const size_t kp = lq + (in ? (size_t)(i - 1) * ni + (j - 1) : 0);
      tu[a] = tv[a] = tp[a] = T(0);
      if (a0.tau_u) {
        tu[a] = a0.tau_u[kk]; tv[a] = a0.tau_v[kk]; tp[a] = a0.tau_p[kp];
      }
      U[a] = u[a]; Vt[a] = v[a];
      sux[a] = suy[a] = svx[a] = svy[a] = T(0);
      if (o0.su) {
        // singular subtraction: convect with the TOTAL velocity; the
        // singular derivatives are the sampled fields
        U[a] += o0.su[kk]; Vt[a] += o0.sv[kk];
        sux[a] = o0.sdudx[kk]; suy[a] = o0.sdudy[kk];
        svx[a] = o0.sdvdx[kk]; svy[a] = o0.sdvdy[kk];
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + a / 2, j = j0 + a % 2;
      if (i >= nf || j >= nf) continue;
      const bool in = i > 0 && i < nf - 1 && j > 0 && j < nf - 1;
      const size_t kk = lf + (size_t)i * nf + j;
      const T du_dx = acc[a], dv_dx = acc[8 + a];
      const T u_dy = acc[16 + a], v_dy = acc[24 + a];
      const T lap_u = acc[4 + a] + acc[20 + a];
      const T lap_v = acc[12 + a] + acc[28 + a];
      T conv_u, conv_v;
      if (o0.su) {
        conv_u = U[a] * (du_dx + sux[a]) + Vt[a] * (u_dy + suy[a]);
        conv_v = U[a] * (dv_dx + svx[a]) + Vt[a] * (v_dy + svy[a]);
      } else {
        conv_u = u[a] * du_dx + v[a] * u_dy;
        conv_v = u[a] * dv_dx + v[a] * v_dy;
      }
      T R_u = -conv_u - dp[a] + nu * lap_u;
      T R_v = -conv_v - dp[4 + a] + nu * lap_v;
      if (a0.tau_u) {
        R_u += tu[a];
        R_v += tv[a];
      }
      const T u_new = in ? u0[a] + adt * R_u : bu[a];
      const T v_new = in ? v0[a] + adt * R_v : bv[a];
      if (!keep) {
        a0.u_out[kk] = u_new;
        a0.v_out[kk] = v_new;
      }
      if (in) {
        T R_p = -beta_sq * (du_dx + v_dy);
        if (a0.tau_p) R_p += tp[a];
        if (!keep)
          a0.p_out[lq + (size_t)(i - 1) * ni + (j - 1)] = p0[a] + adt * R_p;
        sums[2] += R_p * R_p;
      }
      sums[0] += R_u * R_u;
      sums[1] += R_v * R_v;
      sums[3] += (u_new - u0[a]) * (u_new - u0[a]);
      sums[4] += (v_new - v0[a]) * (v_new - v0[a]);
    }
  }
  if (a0.part) {  // last stage (uniform branch): a fixed warp tree, then
                  // group 0's warps in order (the others hold zeros)
    constexpr int NC = NPART + NDPART;
    const int w = tid / 32;
#pragma unroll
    for (int q = 0; q < NPART; ++q) {
      T sq = sums[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sq += __shfl_down_sync(0xffffffffu, sq, off);
      if (tid % 32 == 0 && kg == 0) red[w * NC + q] = sq;
    }
    if (a0.dpart) {  // the base this stage leaves, read back (in place:
                     // the new state, or the kept one): max|u + su|,
                     // max|v + sv|, |u|^2, |v|^2, as dt_kernel takes them
      T ds[NDPART] = {T(0), T(0), T(0), T(0)};
      if (kg == 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + a / 2, j = j0 + a % 2;
          if (i >= nf || j >= nf) continue;
          const size_t kk = lf + (size_t)i * nf + j;
          T uu = a0.u_out[kk], vv = a0.v_out[kk];
          ds[2] += uu * uu;
          ds[3] += vv * vv;
          if (o0.su) {
            uu += o0.su[kk];
            vv += o0.sv[kk];
          }
          ds[0] = nan_max(ds[0], (T)fabs(uu));
          ds[1] = nan_max(ds[1], (T)fabs(vv));
        }
      }
#pragma unroll
      for (int q = 0; q < NDPART; ++q) {
        T sq = ds[q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const T o = __shfl_down_sync(0xffffffffu, sq, off);
          sq = q < 2 ? nan_max(sq, o) : sq + o;
        }
        if (tid % 32 == 0 && kg == 0) red[w * NC + NPART + q] = sq;
      }
    }
    __syncthreads();
    if (tid == 0) {
      const size_t blk = (size_t)lane * g.nparts +
                         (size_t)blockIdx.y * gridDim.x + blockIdx.x;
      T* out = a0.part + blk * NPART;
#pragma unroll
      for (int q = 0; q < NPART; ++q) {
        T sq = T(0);
        for (int ww = 0; ww < NT0 / 32; ++ww) sq += red[ww * NC + q];
        out[q] = sq;
      }
      if (a0.dpart) {
        T* dout = a0.dpart + blk * NDPART;
#pragma unroll
        for (int q = 0; q < NDPART; ++q) {
          T sq = T(0);
          for (int ww = 0; ww < NT0 / 32; ++ww) {
            const T x = red[ww * NC + NPART + q];
            sq = q < 2 ? nan_max(sq, x) : sq + x;
          }
          dout[q] = sq;
        }
      }
    }
  }
  cluster_wait();  // no block leaves while a peer may read its slices
}

template <typename T, int TN>
cudaError_t launch_tn(const Ops<T>& o, const StageArgs<T>& a, int nf,
                      int lanes, const StageGeo& g, cudaStream_t s) {
  // shared memory above 48 KB, and for 48-wide tiles clusters above the
  // portable 8, once
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        stage_kernel<T, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err == cudaSuccess && TN == 48)
      err = cudaFuncSetAttribute(
          stage_kernel<T, TN>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.cluster, g.rows, lanes);
  cfg.blockDim = dim3(g.ksplit * stage_group_threads(TN));
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a non-portable cluster may not fit the card's GPCs at this block size:
  // ask before the first launch of each such geometry, and refuse it
  static int checked[3] = {0, 0, 0};  // cluster, shared memory, k split
  if (g.cluster > MAX_CLUSTER &&
      (checked[0] != g.cluster || checked[1] != g.smem ||
       checked[2] != g.ksplit)) {
    int n = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveClusters(&n, stage_kernel<T, TN>, &cfg);
    if (err == cudaSuccess && n < 1) err = cudaErrorInvalidClusterSize;
    if (err != cudaSuccess) return err;
    checked[0] = g.cluster;
    checked[1] = g.smem;
    checked[2] = g.ksplit;
  }
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, stage_kernel<T, TN>, o, a, nf, g);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t launch_stage(const Ops<T>& o, const StageArgs<T>& a, int nf,
                         int lanes, const StageGeo& g, cudaStream_t s) {
  switch (g.tn) {
    case 16: return launch_tn<T, 16>(o, a, nf, lanes, g, s);
    case 32: return launch_tn<T, 32>(o, a, nf, lanes, g, s);
    case 48: return launch_tn<T, 48>(o, a, nf, lanes, g, s);
    default: return cudaErrorInvalidValue;
  }
}

template cudaError_t launch_stage<float>(const Ops<float>&,
                                         const StageArgs<float>&, int, int,
                                         const StageGeo&, cudaStream_t);
template cudaError_t launch_stage<double>(const Ops<double>&,
                                          const StageArgs<double>&, int, int,
                                          const StageGeo&, cudaStream_t);

}  // namespace sg
