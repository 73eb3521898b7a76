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
//     and rel), so no state copy and no dt pass follow it. The last stage
//     of a smoother step (out of place) sums the state it leaves the same
//     way, and the first stage of the next step reduces the maxima of
//     those partials to its dt in every block (dt_of, the dt kernel's
//     arithmetic), the loads in flight with the epilogue's own, so no dt
//     pass precedes that step either; that stage is an instance of its
//     own (DT), so every other stage runs the code it ran before. No
//     scratch round trip: the velocity products
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
// x1 (matmul_algorithm=x1, float32 only): the instance stage_kernel<float,
//   TN, true, false> replaces the aligned kernel's x1 mode (anap3_tpu/ops/
//   pallas_aligned.py make_aligned_chunk_runner with algorithm="x1",
//   _DotEngine's x1 branches in pallas_tiled.py): the products as ONE bf16
//   tensor-core pass with float32 sums, on the bordered core, whose index
//   N = nf - 1 of each axis is the border, with per-run constant state
//   values there. So:
//   - a velocity product contracts k < N in bf16 (the operator's hi half
//     and the stage state, each rounded to nearest even) and adds the
//     border term k = N unrounded; on the constant border strip (output
//     column N of Dx u, Dxx u, Dx v, Dxx v; output row N of u DyT, ...)
//     it is exact float32, as the kernel's constant strips are;
//   - the pressure chain contracts the inner grid in bf16 twice, Gx p and
//     Ix p rounded to bf16 in between (eng.cache of LP); the corner (N, N)
//     contracts the unrounded row exactly (its _corner_dot), a warp each.
//   The border strip's values are per-run constants (the kernel's CCOL and
//   CROW strips), which the wrapper computes once in float64
//   (ops/sg_kernels.py:x1_border_table, pointer slot P_X1B).
//   Each product is mma.sync.m16n8k16 (bf16 in, f32 sums) on the
//   transposed tile: m = the block's tn columns (1-3 tiles of 16), n = its
//   8 rows, k from 0 in steps of 16.
// Bound of the x1 stage: as the exact kernel's, latency (its bf16 products
//   are ~45 MFLOP at N=128 against 989 TFLOP/s; its operands, ~0.6 MB,
//   sit in L2). What a block waits on is its operand bands: ~20K bf16
//   elements a block at N=128 for phase 2 alone, the operators the same
//   for every block and every stage of the run.
// Design: no operand is converted while it is staged.
//   - The operators' hi halves are rounded once a run by the wrapper
//     (ops/sg_kernels.py:x1_operator_table, P_X1OPS), k contiguous, the
//     column-side ones (DyT, DyyT, IyT, GyT) transposed. The stage state
//     comes as a bf16 copy written by the launch that wrote the state: the
//     epilogue of each x1 stage writes it beside the float32 output (the
//     lane that began the step done keeps both), and the chunk's dt_kernel
//     rounds the chunk's starting state (P_X1S: sets base, A, B, as the
//     float32 ping-pong).
//   - Every band reaches shared memory by 16-byte cp.async (zero-filled
//     past the operand), in four copy groups: phase 1's (Gx, Ix rows, p
//     columns), phase 2's left products' (Dx, Dxx rows, u, v columns), its
//     right products' (DyT, DyyT columns, u, v rows), phase 3's (IyT, GyT
//     columns). The geometry's depth (4, 3 or 2, the most that fits) is
//     the number of group regions: with 4 (N <= 248) every copy is issued
//     at the kernel's start, so phase 2's and phase 3's bands arrive while
//     phase 1 multiplies and while the cluster gathers the Gx p / Ix p
//     band; with fewer, group g + depth reuses group g's region and is
//     issued as soon as group g's products are done.
//   - Fragments come from ldmatrix: .x4 for the A operand (.trans where
//     the band is the state's row-major [k][column] slab), .x2 for B.
//   - Phase 1 also leaves each Gx p / Ix p slice rounded to bf16 (zero past
//     the inner grid), so the gather is 16-byte DSMEM loads of bf16 rows;
//     the corner reads the float32 slices.
//   - Each warp takes whole (product, m tile) items over all k and leaves
//     its fragment in a float32 stash, from which the threads of k group 0
//     read their 2 x 2 outputs, add the border terms, and run the same
//     epilogue as the exact kernel.
// Lanes: the lane is the grid's z axis, so one launch advances every lane of
//   a sweep by one stage (anap3_tpu/ops/pallas_lanes.py
//   make_lane_chunk_runner, pallas_lanes_aligned.py
//   make_aligned_lane_runner); lane b's blocks run the one-lane code on lane
//   b's buffers and scalars, and a cluster never spans two lanes.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

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
// The x1 stage's shared memory: float32 first, its own Gx p and Ix p
// slices ([2][TM][tn]), the warps' partial sums, the stash of its ten
// products ([10][TM][tn]) and the pressure corner (4); then bf16, its
// rounded slices ([2][TM][tn]), the gathered rows ([2][TM][x1_kp(ni)]) and
// `depth` regions of copy groups, group g in region g % depth, each region
// as large as its largest group (X1_GROUPS, x1_group_elems).
constexpr int X1_GROUPS = 4;
__host__ __device__ inline int x1_red_elems(int tn, int ksplit) {
  return (ksplit * stage_group_threads(tn) / 32 * (NPART + NDPART) + 3) & ~3;
}
__host__ __device__ inline size_t x1_f32_elems(int tn, int ksplit) {
  return (size_t)12 * STAGE_TM * tn + x1_red_elems(tn, ksplit) + 4;
}
// Elements of copy group g: 0, Gx and Ix rows [TM][kp1] and the p column
// slab [k1][tn + 8]; 1, Dx and Dxx rows [TM][kp2] and the u and v column
// slabs [k2][tn + 8]; 2, DyT and DyyT columns [tn][kp2] and u and v rows
// [TM][kp2]; 3, IyT and GyT columns [tn][kp1] (k1 = x1_k16(ni), k2 =
// x1_k16(N), kp = k + 8).
__host__ __device__ inline size_t x1_group_elems(int g, int nf, int tn) {
  const size_t k1 = x1_k16(nf - 2), k2 = x1_k16(nf - 1), tm = STAGE_TM;
  const size_t kp1 = k1 + 8, kp2 = k2 + 8, tp = tn + 8;
  switch (g) {
    case 0: return 2 * tm * kp1 + k1 * tp;
    case 1: return 2 * tm * kp2 + 2 * k2 * tp;
    case 2: return 2 * tn * kp2 + 2 * tm * kp2;
    default: return 2 * tn * kp1;
  }
}
__host__ __device__ inline size_t x1_region_elems(int r, int depth, int nf,
                                                  int tn) {
  size_t most = 0;
  for (int g = r; g < X1_GROUPS; g += depth) {
    const size_t e = x1_group_elems(g, nf, tn);
    if (e > most) most = e;
  }
  return most;
}
__host__ __device__ inline size_t stage_x1_smem_bytes(int nf, int tn,
                                                      int ksplit, int depth) {
  size_t b16 = (size_t)2 * STAGE_TM * tn + (size_t)2 * STAGE_TM * x1_kp(nf - 2);
  for (int r = 0; r < depth; ++r) b16 += x1_region_elems(r, depth, nf, tn);
  return 4 * x1_f32_elems(tn, ksplit) + 2 * b16;
}

cudaError_t stage_geometry(const int* geo, int nf, int elem, int x1,
                           StageGeo* g) {
  if (!geo || nf < 3 || (x1 && elem != 4)) return cudaErrorInvalidValue;
  const StageGeo s{geo[G_TN], geo[G_CLUSTER], geo[G_ROWS], geo[G_KS],
                   geo[G_DEPTH], geo[G_SMEM], geo[G_NPARTS], geo[G_KSPLIT],
                   x1 ? 1 : 0};
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
  // x1: whole bands (ks = nf), depth the copy groups' regions
  const bool staging =
      x1 ? s.ks >= nf && s.depth >= 2 && s.depth <= X1_GROUPS
         : s.depth >= 1 && s.depth <= 3 && s.ks >= 1 &&
               (s.ks >= nf || s.ks % s.ksplit == 0);
  const size_t smem =
      x1 ? stage_x1_smem_bytes(nf, s.tn, s.ksplit, s.depth)
         : stage_smem_elems(nf, s.tn, s.ks, s.depth, s.ksplit) * elem;
  if (!tile || !groups || !staging || s.smem > MAX_SMEM ||
      (size_t)s.smem != smem)
    return cudaErrorInvalidValue;
  *g = s;
  return cudaSuccess;
}

namespace {

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

// The Gx p and Ix p row bands of this block's rows, gathered from the
// cluster's column slices (gp_own, ip_own of each peer) into gp_band and
// ip_band ([k][TM], k < ni), four elements a thread in flight at a time.
template <typename T, int TN>
__device__ __forceinline__ void gather_bands(cg::cluster_group& cluster,
                                             T* gp_own, T* ip_own,
                                             T* gp_band, T* ip_band,
                                             int ni) {
  constexpr int TM = STAGE_TM;
  const int tid = threadIdx.x, nt = blockDim.x;
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
}

// ---- the x1 products (float32 stage only)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared by cp.async (L2 only); `valid` false reads
// nothing and writes zeros.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait_upto(int pending) {
  if constexpr (N > 0) {
    if (pending >= N) {
      cp_wait<N>();
      return;
    }
    cp_wait_upto<N - 1>(pending);
  } else {
    cp_wait<0>();
  }
}

// Rows [r0, r0 + R) of a bf16 array of `nrows` rows (leading dim ld) over
// k < k16 into dst[r * kp + k]; rows past the array are zeros.
__device__ __forceinline__ void x1_copy_rows(bf16* dst, const bf16* src,
                                             int ld, int nrows, int r0,
                                             int R, int k16, int kp) {
  const int per = k16 / 8, total = R * per;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / per, c = e - r * per;
    const bool ok = r0 + r < nrows;
    cp16(dst + r * kp + 8 * c,
         ok ? src + (size_t)(r0 + r) * ld + 8 * c : src, ok);
  }
}

// The column slab [col0, col0 + TN) of the rows k < k16 of a row-major bf16
// array (leading dim ld) into dst[k * (TN + 8) + c]; columns past ld are
// zeros.
template <int TN>
__device__ __forceinline__ void x1_copy_cols(bf16* dst, const bf16* src,
                                             int ld, int col0, int k16) {
  constexpr int per = TN / 8;
  const int total = k16 * per;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int k = e / per, c = e - k * per;
    const bool ok = col0 + 8 * c < ld;
    cp16(dst + k * (TN + 8) + 8 * c,
         ok ? src + (size_t)k * ld + col0 + 8 * c : src, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += A B^T over k < k16 for one warp (l: its lane), on the fragments of
// mma.m16n8k16 .row.col: A the 16 rows m (the output's columns), either
// a[m * lda + k] or, with TA, a slab a[k * lda + m]; B the 8 rows n (its
// rows) b[n * ldb + k]. D[m][n] in d as (g, 2 tig), (g, 2 tig + 1),
// (g + 8, 2 tig), (g + 8, 2 tig + 1) (g = l / 4, tig = l % 4).
template <bool TA>
__device__ __forceinline__ void x1_mma(float (&d)[4], const bf16* a, int lda,
                                       const bf16* b, int ldb, int k16,
                                       int l) {
  // matrices of the A load: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7,
  // k 8-15), (m 8-15, k 8-15), lanes 8 j .. 8 j + 7 addressing matrix j
  const int j = l / 8, i = l % 8;
  unsigned pa, sa;
  if constexpr (TA) {
    pa = smem_addr(a + (i + (j / 2) * 8) * lda + (j % 2) * 8);
    sa = 32 * lda;  // bytes a k step
  } else {
    pa = smem_addr(a + (i + (j % 2) * 8) * lda + (j / 2) * 8);
    sa = 32;
  }
  // the B load: (n 0-7, k 0-7), (n 0-7, k 8-15), lanes 0-15
  unsigned pb = smem_addr(b + i * ldb + (j % 2) * 8);
#pragma unroll 2
  for (int k0 = 0; k0 < k16; k0 += 16, pa += sa, pb += 32) {
    unsigned fa[4], fb[2];
    if constexpr (TA)
      ldsm_x4_trans(fa, pa);
    else
      ldsm_x4(fa, pa);
    ldsm_x2(fb, pb);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "r"(fb[0]),
          "r"(fb[1]));
  }
}

// A warp's D (m tile mt) into out[i * TN + j]: output row i = n, column
// j = 16 mt + m.
template <int TN>
__device__ __forceinline__ void x1_store(float* out, const float (&d)[4],
                                         int mt, int g, int tig) {
  const int j = mt * 16 + g, i = 2 * tig;
  out[i * TN + j] = d[0];
  out[(i + 1) * TN + j] = d[1];
  out[i * TN + j + 8] = d[2];
  out[(i + 1) * TN + j + 8] = d[3];
}

// The same rounded to bf16, zero where the block's column col0 + j lies
// past the inner grid (ni): a row of the band phase 3 contracts over k.
template <int TN>
__device__ __forceinline__ void x1_store_bf16(bf16* out, const float (&d)[4],
                                              int mt, int g, int tig,
                                              int col0, int ni) {
  const int j = mt * 16 + g, i = 2 * tig;
  const bool in0 = col0 + j < ni, in8 = col0 + j + 8 < ni;
  out[i * TN + j] = __float2bfloat16_rn(in0 ? d[0] : 0.f);
  out[(i + 1) * TN + j] = __float2bfloat16_rn(in0 ? d[1] : 0.f);
  out[i * TN + j + 8] = __float2bfloat16_rn(in8 ? d[2] : 0.f);
  out[(i + 1) * TN + j + 8] = __float2bfloat16_rn(in8 ? d[3] : 0.f);
}

// The border terms of output a = 2 rho + t, at (i, j), of the x1 products
// (u, v: the stage input at lane offset; x1b: the lane's border-strip
// constants; corner: dp/dx, dp/dy at (N, N)): the unrounded k = N term in
// float32, or on the constant border strip the exact per-run value; the
// pressure chain's corner.
__device__ __forceinline__ void x1_border(const Ops<float>& o, const float* u,
                                          const float* v, const float* x1b,
                                          const float* corner, int nf, int i,
                                          int j, int a, float (&acc)[32],
                                          float (&dp)[8]) {
  const int n = nf - 1;
  if (j == n) {  // Dx u, Dxx u, Dx v, Dxx v on the constant column N
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[4 * q + a] = x1b[q * nf + i];
  } else {
    const float dx = o.Dx[(size_t)i * nf + n];
    const float dxx = o.Dxx[(size_t)i * nf + n];
    const float un = u[(size_t)n * nf + j], vn = v[(size_t)n * nf + j];
    acc[a] += dx * un; acc[4 + a] += dxx * un;
    acc[8 + a] += dx * vn; acc[12 + a] += dxx * vn;
  }
  if (i == n) {  // u DyT, u DyyT, v DyT, v DyyT on the constant row N
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[16 + 4 * q + a] = x1b[(4 + q) * nf + j];
  } else {
    const float dy = o.DyT[(size_t)n * nf + j];
    const float dyy = o.DyyT[(size_t)n * nf + j];
    const float un = u[(size_t)i * nf + n], vn = v[(size_t)i * nf + n];
    acc[16 + a] += un * dy; acc[20 + a] += un * dyy;
    acc[24 + a] += vn * dy; acc[28 + a] += vn * dyy;
  }
  if (i == n && j == n) {
    dp[a] = corner[0];
    dp[4 + a] = corner[1];
  }
}

// Phases 1-3 of the x1 stage: acc and dp of this thread's 2 x 2 outputs
// (k group 0; zeros in the others), with the same cluster barriers as the
// exact kernel's phases (arrive after the Gx p / Ix p slices, wait before
// the gather, arrive after it). `work` is the shared memory past the
// warps' partial sums: the stash, the corner, then the bf16 part
// (stage_x1_smem_bytes); `depth` the copy groups' regions.
template <int TN>
__device__ __forceinline__ void x1_products(
    const Ops<float>& o0, const StageArgs<float>& a0, int nf, size_t lf,
    int row0, int col0, int depth, cg::cluster_group& cluster,
    float* gp_own, float* ip_own, float* work, int kg, int r0, int c,
    float (&acc)[32], float (&dp)[8]) {
  constexpr int TM = STAGE_TM, MT = TN / 16, TP = TN + 8;
  const int tid = threadIdx.x, warp = tid / 32, nwarps = blockDim.x / 32;
  const int l = tid % 32, g = l / 4, tig = l % 4;
  const int ni = nf - 2, n = nf - 1;
  const int k1 = x1_k16(ni), kp1 = k1 + 8, k2 = x1_k16(n), kp2 = k2 + 8;
  const int S = x1_sld(nf), Sp = x1_pld(nf);
  float* stash = work;  // [10][TM][TN]: the 8 velocity products, dp/dx, dp/dy
  float* corner = stash + 10 * TM * TN;
  bf16* own = reinterpret_cast<bf16*>(corner + 4);  // rounded slices
  bf16* rows3 = own + 2 * TM * TN;  // the gathered Gx p, Ix p rows
  // the copy groups' regions (no array: it would live in local memory)
  bf16* const reg0 = rows3 + 2 * TM * kp1;
  bf16* const reg1 = reg0 + x1_region_elems(0, depth, nf, TN);
  bf16* const reg2 = reg1 + x1_region_elems(1, depth, nf, TN);
  bf16* const reg3 = reg2 + x1_region_elems(2, depth, nf, TN);
  // group gi's region
  auto region = [&](int gi) {
    const int r = gi % depth;
    return r == 0 ? reg0 : r == 1 ? reg1 : r == 2 ? reg2 : reg3;
  };
  const bf16* op = o0.x1ops;
  const bf16* xs = a0.x1_in + blockIdx.z * x1_state_elems(nf);
  const bf16 *ub = xs, *vb = xs + S * S, *pb = xs + 2 * S * S;

  auto issue = [&](int gi) {
    bf16* d = region(gi);
    if (gi == 0) {
      x1_copy_rows(d, op + x1_op_offset(X_GX, nf), k1, nf, row0, TM, k1, kp1);
      x1_copy_rows(d + TM * kp1, op + x1_op_offset(X_IX, nf), k1, nf, row0,
                   TM, k1, kp1);
      x1_copy_cols<TN>(d + 2 * TM * kp1, pb, Sp, col0, k1);
    } else if (gi == 1) {
      x1_copy_rows(d, op + x1_op_offset(X_DX, nf), k2, nf, row0, TM, k2, kp2);
      x1_copy_rows(d + TM * kp2, op + x1_op_offset(X_DXX, nf), k2, nf, row0,
                   TM, k2, kp2);
      x1_copy_cols<TN>(d + 2 * TM * kp2, ub, S, col0, k2);
      x1_copy_cols<TN>(d + 2 * TM * kp2 + k2 * TP, vb, S, col0, k2);
    } else if (gi == 2) {
      x1_copy_rows(d, op + x1_op_offset(X_DY, nf), k2, nf, col0, TN, k2, kp2);
      x1_copy_rows(d + TN * kp2, op + x1_op_offset(X_DYY, nf), k2, nf, col0,
                   TN, k2, kp2);
      x1_copy_rows(d + 2 * TN * kp2, ub, S, S, row0, TM, k2, kp2);
      x1_copy_rows(d + 2 * TN * kp2 + TM * kp2, vb, S, S, row0, TM, k2, kp2);
    } else {
      x1_copy_rows(d, op + x1_op_offset(X_IY, nf), k1, nf, col0, TN, k1, kp1);
      x1_copy_rows(d + TN * kp1, op + x1_op_offset(X_GY, nf), k1, nf, col0,
                   TN, k1, kp1);
    }
    cp_commit();
  };
  // group gi has landed (in every thread's view): the groups after it
  // that are in flight may stay so
  auto land = [&](int gi) {
    cp_wait_upto<X1_GROUPS - 1>(min(X1_GROUPS - 1 - gi, depth - 1));
    __syncthreads();
  };
  // group gi's products are done: its region takes group gi + depth
  auto done = [&](int gi) {
    __syncthreads();
    if (gi + depth < X1_GROUPS) issue(gi + depth);
  };
  for (int gi = 0; gi < depth; ++gi) issue(gi);

  // 1. this block's column slice of Gx p and Ix p over the inner grid
  land(0);
  {
    const bf16* d = region(0);
    for (int it = warp; it < 2 * MT; it += nwarps) {
      const int q = it / MT, mt = it % MT;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      x1_mma<true>(f, d + 2 * TM * kp1 + mt * 16, TP, d + q * TM * kp1, kp1,
                   k1, l);
      x1_store<TN>(q ? ip_own : gp_own, f, mt, g, tig);
      x1_store_bf16<TN>(own + q * TM * TN, f, mt, g, tig, col0, ni);
    }
  }
  cluster_arrive();
  done(0);

  // 2. the eight velocity products over k < N: Dx u, Dxx u, Dx v, Dxx v
  // (columns of u, v by the rows of Dx, Dxx), then u DyT, u DyyT, v DyT,
  // v DyyT (columns of DyT, DyyT by the rows of u, v)
  land(1);
  {
    const bf16* d = region(1);
    for (int it = warp; it < 4 * MT; it += nwarps) {
      const int q = it / MT, mt = it % MT;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      x1_mma<true>(f, d + 2 * TM * kp2 + (q / 2) * k2 * TP + mt * 16, TP,
                   d + (q & 1) * TM * kp2, kp2, k2, l);
      x1_store<TN>(stash + q * TM * TN, f, mt, g, tig);
    }
  }
  done(1);
  land(2);
  {
    const bf16* d = region(2);
    for (int it = warp; it < 4 * MT; it += nwarps) {
      const int q = it / MT, mt = it % MT;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      x1_mma<false>(f, d + (q & 1) * TN * kp2 + mt * 16 * kp2, kp2,
                    d + 2 * TN * kp2 + (q / 2) * TM * kp2, kp2, k2, l);
      x1_store<TN>(stash + (4 + q) * TM * TN, f, mt, g, tig);
    }
  }
  done(2);

  // 3. the bf16 rows of Gx p and Ix p from the cluster's slices (16 bytes
  // a load), contracted with the IyT and GyT columns over the inner grid
  cluster_wait();  // every slice of the band is written
  {
    const int per = k1 / 8;
    for (int e = tid; e < 2 * TM * per; e += blockDim.x) {
      const int q = e / (TM * per), r = e / per % TM, k = 8 * (e % per);
      const int peer = k / TN;
      const bf16* src = cluster.map_shared_rank(
          own + q * TM * TN + r * TN + k - peer * TN, peer);
      *reinterpret_cast<uint4*>(rows3 + (q * TM + r) * kp1 + k) =
          *reinterpret_cast<const uint4*>(src);
    }
  }
  // the pressure chain's corner (N, N): the unrounded rows of the slices
  // against IyT's and GyT's border column, a warp each
  if (row0 + TM > n && col0 <= n && n < col0 + TN && warp < 2) {
    const float* mine = warp ? ip_own : gp_own;
    const float* opT = warp ? o0.GyT : o0.IyT;
    float sum = 0.f;
    for (int k = l; k < ni; k += 32) {
      const int peer = k / TN;
      sum += cluster.map_shared_rank(mine, peer)[(n - row0) * TN + k -
                                                 peer * TN] *
             __ldg(opT + (size_t)k * nf + n);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (l == 0) corner[warp] = sum;
  }
  cluster_arrive();  // this block is done with its peers' slices
  land(3);           // also publishes the gathered rows
  {
    const bf16* d = region(3);
    for (int it = warp; it < 2 * MT; it += nwarps) {
      const int q = it / MT, mt = it % MT;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      x1_mma<false>(f, d + q * TN * kp1 + mt * 16 * kp1, kp1,
                    rows3 + q * TM * kp1, kp1, k1, l);
      x1_store<TN>(stash + (8 + q) * TM * TN, f, mt, g, tig);
    }
  }
  __syncthreads();

  // this thread's outputs from the stash, then the border terms
  const float* u = a0.u_in + lf;
  const float* v = a0.v_in + lf;
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) dp[q] = 0.f;
  if (kg == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int rho = a / 2, t = a % 2;
      const int e = (r0 + rho) * TN + c + t;
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[4 * q + a] = stash[q * TM * TN + e];
      dp[a] = stash[8 * TM * TN + e];
      dp[4 + a] = stash[9 * TM * TN + e];
      const int i = row0 + r0 + rho, j = col0 + c + t;
      if (i < nf && j < nf)
        x1_border(o0, u, v, o0.x1b + blockIdx.z * (size_t)8 * nf, corner,
                  nf, i, j, a, acc, dp);
    }
  }
}

// DT: the instance that takes dt from a0.dt_part (the first stage of a
// smoother step after the first), so that every other stage runs the code
// it ran before the smoother took dt from its partials.
template <typename T, int TN, bool X1, bool DT>
__global__ void __launch_bounds__(stage_max_threads(sizeof(T), TN))
    stage_kernel(Ops<T> o0, StageArgs<T> a0, int nf, StageGeo g) {
  static_assert(!(X1 && DT), "the smoother runs no x1");
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
  // x1: no gathered float32 bands; the warps' partial sums follow the
  // slices (stage_x1_smem_bytes)
  T* red = X1 ? gp_band : ip_band + TM * nip;
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

  T acc[32];  // Dx u, Dxx u, Dx v, Dxx v, u DyT, u DyyT, v DyT, v DyyT
              // at (r0 + rho, c + t): acc[4 q + 2 rho + t]
  T dp[8];    // dp/dx, dp/dy at (r0 + rho, c + t): dp[4 q + 2 rho + t]
  if constexpr (X1) {
    static_assert(sizeof(T) == 4, "x1 runs in float32");
    x1_products<TN>(o0, a0, nf, lf, row0, col0, depth, cluster, gp_own,
                    ip_own, red + x1_red_elems(TN, ksplit), kg, r0, c, acc,
                    dp);
  } else {
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
  gather_bands<T, TN>(cluster, gp_own, ip_own, gp_band, ip_band, ni);
  cluster_arrive();  // this block is done with its peers' slices
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
  }

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
  // dt: the device scalar; in the DT instance, from the partials of the
  // base, which every warp of k group 0 reduces, their loads in flight
  // with the inputs' (reduced before the products and held through them,
  // dt cost the f64 instances a stack frame)
  T dt = T(0);
  if constexpr (DT) {
    if (kg == 0) {
      dt = warp_dt(a0.dt_part + (size_t)lane * g.nparts * NDPART, g.nparts,
                   lsc);
      if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0)
        a0.scal[(size_t)lane * S_COUNT + S_DT] = dt;  // for stages 2-4
    }
  } else {
    dt = a0.scal[(size_t)lane * S_COUNT + S_DT];
  }
  const T adt = a0.alpha * dt;
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
      if constexpr (X1) {  // the bf16 copy the next stage's products read
        if (!keep && i < nf - 1 && j < nf - 1) {
          __nv_bfloat16* xo = a0.x1_out + lane * x1_state_elems(nf);
          const int S = x1_sld(nf);
          xo[i * S + j] = __float2bfloat16_rn(u_new);
          xo[S * S + i * S + j] = __float2bfloat16_rn(v_new);
        }
      }
      if (in) {
        T R_p = -beta_sq * (du_dx + v_dy);
        if (a0.tau_p) R_p += tp[a];
        if (!keep) {
          const T p_new = p0[a] + adt * R_p;
          a0.p_out[lq + (size_t)(i - 1) * ni + (j - 1)] = p_new;
          if constexpr (X1) {
            const int S = x1_sld(nf), Sp = x1_pld(nf);
            a0.x1_out[lane * x1_state_elems(nf) + 2 * S * S +
                      (i - 1) * Sp + (j - 1)] = __float2bfloat16_rn(p_new);
          }
        }
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

template <typename T, int TN, bool X1, bool DT>
cudaError_t launch_tn(const Ops<T>& o, const StageArgs<T>& a, int nf,
                      int lanes, const StageGeo& g, cudaStream_t s) {
  // shared memory above 48 KB, and for 48-wide tiles clusters above the
  // portable 8, once
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        stage_kernel<T, TN, X1, DT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err == cudaSuccess && TN == 48)
      err = cudaFuncSetAttribute(
          stage_kernel<T, TN, X1, DT>,
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
        cudaOccupancyMaxActiveClusters(&n, stage_kernel<T, TN, X1, DT>, &cfg);
    if (err == cudaSuccess && n < 1) err = cudaErrorInvalidClusterSize;
    if (err != cudaSuccess) return err;
    checked[0] = g.cluster;
    checked[1] = g.smem;
    checked[2] = g.ksplit;
  }
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, stage_kernel<T, TN, X1, DT>, o, a, nf, g);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t launch_stage(const Ops<T>& o, const StageArgs<T>& a, int nf,
                         int lanes, const StageGeo& g, cudaStream_t s) {
  if (g.x1) {  // the bf16 tensor-core instance, float32 only
    if constexpr (sizeof(T) == 4) {
      if (a.dt_part) return cudaErrorInvalidValue;
      switch (g.tn) {
        case 16: return launch_tn<T, 16, true, false>(o, a, nf, lanes, g, s);
        case 32: return launch_tn<T, 32, true, false>(o, a, nf, lanes, g, s);
        case 48: return launch_tn<T, 48, true, false>(o, a, nf, lanes, g, s);
        default: return cudaErrorInvalidValue;
      }
    }
    return cudaErrorInvalidValue;
  }
  if (a.dt_part) {  // dt from the base's partials
    switch (g.tn) {
      case 16: return launch_tn<T, 16, false, true>(o, a, nf, lanes, g, s);
      case 32: return launch_tn<T, 32, false, true>(o, a, nf, lanes, g, s);
      case 48: return launch_tn<T, 48, false, true>(o, a, nf, lanes, g, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (g.tn) {
    case 16: return launch_tn<T, 16, false, false>(o, a, nf, lanes, g, s);
    case 32: return launch_tn<T, 32, false, false>(o, a, nf, lanes, g, s);
    case 48: return launch_tn<T, 48, false, false>(o, a, nf, lanes, g, s);
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
