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
// x1 (matmul_algorithm=x1, float32 only): the instance stage_kernel<float,
//   TN, true> runs the products as ONE bf16 tensor-core pass with float32
//   sums, the semantics of the aligned kernel's x1 mode (anap3_tpu/ops/
//   pallas_aligned.py make_aligned_chunk_runner with algorithm="x1",
//   _DotEngine's x1 branches in pallas_tiled.py), which works on the
//   bordered core: index N = nf - 1 of each axis is the border, whose state
//   values are per-run constants. So:
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
//   8 rows, k in steps of 16. The bands are staged whole (ks = nf), as bf16
//   with k contiguous ([row][k] and [column][k], rows padded to 4 (mod 8)
//   words: no bank conflict on a fragment load), rounded once per staged
//   element while staging (a global load, a conversion, a shared store; no
//   cp.async: the operands are float32 in device memory). Each warp takes
//   whole (product, m tile) items over all k and leaves its fragment in a
//   float32 stash, from which the threads of k group 0 read their 2 x 2
//   outputs, add the border terms, and run the same epilogue as the exact
//   kernel. Bound: as the exact kernel's, latency; the bf16 products are
//   ~45 MFLOP a stage at N=128 against 989 TFLOP/s.
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
// The x1 stage's shared memory in bytes: the float32 part of the exact
// layout up to the ring, then the stash of its ten products (8 rows by tn),
// then the largest phase's bf16 bands (phase 1: Gx, Ix rows and p columns;
// 2: Dx, Dxx, u, v rows and u, v, DyT, DyyT columns; 3: the gathered rows
// and IyT, GyT columns).
__host__ __device__ inline size_t stage_x1_smem_bytes(int nf, int tn,
                                                      int ksplit) {
  const int ni = nf - 2, kp1 = x1_kp(ni), kp2 = x1_kp(nf - 1);
  const size_t f32 =
      stage_smem_elems(nf, tn, 0, 0, ksplit) + (size_t)10 * STAGE_TM * tn;
  size_t b16 = (size_t)(4 * STAGE_TM + 4 * tn) * kp2;
  const size_t p1 = (size_t)(2 * STAGE_TM + tn) * kp1;
  const size_t p3 = (size_t)(2 * STAGE_TM + 2 * tn) * kp1;
  if (p1 > b16) b16 = p1;
  if (p3 > b16) b16 = p3;
  return 4 * f32 + 2 * b16;
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
  const bool staging = s.depth >= 1 && s.depth <= 3 && s.ks >= 1 &&
                       (s.ks >= nf || s.ks % s.ksplit == 0);
  const size_t smem =
      x1 ? stage_x1_smem_bytes(nf, s.tn, s.ksplit)
         : stage_smem_elems(nf, s.tn, s.ks, s.depth, s.ksplit) * elem;
  if (!tile || !groups || !staging || s.smem > MAX_SMEM ||
      (size_t)s.smem != smem || (x1 && (s.ks < nf || s.depth != 1)))
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

// Elements a thread stages per round: its loads of a round are all issued
// before the first conversion, so their latencies overlap.
constexpr int X1_UNROLL = 4;

// Rows [row0, row0 + TM) of the NB operands X[b] (leading dim ld, rows < m)
// over k < K as bf16 rows dst[(b * TM + r) * kp + k], zero past the
// operand up to x1_k16(K).
template <int NB>
__device__ __forceinline__ void x1_rows(bf16* dst, const float* const* X,
                                        int ld, int m, int row0, int K,
                                        int kp) {
  const int k16 = x1_k16(K), total = STAGE_TM * k16, nt = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += X1_UNROLL * nt) {
    float val[NB][X1_UNROLL];
#pragma unroll
    for (int q = 0; q < X1_UNROLL; ++q) {
      const int e = e0 + q * nt, r = e / k16, k = e - r * k16;
      const bool ok = e < total && row0 + r < m && k < K;
      const size_t off = ok ? (size_t)(row0 + r) * ld + k : 0;
#pragma unroll
      for (int b = 0; b < NB; ++b) val[b][q] = ok ? __ldg(X[b] + off) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < X1_UNROLL; ++q) {
      const int e = e0 + q * nt, r = e / k16, k = e - r * k16;
      if (e < total) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          dst[(b * STAGE_TM + r) * kp + k] = __float2bfloat16_rn(val[b][q]);
      }
    }
  }
}

// Columns [col0, col0 + TN) of the NB operands Y[b] (leading dim ld,
// columns < n) over k < K as bf16 rows dst[(b * TN + c) * kp + k]
// (transposed: k contiguous), zero past the operand up to x1_k16(K).
// Global reads run along the columns.
template <int TN, int NB>
__device__ __forceinline__ void x1_cols(bf16* dst, const float* const* Y,
                                        int ld, int n, int col0, int K,
                                        int kp) {
  const int k16 = x1_k16(K), total = k16 * TN, nt = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += X1_UNROLL * nt) {
    float val[NB][X1_UNROLL];
#pragma unroll
    for (int q = 0; q < X1_UNROLL; ++q) {
      const int e = e0 + q * nt, k = e / TN, c = e - k * TN;
      const bool ok = e < total && col0 + c < n && k < K;
      const size_t off = ok ? (size_t)k * ld + col0 + c : 0;
#pragma unroll
      for (int b = 0; b < NB; ++b) val[b][q] = ok ? __ldg(Y[b] + off) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < X1_UNROLL; ++q) {
      const int e = e0 + q * nt, k = e / TN, c = e - k * TN;
      if (e < total) {
#pragma unroll
        for (int b = 0; b < NB; ++b)
          dst[(b * TN + c) * kp + k] = __float2bfloat16_rn(val[b][q]);
      }
    }
  }
}

__device__ __forceinline__ unsigned ld_pair(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += A B^T over k < k16 for one warp: A the 16 rows a[m * kp + k] (the
// output's columns), B the 8 rows b[n * kp + k] (its rows); the fragment
// layouts of mma.m16n8k16 .row.col (g = lane / 4, tig = lane % 4): A rows
// g and g + 8, B row g, k pairs 2 tig and 2 tig + 8; D[m][n] in d as
// (g, 2 tig), (g, 2 tig + 1), (g + 8, 2 tig), (g + 8, 2 tig + 1).
__device__ __forceinline__ void x1_mma(float (&d)[4], const bf16* a,
                                       const bf16* b, int kp, int k16,
                                       int g, int tig) {
  const bf16* a0 = a + g * kp + 2 * tig;
  const bf16* a1 = a0 + 8 * kp;
  const bf16* b0 = b + g * kp + 2 * tig;
#pragma unroll 2
  for (int k0 = 0; k0 < k16; k0 += 16) {
    const unsigned fa0 = ld_pair(a0 + k0), fa1 = ld_pair(a1 + k0);
    const unsigned fa2 = ld_pair(a0 + k0 + 8), fa3 = ld_pair(a1 + k0 + 8);
    const unsigned fb0 = ld_pair(b0 + k0), fb1 = ld_pair(b0 + k0 + 8);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(fa0), "r"(fa1), "r"(fa2), "r"(fa3), "r"(fb0), "r"(fb1));
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
// reduction space: the stash, then the bf16 bands.
template <int TN>
__device__ __forceinline__ void x1_products(
    const Ops<float>& o0, const StageArgs<float>& a0, int nf, size_t lf,
    size_t lq, int row0, int col0, cg::cluster_group& cluster,
    float* gp_own, float* ip_own, float* gp_band, float* ip_band,
    float* work, int kg, int r0, int c, float (&acc)[32], float (&dp)[8]) {
  constexpr int TM = STAGE_TM, MT = TN / 16;  // m tiles of the columns
  const int tid = threadIdx.x, warp = tid / 32, nwarps = blockDim.x / 32;
  const int g = (tid % 32) / 4, tig = tid % 4;
  const int ni = nf - 2, n = nf - 1;
  const int kp1 = x1_kp(ni), k1 = x1_k16(ni);
  const int kp2 = x1_kp(n), k2 = x1_k16(n);
  float* stash = work;  // [10][TM][TN]: the 8 velocity products, dp/dx, dp/dy
  bf16* hb = reinterpret_cast<bf16*>(stash + 10 * TM * TN);
  const float* u = a0.u_in + lf;
  const float* v = a0.v_in + lf;

  // 1. this block's column slice of Gx p and Ix p over the inner grid
  {
    bf16 *gx = hb, *ix = hb + TM * kp1, *pc = hb + 2 * TM * kp1;
    const float* rows[2] = {o0.Gx, o0.Ix};
    const float* cols[1] = {a0.p_in + lq};
    x1_rows<2>(gx, rows, ni, nf, row0, ni, kp1);
    x1_cols<TN, 1>(pc, cols, ni, ni, col0, ni, kp1);
    __syncthreads();
    for (int it = warp; it < 2 * MT; it += nwarps) {
      const int q = it / MT, mt = it % MT;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      x1_mma(d, pc + mt * 16 * kp1, q ? ix : gx, kp1, k1, g, tig);
      x1_store<TN>(q ? ip_own : gp_own, d, mt, g, tig);
    }
  }
  cluster_arrive();
  __syncthreads();  // every warp is done with phase 1's bands

  // 2. the eight velocity products over k < N: product q contracts column
  // band cq = (u, u, v, v, DyT, DyyT, DyT, DyyT)[q] with row band
  // rq = (Dx, Dxx, Dx, Dxx, u, u, v, v)[q]
  {
    bf16* rb = hb;                 // Dx, Dxx, u, v rows [q][TM][kp2]
    bf16* cb = hb + 4 * TM * kp2;  // u, v, DyT, DyyT columns [q][TN][kp2]
    const float* rows[4] = {o0.Dx, o0.Dxx, u, v};
    const float* cols[4] = {u, v, o0.DyT, o0.DyyT};
    x1_rows<4>(rb, rows, nf, nf, row0, n, kp2);
    x1_cols<TN, 4>(cb, cols, nf, nf, col0, n, kp2);
    __syncthreads();
    for (int it = warp; it < 8 * MT; it += nwarps) {
      const int q = it / MT, mt = it % MT;
      const int cq = q < 4 ? q / 2 : 2 + (q & 1);
      const int rq = q < 4 ? (q & 1) : 2 + (q - 4) / 2;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      x1_mma(d, cb + (cq * TN + mt * 16) * kp2, rb + rq * TM * kp2, kp2, k2,
             g, tig);
      x1_store<TN>(stash + q * TM * TN, d, mt, g, tig);
    }
  }

  // 3. the row bands of Gx p and Ix p from the cluster (float32), rounded
  // to bf16 and contracted with the IyT and GyT columns over the inner grid
  cluster_wait();  // every slice of the band is written
  gather_bands<float, TN>(cluster, gp_own, ip_own, gp_band, ip_band, ni);
  cluster_arrive();  // this block is done with its peers' slices
  __syncthreads();   // the gathered bands are whole; phase 2 is done
  {
    bf16 *a5 = hb, *a6 = hb + TM * kp1, *iy = hb + 2 * TM * kp1;
    bf16* gy = iy + TN * kp1;
    for (int e = tid; e < TM * k1; e += blockDim.x) {
      const int r = e / k1, k = e - r * k1;
      a5[r * kp1 + k] = __float2bfloat16_rn(k < ni ? gp_band[k * TM + r]
                                                   : 0.f);
      a6[r * kp1 + k] = __float2bfloat16_rn(k < ni ? ip_band[k * TM + r]
                                                   : 0.f);
    }
    const float* cols[2] = {o0.IyT, o0.GyT};
    x1_cols<TN, 2>(iy, cols, nf, nf, col0, ni, kp1);  // gy follows iy
    __syncthreads();
    for (int it = warp; it < 2 * MT; it += nwarps) {
      const int q = it / MT, mt = it % MT;
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      x1_mma(d, (q ? gy : iy) + mt * 16 * kp1, q ? a6 : a5, kp1, k1, g, tig);
      x1_store<TN>(stash + (8 + q) * TM * TN, d, mt, g, tig);
    }
    __syncthreads();
  }
  // the pressure chain's corner (N, N): the unrounded rows of the gathered
  // bands against IyT's and GyT's border column, a warp each
  float* corner = reinterpret_cast<float*>(hb);  // phase 3's bands are done
  if (row0 + TM > n && col0 <= n && n < col0 + TN && warp < 2) {
    const float* band = warp ? ip_band : gp_band;
    const float* opT = warp ? o0.GyT : o0.IyT;
    float sum = 0.f;
    for (int k = tid % 32; k < ni; k += 32)
      sum += band[k * TM + n - row0] * __ldg(opT + (size_t)k * nf + n);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tid % 32 == 0) corner[warp] = sum;
  }
  __syncthreads();

  // this thread's outputs from the stash, then the border terms
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

template <typename T, int TN, bool X1>
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

  T acc[32];  // Dx u, Dxx u, Dx v, Dxx v, u DyT, u DyyT, v DyT, v DyyT
              // at (r0 + rho, c + t): acc[4 q + 2 rho + t]
  T dp[8];    // dp/dx, dp/dy at (r0 + rho, c + t): dp[4 q + 2 rho + t]
  if constexpr (X1) {
    static_assert(sizeof(T) == 4, "x1 runs in float32");
    x1_products<TN>(o0, a0, nf, lf, lq, row0, col0, cluster, gp_own, ip_own,
                    gp_band, ip_band, ring, kg, r0, c, acc, dp);
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

template <typename T, int TN, bool X1>
cudaError_t launch_tn(const Ops<T>& o, const StageArgs<T>& a, int nf,
                      int lanes, const StageGeo& g, cudaStream_t s) {
  // shared memory above 48 KB, and for 48-wide tiles clusters above the
  // portable 8, once
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        stage_kernel<T, TN, X1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err == cudaSuccess && TN == 48)
      err = cudaFuncSetAttribute(
          stage_kernel<T, TN, X1>,
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
        cudaOccupancyMaxActiveClusters(&n, stage_kernel<T, TN, X1>, &cfg);
    if (err == cudaSuccess && n < 1) err = cudaErrorInvalidClusterSize;
    if (err != cudaSuccess) return err;
    checked[0] = g.cluster;
    checked[1] = g.smem;
    checked[2] = g.ksplit;
  }
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, stage_kernel<T, TN, X1>, o, a, nf, g);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t launch_stage(const Ops<T>& o, const StageArgs<T>& a, int nf,
                         int lanes, const StageGeo& g, cudaStream_t s) {
  if (g.x1) {  // the bf16 tensor-core instance, float32 only
    if constexpr (sizeof(T) == 4) {
      switch (g.tn) {
        case 16: return launch_tn<T, 16, true>(o, a, nf, lanes, g, s);
        case 32: return launch_tn<T, 32, true>(o, a, nf, lanes, g, s);
        case 48: return launch_tn<T, 48, true>(o, a, nf, lanes, g, s);
        default: return cudaErrorInvalidValue;
      }
    }
    return cudaErrorInvalidValue;
  }
  switch (g.tn) {
    case 16: return launch_tn<T, 16, false>(o, a, nf, lanes, g, s);
    case 32: return launch_tn<T, 32, false>(o, a, nf, lanes, g, s);
    case 48: return launch_tn<T, 48, false>(o, a, nf, lanes, g, s);
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
