// sg_diag: the reductions of the SG step over whole fields: the adaptive
// dt, and the sampled tail (the quadratures and the step's finish).
//
// Replaces: the adaptive-dt pass and the conserved-quantity metrics pass of
//   anap3_tpu/ops/pallas_tiled.py (_adaptive_dt, _stage_machinery's
//   metrics_pass; make_tiled_sg_step and make_tiled_chunk_runner) and of
//   anap3_tpu/ops/pallas_aligned.py make_aligned_chunk_runner
//   (adaptive_dt, metrics_pass). Semantics: anap3_tpu/models/spectral_sg.py
//   adaptive_dt and conserved_quantities.
//
// Bound on the card: latency. dt_kernel reads two (nf, nf) fields (133 KB
//   at N=128, L2-resident): its time is the launch and the chain of
//   dependent load rounds of a slot (17 at N=128, 101 at N=320, of 1024
//   slots). The quadratures need two dense
//   products in a row (omega depends on a whole product, and grad(omega) on
//   the whole of omega: 8 nf^3 operations, 17 MFLOP at N=128), then a
//   reduction of their per-tile partials: three dependent steps, each a
//   few microseconds of work, against a launch floor of ~3 us and a grid
//   barrier of ~1.2-1.7 us (scripts/launch_floor.cu, H100).
// Design:
//   - dt_kernel reduces max|u_tot|, max|v_tot| and the base norms |u0|^2,
//     |v0|^2 of a lane in the fixed-order tree of RED_THREADS slots (slot t
//     folds k = t, t + RED_THREADS, ...; then the tree of sg_common.cuh:
//     warp_tree over the slots) and writes dt into a device scalar that
//     every stage reads, so no host sync enters the step. A lane is a thread-block
//     cluster of DT_CLUSTER blocks of DT_THREADS threads, so the slots of
//     one lane are spread over 8 SMs, each thread with DT_ILP loads of each
//     field in flight (the one-block kernel it replaces had one); each
//     block pushes its slots into the leader block's shared memory over
//     DSMEM, and the leader runs the tree (warp_tree, one warp a value), so
//     dt and the norms keep the one-block kernel's bits. A card or grid
//     that cannot take the cluster is refused with an error. A chunk runs
//     it at its first step only: the last stage of every step sums the base
//     it leaves, and the step's finish sets the next dt from those sums
//     (sg_control.cu, finish in sg_common.cuh); the smoother at its first
//     step only (its stages carry the next dt, sg_host.cu); the step every
//     step.
//   - tail_kernel is the sampled tail in one persistent cooperative launch
//     (cudaLaunchAttributeCooperative) of min(tiles^2 x lanes, co-resident)
//     blocks of 16 x 16 threads: omega = Dx v - u DyT tile by tile with the
//     energy and enstrophy partials; a grid barrier; grad(omega) with the
//     palinstrophy partials; a grid barrier; then block b finishes lane b
//     (a chunk step's row, state machine and next dt, or a step's six
//     metrics), having reduced the stage's partial columns before the
//     tiles. Block b takes the (tile, lane) items b, b + grid, ... in
//     both tile phases. Each tile's partial is the 256-slot tree sum of its
//     cells and each lane sum the 1024-slot tree over the tiles, as the
//     three launches it replaces summed them, so E, Z and P keep their bits.
//   - No fallback: a card without cooperative launch, a grid above the
//     co-resident count, below the lane count, or one that leaves a block
//     more than MAX_TAIL_ITEMS items is refused with an error.
// x1 (float32 chunks under matmul_algorithm=x1): tail_kernel<float, true>
//   takes the quadratures' products as the aligned kernel's x1 metrics pass
//   does (anap3_tpu/ops/pallas_aligned.py metrics_pass, _DotEngine x1):
//   over k < N each operand rounded to bf16, the product exact in float32,
//   so the float32 sum is that of one bf16 tensor-core pass; the border
//   term k = N unrounded. The operands are the exact kernel's float32
//   tiles, each element below N rounded once by the thread that stages it.
//   omega on the constant border strip (output column N of Dx v, row N of
//   u DyT) is the per-run value of the stage's table (P_X1B,
//   ops/sg_kernels.py:x1_border_table); grad(omega) is unrounded at the
//   corner (N, N) only (omega's border is not constant): two warp sums in
//   the corner's tile.
//   The x1 chunk's dt_kernel<float, true> also rounds the chunk's starting
//   state into its bf16 copy (sg_common.cuh:x1_round_lane, spread over the
//   cluster's threads, between the two cluster barriers), which the x1
//   stage kernel's products read; x1_round_kernel does the same for the
//   bench entry's stage input. The bench needs a launch of its own: its
//   stage reads set A, which the caller fills with any state (no solve
//   launch writes A's copy there), and dt_kernel, the other launch that
//   rounds, rounds the base and writes the chunk's dt from it, which the
//   bench's stage must take as the caller's dt launch left it.
// Lanes: dt_kernel runs one cluster per lane; tail_kernel's items carry their
//   lane, whose operators, scalars and partials they use (see
//   sg_common.cuh), and the finish of lane b reads only lane b's partials.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "sg_common.cuh"

namespace sg {
namespace {

namespace cg = cooperative_groups;

// Grid (DT_CLUSTER, lanes), clusters of DT_CLUSTER blocks along x: block
// rank r of lane b's cluster holds the slots r DT_THREADS + threadIdx.x.
template <typename T, bool X1>
__global__ void __launch_bounds__(DT_THREADS)
    dt_kernel(Ops<T> o0, const T* u, const T* v, T* scal, int nf,
              const T* p, __nv_bfloat16* x1s) {
  cg::cluster_group cluster = cg::this_cluster();
  // this block runs: its peers may push into the leader once all arrived
  cluster_arrive_relaxed();
  const int lane = blockIdx.y;
  const Ops<T> o = at_lane(o0, lane, nf);
  u += lane * lane_full(nf);
  v += lane * lane_full(nf);
  scal += (size_t)lane * S_COUNT;
  // the leader's table of the lane's slots: umax, vmax, usq, vsq
  __shared__ T slots[4][RED_THREADS];
  __shared__ T res[4];
  const int tid = threadIdx.x, rank = (int)cluster.block_rank();
  const int t = rank * DT_THREADS + tid;
  const int n = nf * nf;
  T umax = 0, vmax = 0, usq = 0, vsq = 0;
  for (int k0 = t; k0 < n; k0 += DT_ILP * RED_THREADS) {
    // DT_ILP elements of the slot loaded at once, then folded in k order
    T uu[DT_ILP], vv[DT_ILP], su[DT_ILP], sv[DT_ILP];
#pragma unroll
    for (int j = 0; j < DT_ILP; ++j) {
      const int k = k0 + j * RED_THREADS;
      const bool in = k < n;
      uu[j] = in ? u[k] : T(0);
      vv[j] = in ? v[k] : T(0);
      su[j] = in && o.su ? o.su[k] : T(0);
      sv[j] = in && o.su ? o.sv[k] : T(0);
    }
#pragma unroll
    for (int j = 0; j < DT_ILP; ++j) {
      if (k0 + j * RED_THREADS < n) {
        T a = uu[j], b = vv[j];
        usq += a * a;
        vsq += b * b;
        if (o.su) {  // wave speeds belong to the TOTAL velocity
          a += su[j];
          b += sv[j];
        }
        umax = nan_max(umax, (T)fabs(a));
        vmax = nan_max(vmax, (T)fabs(b));
      }
    }
  }
  cluster_wait();  // every block of the cluster runs
  T* lead = cluster.map_shared_rank(&slots[0][0], 0);
  lead[t] = umax;
  lead[RED_THREADS + t] = vmax;
  lead[2 * RED_THREADS + t] = usq;
  lead[3 * RED_THREADS + t] = vsq;
  cluster_arrive();  // publishes the pushes
  if constexpr (X1)  // the x1 chunk's base, rounded once at its start
    x1_round_lane(u, v, p + lane * lane_inner(nf),
                  x1s + lane * x1_state_elems(nf), nf, t, RED_THREADS);
  cluster_wait();  // every slot is in the leader's table
  if (rank != 0) return;
  const int w = tid / 32, l = tid % 32;
  if (w < 4) {
    const T r = w < 2 ? warp_tree<true>(slots[w], 1, RED_THREADS, l)
                      : warp_tree<false>(slots[w], 1, RED_THREADS, l);
    if (l == 0) res[w] = r;
  }
  __syncthreads();
  if (tid == 0) {
    scal[S_DT] = dt_of(res[0], res[1], o.lsc + (size_t)lane * H_COUNT);
    scal[S_U0SQ] = res[2];
    scal[S_V0SQ] = res[3];
  }
}

// The bench entry's x1 stage input: grid (blocks, lanes).
__global__ void x1_round_kernel(const float* u, const float* v,
                                const float* p, __nv_bfloat16* x1s, int nf) {
  const int lane = blockIdx.y;
  x1_round_lane(u + lane * lane_full(nf), v + lane * lane_full(nf),
                p + lane * lane_inner(nf), x1s + lane * x1_state_elems(nf),
                nf, blockIdx.x * blockDim.x + threadIdx.x,
                gridDim.x * blockDim.x);
}

// k tiles of the operands a tile stages at once: one barrier and one
// round of load latency for KT k tiles, not one each.
constexpr int KT = 4;

// The shared memory of a tile: KT k tiles of the operands of two products
// and the cells' values of two partial sums.
template <typename T>
struct TileSmem {
  T A1[KT][TILE][TILE], B1[KT][TILE][TILE];
  T A2[KT][TILE][TILE], B2[KT][TILE][TILE];
  T vals[2][TILE * TILE];
};

// x rounded to bf16 and back (x1 products).
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x1: the elements this thread staged by load_tiles at k tile k0, rounded
// to bf16 where k < n (the product's core; the border term k = n stays
// unrounded). Each thread rounds what it loaded, so no barrier is added,
// and the sums then run as the exact kernel's: a product of two bf16
// values is exact in float32.
__device__ __forceinline__ void x1_round_own(float (&As)[TILE][TILE],
                                             float (&Bs)[TILE][TILE], int k0,
                                             int n) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (k0 + tx < n) As[ty][tx] = bf16_round(As[ty][tx]);
  if (k0 + ty < n) Bs[ty][tx] = bf16_round(Bs[ty][tx]);
}

// omega = Dx v - u DyT (smooth part) of tile (ti, tj) of one lane into
// scratch, plus the energy and enstrophy partials over the TOTAL fields.
// x1b: the lane's border-strip constants (x1 only; sg_common.cuh:P_X1B).
template <typename T, bool X1>
__device__ void omega_tile(const Ops<T>& o, const T* u, const T* v,
                           T* omega, T* qpart, int nf, int ti, int tj,
                           const T* x1b, TileSmem<T>& S) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = ti * TILE + ty;
  const int j = tj * TILE + tx;
  // the cell's fields, loaded while the products run
  const bool in = i < nf && j < nf;
  const size_t k = in ? (size_t)i * nf + j : 0;
  T ut = 0, vt = 0, w = 0, sw = 0;
  if (in) {
    ut = u[k];
    vt = v[k];
    w = o.W2d[k];
    if (o.su) {
      ut += o.su[k];
      vt += o.sv[k];
      sw = o.sw[k];
    }
  }
  T dvdx = 0, dudy = 0;
  // k ascending, one k tile after another: the sums of a tile at a time
  for (int k0 = 0; k0 < nf; k0 += KT * TILE) {
#pragma unroll
    for (int q = 0; q < KT; ++q) {
      const int kq = k0 + q * TILE;
      if (kq >= nf) break;
      load_tiles(o.Dx, nf, nf, v, nf, nf, nf, kq, i, j, S.A1[q], S.B1[q]);
      load_tiles(u, nf, nf, o.DyT, nf, nf, nf, kq, i, j, S.A2[q], S.B2[q]);
      if constexpr (X1) {
        x1_round_own(S.A1[q], S.B1[q], kq, nf - 1);
        x1_round_own(S.A2[q], S.B2[q], kq, nf - 1);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KT; ++q) {
      if (k0 + q * TILE >= nf) break;
#pragma unroll
      for (int kk = 0; kk < TILE; ++kk) {
        dvdx += S.A1[q][ty][kk] * S.B1[q][kk][tx];
        dudy += S.A2[q][ty][kk] * S.B2[q][kk][tx];
      }
    }
    __syncthreads();
  }
  if constexpr (X1) {  // the constant border strip: Dx v at column N and
                       // u DyT at row N, per-run values
    if (in && j == nf - 1) dvdx = x1b[2 * nf + i];
    if (in && i == nf - 1) dudy = x1b[4 * nf + j];
  }
  T e = 0, z = 0;
  if (in) {
    const T om = dvdx - dudy;
    omega[k] = om;
    T omt = om;
    if (o.su) omt += sw;
    e = w * (ut * ut + vt * vt);
    z = w * omt * omt;
  }
  // e and z summed at once, a warp each
  const int tid = ty * TILE + tx, l = tid % 32, wp = tid / 32;
  S.vals[0][tid] = e;
  S.vals[1][tid] = z;
  __syncthreads();
  if (wp < 2) {
    const T sum = tile_sum(S.vals[wp], l);
    if (l == 0) qpart[(size_t)(ti * tiles(nf) + tj) * NQPART + wp] = sum;
  }
}

// grad(omega) = (Dx omega, omega DyT) of the smooth vorticity plus the
// sampled singular gradients on tile (ti, tj); palinstrophy partials.
template <typename T, bool X1>
__device__ void grad_tile(const Ops<T>& o, const T* omega, T* qpart, int nf,
                          int ti, int tj, TileSmem<T>& S) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i = ti * TILE + ty;
  const int j = tj * TILE + tx;
  const bool in = i < nf && j < nf;
  const size_t k = in ? (size_t)i * nf + j : 0;
  T w = 0, sx = 0, sy = 0;
  if (in) {
    w = o.W2d[k];
    if (o.su) {
      sx = o.sdwx[k];
      sy = o.sdwy[k];
    }
  }
  T dwx = 0, dwy = 0;
  for (int k0 = 0; k0 < nf; k0 += KT * TILE) {
#pragma unroll
    for (int q = 0; q < KT; ++q) {
      const int kq = k0 + q * TILE;
      if (kq >= nf) break;
      load_tiles(o.Dx, nf, nf, omega, nf, nf, nf, kq, i, j, S.A1[q], S.B1[q]);
      load_tiles(omega, nf, nf, o.DyT, nf, nf, nf, kq, i, j, S.A2[q], S.B2[q]);
      if constexpr (X1) {
        x1_round_own(S.A1[q], S.B1[q], kq, nf - 1);
        x1_round_own(S.A2[q], S.B2[q], kq, nf - 1);
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < KT; ++q) {
      if (k0 + q * TILE >= nf) break;
#pragma unroll
      for (int kk = 0; kk < TILE; ++kk) {
        dwx += S.A1[q][ty][kk] * S.B1[q][kk][tx];
        dwy += S.A2[q][ty][kk] * S.B2[q][kk][tx];
      }
    }
    __syncthreads();
  }
  if constexpr (X1) {
    // the corner (N, N) unrounded: Dx[N] . omega[:, N] and omega[N] .
    // DyT[:, N], a warp each, in the tile that holds it (block-uniform)
    const int n = nf - 1, lo = n / TILE * TILE;
    if (ti * TILE == lo && tj * TILE == lo) {
      const int tid = ty * TILE + tx, l = tid % 32;
      if (tid < 64) {
        T sum = 0;
        for (int k = l; k < nf; k += 32)
          sum += tid < 32 ? o.Dx[(size_t)n * nf + k] * omega[(size_t)k * nf + n]
                          : omega[(size_t)n * nf + k] * o.DyT[(size_t)k * nf + n];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (l == 0) S.vals[1][tid / 32] = sum;
      }
      __syncthreads();
      if (i == n && j == n) {
        dwx = S.vals[1][0];
        dwy = S.vals[1][1];
      }
    }
  }
  T pal = 0;
  if (in) {
    if (o.su) {
      dwx += sx;
      dwy += sy;
    }
    pal = w * (dwx * dwx + dwy * dwy);
  }
  const int tid = ty * TILE + tx, l = tid % 32;
  S.vals[0][tid] = pal;
  __syncthreads();
  if (tid < 32) {
    const T sum = tile_sum(S.vals[0], l);
    if (l == 0) qpart[(size_t)(ti * tiles(nf) + tj) * NQPART + 2] = sum;
  }
}

// Two blocks an SM at least: the grid is the co-resident count, and a
// block of 256 threads may otherwise take every register of an SM.
template <typename T, bool X1>
__global__ void __launch_bounds__(TILE * TILE, 2)
    tail_kernel(Ops<T> o0, const T* u, const T* v, T* omega, Tail<T> t,
                int nf) {
  static_assert(!X1 || sizeof(T) == 4, "x1 runs in float32");
  __shared__ TileSmem<T> S;
  __shared__ T sums[TAIL_COLS];
  cg::grid_group grid = cg::this_grid();
  // block b finishes lane b (the grid has a block a lane at least): the
  // stage's columns are ready at launch, so they reduce before the tiles
  const bool finisher = blockIdx.x < t.lanes;
  if (finisher) tail_sums(t, blockIdx.x, nf, true, 0, NPART + NDPART, sums);
  const int nt = tiles(nf), nb = nt * nt, items = nb * t.lanes;
  // the items of this block, in the same order in both tile phases
  auto each = [&](auto tile) {
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int lane = it / nb, b = it % nb;
      tile(at_lane(o0, lane, nf), lane, b / nt, b % nt);
    }
  };
  each([&](const Ops<T>& o, int lane, int ti, int tj) {
    const size_t f = lane * lane_full(nf);
    omega_tile<T, X1>(o, u + f, v + f, omega + f,
                      t.qpart + lane * lane_blocks(nf) * NQPART, nf, ti, tj,
                      X1 ? o.x1b + (size_t)lane * 8 * nf : nullptr, S);
  });
  grid.sync();
  each([&](const Ops<T>& o, int lane, int ti, int tj) {
    grad_tile<T, X1>(o, omega + lane * lane_full(nf),
                     t.qpart + lane * lane_blocks(nf) * NQPART, nf, ti, tj,
                     S);
  });
  grid.sync();
  if (finisher) {
    tail_sums(t, blockIdx.x, nf, true, NPART + NDPART, TAIL_COLS, sums);
    __syncthreads();
    if (threadIdx.x == 0 && threadIdx.y == 0)
      finish_lane(t, blockIdx.x, true, sums);
  }
}

// One dt launch of `lanes` clusters; the first launch of each instance
// asks whether the card can schedule such a cluster, and refuses it if not.
template <typename T, bool X1>
cudaError_t launch_dt_clusters(const Ops<T>& o, const T* u, const T* v,
                               T* scal, int nf, int lanes, cudaStream_t s,
                               const T* p, __nv_bfloat16* x1s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DT_CLUSTER, lanes);
  cfg.blockDim = dim3(DT_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DT_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static bool checked = false;
  if (!checked) {
    int n = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveClusters(&n, dt_kernel<T, X1>, &cfg);
    if (err == cudaSuccess && n < 1) err = cudaErrorInvalidClusterSize;
    if (err != cudaSuccess) return err;
    checked = true;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, dt_kernel<T, X1>, o, u, v,
                                             scal, nf, p, x1s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

template <typename T>
cudaError_t launch_dt(const Ops<T>& o, const T* u, const T* v, T* scal,
                      int nf, int lanes, cudaStream_t s, const T* p,
                      __nv_bfloat16* x1s) {
  if (lanes < 1 || lanes > 65535) return cudaErrorInvalidValue;
  if (x1s) {  // the x1 chunk's start (float32 only)
    if constexpr (sizeof(T) == 4) {
      if (!p) return cudaErrorInvalidValue;
      return launch_dt_clusters<T, true>(o, u, v, scal, nf, lanes, s, p,
                                         x1s);
    }
    return cudaErrorInvalidValue;
  }
  return launch_dt_clusters<T, false>(o, u, v, scal, nf, lanes, s, nullptr,
                                      nullptr);
}

cudaError_t launch_x1_round(const float* u, const float* v, const float* p,
                            __nv_bfloat16* x1s, int nf, int lanes,
                            cudaStream_t s) {
  if (!u || !v || !p || !x1s) return cudaErrorInvalidValue;
  const int threads = 256, n = (nf - 1) * (nf - 1);
  x1_round_kernel<<<dim3((n + threads - 1) / threads, lanes), threads, 0,
                    s>>>(u, v, p, x1s, nf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t tail_coresident(int* blocks, int x1) {
  if (x1 && sizeof(T) != 4) return cudaErrorInvalidValue;
  static int cached[2] = {0, 0};
  int& most = cached[x1 ? 1 : 0];
  if (most) {
    *blocks = most;
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, x1 ? tail_kernel<T, sizeof(T) == 4> : tail_kernel<T, false>,
        TILE * TILE, 0);
  if (err == cudaSuccess && per_sm < 1)
    err = cudaErrorCooperativeLaunchTooLarge;
  if (err != cudaSuccess) return err;
  most = per_sm * sms;
  *blocks = most;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_tail(const Ops<T>& o, const T* u, const T* v, T* omega,
                        const Tail<T>& t, int nf, int lanes, int blocks,
                        cudaStream_t s) {
  int most = 0;
  cudaError_t err = tail_coresident<T>(&most, t.x1);
  if (err != cudaSuccess) return err;
  const long items = (long)lane_blocks(nf) * lanes;
  if (t.lanes != lanes || (!t.metrics && !(t.rows && t.dpart)) ||
      t.nparts > TREE_PASSES * RED_THREADS ||
      lane_blocks(nf) > (size_t)TREE_PASSES * RED_THREADS)
    return cudaErrorInvalidValue;
  if (blocks < lanes || blocks > most || blocks > items ||
      (items + blocks - 1) / blocks > MAX_TAIL_ITEMS)
    return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(TILE, TILE);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = t.x1 ? cudaLaunchKernelEx(&cfg, tail_kernel<T, sizeof(T) == 4>, o,
                                  u, v, omega, t, nf)
             : cudaLaunchKernelEx(&cfg, tail_kernel<T, false>, o, u, v,
                                  omega, t, nf);
  return err != cudaSuccess ? err : cudaGetLastError();
}

#define SG_INSTANTIATE(T)                                                   \
  template cudaError_t launch_dt<T>(const Ops<T>&, const T*, const T*, T*,  \
                                    int, int, cudaStream_t, const T*,       \
                                    __nv_bfloat16*);                        \
  template cudaError_t tail_coresident<T>(int*, int);                       \
  template cudaError_t launch_tail<T>(const Ops<T>&, const T*, const T*,    \
                                      T*, const Tail<T>&, int, int, int,    \
                                      cudaStream_t);
SG_INSTANTIATE(float)
SG_INSTANTIATE(double)
#undef SG_INSTANTIATE

}  // namespace sg
