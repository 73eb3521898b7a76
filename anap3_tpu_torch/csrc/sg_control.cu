// sg_control: the tail of one unsampled chunk step. Finishes the partial
// reductions, writes the step's history row, runs the convergence state
// machine and sets the next step's dt.
//
// Replaces: the per-step tail of the chunk kernels' fori_loop body,
//   anap3_tpu/ops/pallas_aligned.py make_aligned_chunk_runner (rows, the
//   rel_iter/residual criteria, warmup gate, NaN divergence, conv_iter,
//   done; the commit under pl.when(~done) is the last stage's, sg_stage.cu)
//   and the same tail of anap3_tpu/ops/pallas_tiled.py
//   make_tiled_chunk_runner, together with their next step's adaptive dt
//   (_adaptive_dt / adaptive_dt). Semantics:
//   anap3_tpu/models/runner.py make_chunk_runner.
//
// Bound on the card: pure latency. A lane's 9 columns of partial sums
//   (5 of the last stage, 4 of the base it left; one value per stage block,
//   128 at N=128) are a few KB, L2-resident; a launch costs ~3 us of floor.
// Design: one block a lane, one warp a column, all columns at once; each
//   warp reproduces the fixed-order 1024-slot tree (warp_tree in
//   sg_common.cuh), so the sums keep their bits, and the maxima are exact
//   in any order. Thread 0 runs the state machine (finish_lane), then writes dt
//   and the base norms for the next step from the columns of the base, so
//   dt_kernel runs once a chunk. No state moves here: the last stage wrote
//   the step into the chunk's state in place, and not where the lane was
//   done.
// Lanes: one block per lane, each with its own partials, device scalars,
//   flags, residual normalization and row slot rows[row, lane, :].
#include "sg_common.cuh"

namespace sg {
namespace {

constexpr int CONTROL_THREADS = 32 * (NPART + NDPART);

template <typename T>
__global__ void __launch_bounds__(CONTROL_THREADS)
    control_kernel(Tail<T> t, int nf) {
  __shared__ T sums[TAIL_COLS];
  tail_sums(t, blockIdx.x, nf, false, 0, NPART + NDPART, sums);
  __syncthreads();
  if (threadIdx.x == 0) finish_lane(t, blockIdx.x, false, sums);
}

}  // namespace

template <typename T>
cudaError_t launch_control(const Tail<T>& t, int nf, int lanes,
                           cudaStream_t s) {
  if (!t.dpart || !t.rows || t.nparts > TREE_PASSES * RED_THREADS)
    return cudaErrorInvalidValue;
  control_kernel<T><<<lanes, CONTROL_THREADS, 0, s>>>(t, nf);
  return cudaGetLastError();
}

template cudaError_t launch_control<float>(const Tail<float>&, int, int,
                                           cudaStream_t);
template cudaError_t launch_control<double>(const Tail<double>&, int, int,
                                            cudaStream_t);

}  // namespace sg
