// fv_control: the tail of one SIMPLE iteration. Finishes the metric
// reductions, writes the history row and runs the convergence state machine.
//
// Replaces: the per-iteration tail of loop_body in
//   anap3_tpu/ops/pallas_fv.py make_pallas_fv_chunk_runner (rel = max of the
//   relative u/v changes, rows NaN once done, warmup gate, NaN divergence,
//   conv_iter = idx + 1, the done flag) and the metrics vector of
//   make_pallas_fv_step.
//
// Bound on the card: pure latency. One block reduces 10 columns of 64
//   partials at N=128.
// Design: a single block, so the state machine runs in one thread with no
//   inter-block handshake, and the partials reduce in a fixed-order tree
//   (bit-reproducible). There is no commit copy: fv_stencil's correction
//   phase already updated the state in place only when the step started
//   un-done, which is the Pallas keep(new, old) under the start flag. The
//   converged flag is set with conv_iter, so it equals the contract's
//   done & isfinite(rows[conv_iter - 1 - start_iter, 0]). With no rows (the
//   step entry) it writes the six metrics instead.
#include "fv_common.cuh"

namespace fv {
namespace {

template <typename T>
__global__ void control_kernel(Grid<T> g, Work<T> w, int row, int idx,
                               int warmup, T tol) {
  __shared__ T sh[RED_THREADS];
  __shared__ T cs[NPART_C];
  __shared__ T qs[NPART_Q];
  const int tid = threadIdx.x;
  for (int q = 0; q < NPART_C; ++q) {
    const T v = reduce_col(w.part_c, NPART_C, q, g.nb, sh, tid, RED_THREADS);
    if (tid == 0) cs[q] = v;
  }
  for (int q = 0; q < NPART_Q; ++q) {
    const T v = reduce_col(w.part_q, NPART_Q, q, g.nb, sh, tid, RED_THREADS);
    if (tid == 0) qs[q] = v;
  }
  if (tid != 0) return;
  const T dA = g.dx * g.dy;
  const T m[6] = {sqrt(cs[0]), sqrt(cs[1]), sqrt(qs[0]),
                  T(0.5) * cs[2] * dA, T(0.5) * qs[1] * dA,
                  T(0.5) * qs[2] * dA};
  if (w.rows == nullptr) {
    for (int q = 0; q < 6; ++q) w.metrics[q] = m[q];
    return;
  }
  const int done = w.flags[0];
  const T rel = nan_max(sqrt(cs[3]) / (sqrt(cs[5]) + T(1e-12)),
                        sqrt(cs[4]) / (sqrt(cs[6]) + T(1e-12)));
  const T nan = T(NAN);
  T* r = w.rows + (size_t)row * 7;
  r[0] = done ? nan : rel;
  for (int q = 0; q < 6; ++q) r[1 + q] = done ? nan : m[q];
  if (!done) {
    const bool finite = isfinite(rel);
    const bool newly_conv = idx >= warmup && rel < tol && finite;
    if (newly_conv || !finite) {
      w.flags[0] = 1;
      w.flags[1] = idx + 1;
    }
    if (newly_conv) w.flags[2] = 1;
  }
}

}  // namespace

template <typename T>
cudaError_t launch_control(const Grid<T>& g, const Work<T>& w, int row,
                           int idx, int warmup, T tol, cudaStream_t s) {
  control_kernel<T><<<1, RED_THREADS, 0, s>>>(g, w, row, idx, warmup, tol);
  return cudaGetLastError();
}

template cudaError_t launch_control<float>(const Grid<float>&,
                                           const Work<float>&, int, int, int,
                                           float, cudaStream_t);
template cudaError_t launch_control<double>(const Grid<double>&,
                                            const Work<double>&, int, int,
                                            int, double, cudaStream_t);

}  // namespace fv
