// sg_control: the tail of one step. Finishes the partial reductions,
// writes the step's history row and runs the convergence state machine.
//
// Replaces: the per-step tail of the chunk kernels' fori_loop body,
//   anap3_tpu/ops/pallas_aligned.py make_aligned_chunk_runner (rows, the
//   rel_iter/residual criteria, warmup gate, NaN divergence, conv_iter,
//   done and the commit under pl.when(~done)) and the same tail of
//   anap3_tpu/ops/pallas_tiled.py make_tiled_chunk_runner. Semantics:
//   anap3_tpu/models/runner.py make_chunk_runner.
//
// Bound on the card: pure latency. One block reduces ~81-441 partials per
//   quantity and copies the committed state (3 x 16.6K values at N=128,
//   L2-resident); with 1024 threads the copy's load latency, not bandwidth,
//   is what remains.
// Design: a single block, so the state machine runs in one thread with no
//   inter-block handshake, and the partials reduce in a fixed-order tree
//   (bit-reproducible). The commit of the new stage state into the chunk's
//   state happens here, only when the step started un-done, so a frozen
//   (converged or diverged) state is never overwritten; the host loop keeps
//   launching without reading any flag. sg_step_finish is the per-step
//   variant that writes the six metrics of make_sg_step instead.
#include "sg_common.cuh"

namespace sg {
namespace {

template <typename T>
__device__ void reduce_partials(const T* part, int nparts, int nb, T* out,
                                T* sh) {
  const int tid = threadIdx.x;
  for (int q = 0; q < nparts; ++q) {
    T acc = 0;
    for (int b = tid; b < nb; b += RED_THREADS) acc += part[(size_t)b * nparts + q];
    acc = block_sum(acc, sh, tid, RED_THREADS);
    if (tid == 0) out[q] = acc;
  }
}

template <typename T>
__global__ void control_kernel(const T* part, const T* qpart, int nb,
                               int sampled, T* scal, T* rows, int row,
                               int idx, int warmup, T tol, int use_residual,
                               int* flags, T* ref_norm, T* u, T* v, T* p,
                               const T* u_new, const T* v_new,
                               const T* p_new, int nf) {
  __shared__ T sh[RED_THREADS];
  __shared__ T sums[NPART];
  __shared__ T qsums[NQPART];
  __shared__ int was_done;
  reduce_partials(part, NPART, nb, sums, sh);
  if (sampled) reduce_partials(qpart, NQPART, nb, qsums, sh);
  if (threadIdx.x == 0) {
    if (sampled) {
      scal[S_E] = T(0.5) * qsums[0];
      scal[S_Z] = T(0.5) * qsums[1];
      scal[S_P] = T(0.5) * qsums[2];
    }
    const int done = flags[0];
    const T rel = nan_max(sqrt(sums[3]) / (sqrt(scal[S_U0SQ]) + T(1e-12)),
                          sqrt(sums[4]) / (sqrt(scal[S_V0SQ]) + T(1e-12)));
    const T vals[7] = {rel, sqrt(sums[0]), sqrt(sums[1]), sqrt(sums[2]),
                       scal[S_E], scal[S_Z], scal[S_P]};
    const T nan = T(NAN);
    for (int c = 0; c < 7; ++c) rows[(size_t)row * 7 + c] = done ? nan : vals[c];
    // the row's values (NaN once done) feed the criteria, as in
    // runner.make_chunk_runner
    const T rel_row = done ? nan : rel;
    const T cont = done ? nan : vals[3];
    T rn = *ref_norm;
    if (use_residual && idx == warmup) rn = cont;  // pinned at warmup
    const T crit = use_residual ? cont / nan_max(rn, T(1e-30)) : rel_row;
    if (!done) {
      const bool finite = isfinite(rel);
      const bool newly_conv = idx >= warmup && crit < tol && finite;
      if (newly_conv || !finite) {
        flags[0] = 1;
        flags[1] = idx + 1;
      }
      if (newly_conv) flags[2] = 1;
    }
    *ref_norm = rn;
    was_done = done;
  }
  __syncthreads();
  if (!was_done) {  // commit the step
    const int n = nf * nf, ni = nf - 2, np = ni * ni;
    T* __restrict__ du = u;
    T* __restrict__ dv = v;
    T* __restrict__ dp = p;
    const T* __restrict__ su = u_new;
    const T* __restrict__ sv = v_new;
    const T* __restrict__ sp = p_new;
    for (int k = threadIdx.x; k < n; k += RED_THREADS) {
      du[k] = su[k];
      dv[k] = sv[k];
    }
    for (int k = threadIdx.x; k < np; k += RED_THREADS) dp[k] = sp[k];
  }
}

template <typename T>
__global__ void step_finish_kernel(const T* part, const T* qpart, int nb,
                                   T* metrics) {
  __shared__ T sh[RED_THREADS];
  __shared__ T sums[NPART];
  __shared__ T qsums[NQPART];
  reduce_partials(part, NPART, nb, sums, sh);
  reduce_partials(qpart, NQPART, nb, qsums, sh);
  if (threadIdx.x == 0) {
    metrics[0] = sqrt(sums[0]);
    metrics[1] = sqrt(sums[1]);
    metrics[2] = sqrt(sums[2]);
    metrics[3] = T(0.5) * qsums[0];
    metrics[4] = T(0.5) * qsums[1];
    metrics[5] = T(0.5) * qsums[2];
  }
}

}  // namespace

template <typename T>
cudaError_t launch_control(const T* part, const T* qpart, int nb, int sampled,
                           T* scal, T* rows, int row, int idx, int warmup,
                           T tol, int use_residual, int* flags, T* ref_norm,
                           T* u, T* v, T* p, const T* u_new, const T* v_new,
                           const T* p_new, int nf, cudaStream_t s) {
  control_kernel<T><<<1, RED_THREADS, 0, s>>>(
      part, qpart, nb, sampled, scal, rows, row, idx, warmup, tol,
      use_residual, flags, ref_norm, u, v, p, u_new, v_new, p_new, nf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_step_finish(const T* part, const T* qpart, int nb,
                               T* metrics, cudaStream_t s) {
  step_finish_kernel<T><<<1, RED_THREADS, 0, s>>>(part, qpart, nb, metrics);
  return cudaGetLastError();
}

#define SG_INSTANTIATE(T)                                                   \
  template cudaError_t launch_control<T>(                                   \
      const T*, const T*, int, int, T*, T*, int, int, int, T, int, int*,    \
      T*, T*, T*, T*, const T*, const T*, const T*, int, cudaStream_t);     \
  template cudaError_t launch_step_finish<T>(const T*, const T*, int, T*,   \
                                             cudaStream_t);
SG_INSTANTIATE(float)
SG_INSTANTIATE(double)
#undef SG_INSTANTIATE

}  // namespace sg
