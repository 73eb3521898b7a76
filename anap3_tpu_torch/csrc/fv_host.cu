// C host entries of the FV-SIMPLE kernels, loaded with ctypes by
// anap3_tpu_torch/ops/_build.py. Each enqueues its launches on the caller's
// stream, synchronizes nothing, allocates nothing (the wrapper passes every
// buffer in the pointer table, see fv_common.cuh:Ptr) and returns the first
// cudaGetLastError() that is not cudaSuccess.
//
// One SIMPLE iteration is 3K + 4 + n_refine + 4 (1 + n_refine) + 1 launches:
// assemble, K x (direction, stabilize, update), Rhie-Chow, the pressure
// solve's products (and the refinement residual), correct, metrics, and
// control (62 at K=16 in float32, 57 in float64). fv_chunk_run takes the
// place of the Pallas fori_loop of anap3_tpu/ops/pallas_fv.py
// make_pallas_fv_chunk_runner: it loops the iteration `chunk` times with no
// Python and no host sync per iteration.
#include "fv_common.cuh"

namespace fv {
namespace {

#define FV_CHECK(call)                         \
  do {                                         \
    cudaError_t err_ = (call);                 \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

template <typename T>
Work<T> make_work(const void* const* P) {
  auto m = [&](int k) { return static_cast<T*>(const_cast<void*>(P[k])); };
  Work<T> w;
  w.V1 = m(P_V1); w.V2 = m(P_V2); w.inv_lam = m(P_INVLAM);
  w.A1 = m(P_A1); w.A2 = m(P_A2); w.aP_bc = m(P_APBC); w.b_bc_u = m(P_BBCU);
  w.u = m(P_U); w.v = m(P_V); w.p = m(P_P); w.mx = m(P_MX); w.my = m(P_MY);
  w.gpx = m(P_GPX); w.gpy = m(P_GPY); w.aPr = m(P_APR);
  w.aE = m(P_AE); w.aW = m(P_AW); w.aN = m(P_AN); w.aS = m(P_AS);
  w.Du = m(P_DU);
  w.x = m(P_X); w.r = m(P_R); w.rh = m(P_RH);
  w.pv[0] = m(P_PV0); w.pv[1] = m(P_PV1);
  w.vv[0] = m(P_VV0); w.vv[1] = m(P_VV1);
  w.s = m(P_S); w.t = m(P_T);
  w.mxs = m(P_MXS); w.mys = m(P_MYS); w.rhsp = m(P_RHSP); w.res = m(P_RES);
  w.g1 = m(P_G1); w.g2 = m(P_G2); w.g3 = m(P_G3); w.pp = m(P_PP);
  w.part_rhs = m(P_PART_RHS); w.part_r = m(P_PART_R);
  w.part_v = m(P_PART_V); w.part_t = m(P_PART_T);
  w.part_m = m(P_PART_M); w.part_m2 = m(P_PART_M2);
  w.part_c = m(P_PART_C); w.part_q = m(P_PART_Q);
  w.slots = m(P_SLOTS);
  w.metrics = m(P_METRICS);
  w.rows = m(P_ROWS);
  w.flags = static_cast<int*>(const_cast<void*>(P[P_FLAGS]));
  return w;
}

// p' (+)= V1 ((V1^T (f - mean) V2) * inv_lam) V2^T
template <typename T>
int psolve(const Grid<T>& g, const Work<T>& w, const T* f,
           const T* mean_part, int accumulate, int* counts, cudaStream_t s) {
  const int ny = g.ny, nx = g.nx, n = ny * nx;
  FV_CHECK(launch_dense<T>(ny, nx, ny, w.V1, 1, f, 0, mean_part, g.nb, n,
                           nullptr, 0, w.g1, s));
  FV_CHECK(launch_dense<T>(ny, nx, nx, w.g1, 0, w.V2, 0, nullptr, g.nb, n,
                           w.inv_lam, 0, w.g2, s));
  FV_CHECK(launch_dense<T>(ny, nx, ny, w.V1, 0, w.g2, 0, nullptr, g.nb, n,
                           nullptr, 0, w.g3, s));
  FV_CHECK(launch_dense<T>(ny, nx, nx, w.g3, 0, w.V2, 1, nullptr, g.nb, n,
                           nullptr, accumulate, w.pp, s));
  counts[C_DENSE] += 4;
  return 0;
}

template <typename T>
int iterate(const Grid<T>& g, const Work<T>& w, int K, int n_refine,
            int upwind, int* counts, cudaStream_t s) {
  FV_CHECK(launch_stencil<T>(PH_ASSEMBLE, g, w, upwind, s));
  for (int k = 0; k < K; ++k) {
    FV_CHECK(launch_bicg<T>(BP_DIRECTION, k, g, w, s));
    FV_CHECK(launch_bicg<T>(BP_STABILIZE, k, g, w, s));
    FV_CHECK(launch_bicg<T>(BP_UPDATE, k, g, w, s));
  }
  counts[C_BICG] += 3 * K;
  FV_CHECK(launch_stencil<T>(PH_RHIE_CHOW, g, w, upwind, s));
  int rc = psolve<T>(g, w, w.rhsp, w.part_m, 0, counts, s);
  if (rc) return rc;
  for (int r = 0; r < n_refine; ++r) {
    FV_CHECK(launch_stencil<T>(PH_RESIDUAL, g, w, upwind, s));
    counts[C_STENCIL] += 1;
    rc = psolve<T>(g, w, w.res, w.part_m2, 1, counts, s);
    if (rc) return rc;
  }
  FV_CHECK(launch_stencil<T>(PH_CORRECT, g, w, upwind, s));
  FV_CHECK(launch_stencil<T>(PH_METRICS, g, w, upwind, s));
  counts[C_STENCIL] += 4;
  return 0;
}

template <typename T>
int step_run(const void* const* P, const double* h, int ny, int nx, int K,
             int n_refine, int upwind, int* counts, cudaStream_t s) {
  const Grid<T> g = make_grid<T>(h, ny, nx);
  Work<T> w = make_work<T>(P);
  w.flags = nullptr;  // a step always commits
  w.rows = nullptr;   // control writes the six metrics
  const int rc = iterate<T>(g, w, K, n_refine, upwind, counts, s);
  if (rc) return rc;
  FV_CHECK(launch_control<T>(g, w, 0, 0, 0, T(0), s));
  counts[C_CONTROL] += 1;
  return 0;
}

template <typename T>
int chunk_run(const void* const* P, const double* h, int ny, int nx, int K,
              int n_refine, int upwind, int chunk, int start_iter, int warmup,
              double tol, int* counts, cudaStream_t s) {
  const Grid<T> g = make_grid<T>(h, ny, nx);
  const Work<T> w = make_work<T>(P);
  for (int i = 0; i < chunk; ++i) {
    const int rc = iterate<T>(g, w, K, n_refine, upwind, counts, s);
    if (rc) return rc;
    FV_CHECK(launch_control<T>(g, w, i, start_iter + i, warmup, T(tol), s));
    counts[C_CONTROL] += 1;
  }
  return 0;
}

// Timing aid: `reps` times the launches one kernel makes in one SIMPLE
// iteration (0: fv_stencil's phases, 1: fv_bicgstab's 3K launches,
// 2: fv_dense's products, 3: one fv_control launch). Not part of a solve.
template <typename T>
int bench_run(const void* const* P, const double* h, int ny, int nx, int K,
              int n_refine, int upwind, int which, int reps, cudaStream_t s) {
  const Grid<T> g = make_grid<T>(h, ny, nx);
  const Work<T> w = make_work<T>(P);
  int counts[C_COUNT] = {0, 0, 0, 0};
  for (int r = 0; r < reps; ++r) {
    if (which == 0) {
      FV_CHECK(launch_stencil<T>(PH_ASSEMBLE, g, w, upwind, s));
      FV_CHECK(launch_stencil<T>(PH_RHIE_CHOW, g, w, upwind, s));
      for (int q = 0; q < n_refine; ++q)
        FV_CHECK(launch_stencil<T>(PH_RESIDUAL, g, w, upwind, s));
      FV_CHECK(launch_stencil<T>(PH_CORRECT, g, w, upwind, s));
      FV_CHECK(launch_stencil<T>(PH_METRICS, g, w, upwind, s));
    } else if (which == 1) {
      for (int k = 0; k < K; ++k) {
        FV_CHECK(launch_bicg<T>(BP_DIRECTION, k, g, w, s));
        FV_CHECK(launch_bicg<T>(BP_STABILIZE, k, g, w, s));
        FV_CHECK(launch_bicg<T>(BP_UPDATE, k, g, w, s));
      }
    } else if (which == 2) {
      for (int q = 0; q <= n_refine; ++q) {
        const int rc = psolve<T>(g, w, q ? w.res : w.rhsp,
                                 q ? w.part_m2 : w.part_m, q, counts, s);
        if (rc) return rc;
      }
    } else {
      FV_CHECK(launch_control<T>(g, w, 0, 0, 1 << 30, T(0), s));
    }
  }
  return 0;
}

}  // namespace
}  // namespace fv

extern "C" {

// dtype: 0 = float32, 1 = float64.
int fv_step_run(int dtype, int ny, int nx, const void* const* ptrs,
                const double* scal, int K, int n_refine, int upwind,
                int* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? fv::step_run<double>(ptrs, scal, ny, nx, K, n_refine,
                                      upwind, counts, s)
               : fv::step_run<float>(ptrs, scal, ny, nx, K, n_refine, upwind,
                                     counts, s);
}

int fv_chunk_run(int dtype, int ny, int nx, const void* const* ptrs,
                 const double* scal, int K, int n_refine, int upwind,
                 int chunk, int start_iter, int warmup, double tol,
                 int* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? fv::chunk_run<double>(ptrs, scal, ny, nx, K, n_refine,
                                       upwind, chunk, start_iter, warmup, tol,
                                       counts, s)
               : fv::chunk_run<float>(ptrs, scal, ny, nx, K, n_refine, upwind,
                                      chunk, start_iter, warmup, tol, counts,
                                      s);
}

int fv_bench_run(int dtype, int ny, int nx, const void* const* ptrs,
                 const double* scal, int K, int n_refine, int upwind,
                 int which, int reps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? fv::bench_run<double>(ptrs, scal, ny, nx, K, n_refine,
                                       upwind, which, reps, s)
               : fv::bench_run<float>(ptrs, scal, ny, nx, K, n_refine, upwind,
                                      which, reps, s);
}

const char* fv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
