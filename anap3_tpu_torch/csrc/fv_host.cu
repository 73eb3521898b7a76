// C host entries of the FV-SIMPLE kernels, loaded with ctypes by
// anap3_tpu_torch/ops/_build.py. Each enqueues its launches on the caller's
// stream, synchronizes nothing, allocates nothing (the wrapper passes every
// buffer in the pointer table, see fv_common.cuh:Ptr) and returns the first
// cudaGetLastError() that is not cudaSuccess.
//
// One SIMPLE iteration is 2 launches in float32 and in float64, whatever
// K, n_refine and the number of lanes are, and a chunk or a step adds none:
// the momentum predictor (fv_bicgstab: the assembly, then the K-iteration
// solve, one cooperative launch) and the pressure stage (fv_pressure:
// Rhie-Chow, the pressure solve and its refinement, the corrections, the
// metrics and control, one cooperative launch).
// fv_chunk_run takes the place of the Pallas fori_loop of
// anap3_tpu/ops/pallas_fv.py make_pallas_fv_chunk_runner: it loops the
// iteration `chunk` times with no Python and no host sync per iteration.
//
// fv_lanes_chunk_run is fv_chunk_run for B sweep lanes at once (each lane's
// flags carried in from its previous chunk): it takes the place of the
// Pallas fori_loop of anap3_tpu/ops/pallas_fv_lanes.py make_fv_lane_runner.
// Every launch covers all lanes, so a B-lane iteration costs the launches of
// one iteration (2), not B times as many, and the chain of dependent
// grid-wide reductions that bounds one solve is paid once for all lanes.
// fv_chunk_run and fv_step_run are its B = 1 case.
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
  w.ref_norm = m(P_REF);
  return w;
}

template <typename T>
int iterate(const Grid<T>& g, const Work<T>& w, int n_refine, int upwind,
            const Control<T>& ctl, int* counts, cudaStream_t s) {
  FV_CHECK(launch_bicg<T>(g, w, upwind, 1, s));
  counts[C_BICG] += 1;
  FV_CHECK(launch_pressure<T>(g, w, n_refine, &ctl, s));
  counts[C_PRESSURE] += 1;
  return 0;
}

template <typename T>
int step_run(const void* const* P, int ny, int nx, int K, int n_refine,
             int upwind, int* counts, cudaStream_t s) {
  const Grid<T> g = make_grid<T>(P, ny, nx, K, 1);
  Work<T> w = make_work<T>(P);
  w.flags = nullptr;  // a step always commits
  w.rows = nullptr;   // control writes the six metrics
  return iterate<T>(g, w, n_refine, upwind, Control<T>{}, counts, s);
}

template <typename T>
int chunk_run(const void* const* P, int ny, int nx, int lanes, int K,
              int n_refine, int upwind, int chunk, int start_iter, int warmup,
              int use_residual, double tol, int* counts, cudaStream_t s) {
  const Grid<T> g = make_grid<T>(P, ny, nx, K, lanes);
  const Work<T> w = make_work<T>(P);
  for (int i = 0; i < chunk; ++i) {
    const Control<T> ctl{i, start_iter + i, warmup, use_residual, T(tol)};
    const int rc = iterate<T>(g, w, n_refine, upwind, ctl, counts, s);
    if (rc) return rc;
  }
  return 0;
}

// Timing aid: `reps` times one kernel's launch of one SIMPLE iteration
// (the index of ops/fv_kernels.py:KERNELS: 0 the momentum predictor, 1 the
// pressure stage), with its folded phase (`folded`: the assembly, control)
// or without it (the solve alone, the pressure stage without control).
// Control runs as a chunk's first row with the warmup out of reach, so it
// sets no flag. Not part of a solve.
template <typename T>
int bench_run(const void* const* P, int ny, int nx, int lanes, int K,
              int n_refine, int upwind, int which, int folded, int reps,
              cudaStream_t s) {
  const Grid<T> g = make_grid<T>(P, ny, nx, K, lanes);
  const Work<T> w = make_work<T>(P);
  const Control<T> ctl{0, 0, 1 << 30, 0, T(0)};
  for (int r = 0; r < reps; ++r) {
    if (which == 0) {
      FV_CHECK(launch_bicg<T>(g, w, upwind, folded, s));
    } else {
      FV_CHECK(launch_pressure<T>(g, w, n_refine, folded ? &ctl : nullptr,
                                  s));
    }
  }
  return 0;
}

}  // namespace
}  // namespace fv

extern "C" {

// dtype: 0 = float32, 1 = float64. The per-lane scalars are the table in
// the pointer table's P_LSC slot.
int fv_step_run(int dtype, int ny, int nx, const void* const* ptrs, int K,
                int n_refine, int upwind, int* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? fv::step_run<double>(ptrs, ny, nx, K, n_refine, upwind,
                                      counts, s)
               : fv::step_run<float>(ptrs, ny, nx, K, n_refine, upwind,
                                     counts, s);
}

// use_residual: 0 for the rel_iter criterion, 1 for the residual criterion
// (each lane's continuity norm over its value at the warmup iteration, the
// normalization carried in the P_REF slot).
int fv_lanes_chunk_run(int dtype, int ny, int nx, int lanes,
                       const void* const* ptrs, int K, int n_refine,
                       int upwind, int chunk, int start_iter, int warmup,
                       int use_residual, double tol, int* counts,
                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? fv::chunk_run<double>(ptrs, ny, nx, lanes, K, n_refine,
                                       upwind, chunk, start_iter, warmup,
                                       use_residual, tol, counts, s)
               : fv::chunk_run<float>(ptrs, ny, nx, lanes, K, n_refine,
                                      upwind, chunk, start_iter, warmup,
                                      use_residual, tol, counts, s);
}

int fv_chunk_run(int dtype, int ny, int nx, const void* const* ptrs, int K,
                 int n_refine, int upwind, int chunk, int start_iter,
                 int warmup, double tol, int* counts, void* stream) {
  return fv_lanes_chunk_run(dtype, ny, nx, 1, ptrs, K, n_refine, upwind,
                            chunk, start_iter, warmup, 0, tol, counts,
                            stream);
}

int fv_bench_run(int dtype, int ny, int nx, int lanes,
                 const void* const* ptrs, int K, int n_refine, int upwind,
                 int which, int folded, int reps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? fv::bench_run<double>(ptrs, ny, nx, lanes, K, n_refine,
                                       upwind, which, folded, reps, s)
               : fv::bench_run<float>(ptrs, ny, nx, lanes, K, n_refine,
                                      upwind, which, folded, reps, s);
}

// The co-resident blocks of the pressure kernel on the current card.
int fv_pressure_coresident(int dtype, int* blocks) {
  return dtype ? (int)fv::pressure_coresident<double>(blocks)
               : (int)fv::pressure_coresident<float>(blocks);
}

const char* fv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
