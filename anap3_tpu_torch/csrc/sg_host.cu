// C host entries of the SG kernels, loaded with ctypes by
// anap3_tpu_torch/ops/_build.py. Each enqueues its launches on the caller's
// stream, synchronizes nothing, allocates nothing (the wrapper passes every
// buffer in the pointer table, see sg_common.cuh:Ptr) and returns the first
// cudaGetLastError() that is not cudaSuccess. Each takes the stage kernel's
// launch geometry as an int array (sg_common.cuh:GeoSlot, from
// ops/sg_kernels.py:stage_geometry) and refuses one it cannot take.
//
// A step is dt (sg_diag), then ONE sg_stage launch per RK stage (four),
// then the step's tail: 6 launches a chunk step (8 when the quadratures are
// sampled), against 10 (12) when a stage took two launches.
//
// sg_chunk_run takes the place of the Pallas fori_loop of
// anap3_tpu/ops/pallas_aligned.py make_aligned_chunk_runner: it loops the
// step's launches `chunk` times with no Python and no host sync per step.
//
// sg_smooth_run is the FAS smoothing loop of a V-cycle level: the
// lax.scan of anap3_tpu/models/spectral_vmg.py make_v_cycle.smooth over
// anap3_tpu/ops/pallas_aligned.py make_aligned_tau_step (x6, tau added to
// every stage residual). It runs n_steps RK4 steps on the stream, the base
// of each step being the previous step's output buffer (two buffers taken
// in turn, arranged so the last step lands in the output: no copy), and
// computes the metrics of the last step only, as the V-cycle keeps only
// those: 5 launches per step plus 3, against 8 per step for n_steps calls
// of sg_step_run. Bound: like the step, by the launches' latency at the
// V-cycle's sizes (a step's products are ~0.2 GFLOP at N=192).
//
// sg_lanes_chunk_run is sg_chunk_run for B sweep lanes at once (the lanes'
// state machines are independent, their flags carried in from the previous
// chunk): it takes the place of the Pallas fori_loops of
// anap3_tpu/ops/pallas_lanes.py make_lane_chunk_runner and
// pallas_lanes_aligned.py make_aligned_lane_runner. Every launch covers all
// lanes, so a B-lane step costs the launches of one step (6, 8 on a
// sampled step), not B times as many; sg_chunk_run is its B = 1 case.
#include "sg_common.cuh"

namespace sg {
namespace {

#define SG_CHECK(call)                        \
  do {                                        \
    cudaError_t err_ = (call);                \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

template <typename T>
struct Work {
  Ops<T> o;
  T *u, *v, *p, *au, *av, *ap, *bu, *bv, *bp, *omega, *part, *qpart, *scal;
  const T *tau_u, *tau_v, *tau_p;
  int lanes;
  StageGeo g;
};

// everything but the stage geometry, which each entry checks into w.g
template <typename T>
Work<T> make_work(const void* const* P, int lanes) {
  auto m = [&](int k) { return static_cast<T*>(const_cast<void*>(P[k])); };
  Work<T> w;
  w.o = make_ops<T>(P);
  w.u = m(P_U); w.v = m(P_V); w.p = m(P_P);
  w.au = m(P_AU); w.av = m(P_AV); w.ap = m(P_AP);
  w.bu = m(P_BU); w.bv = m(P_BV); w.bp = m(P_BP);
  w.omega = m(P_OMEGA);
  w.part = m(P_PART); w.qpart = m(P_QPART); w.scal = m(P_SCAL);
  w.tau_u = m(P_TAUU); w.tau_v = m(P_TAUV); w.tau_p = m(P_TAUP);
  w.lanes = lanes;
  return w;
}

const double kAlphas[4] = {0.25, 1.0 / 3.0, 0.5, 1.0};

// dt plus the four RK stages from the base state into the B buffers
// (base -> A -> B -> A -> B); the last stage writes the partials.
template <typename T>
int rk4(const Work<T>& w, int nf, bool with_tau, int* counts,
        cudaStream_t s) {
  SG_CHECK(launch_dt<T>(w.o, w.u, w.v, w.scal, nf, w.lanes, s));
  counts[C_DIAG] += 1;
  const T* in_u[4] = {w.u, w.au, w.bu, w.au};
  const T* in_v[4] = {w.v, w.av, w.bv, w.av};
  const T* in_p[4] = {w.p, w.ap, w.bp, w.ap};
  T* out_u[4] = {w.au, w.bu, w.au, w.bu};
  T* out_v[4] = {w.av, w.bv, w.av, w.bv};
  T* out_p[4] = {w.ap, w.bp, w.ap, w.bp};
  for (int st = 0; st < 4; ++st) {
    StageArgs<T> a;
    a.u_in = in_u[st]; a.v_in = in_v[st]; a.p_in = in_p[st];
    a.u0 = w.u; a.v0 = w.v; a.p0 = w.p;
    a.u_out = out_u[st]; a.v_out = out_v[st]; a.p_out = out_p[st];
    a.tau_u = with_tau ? w.tau_u : nullptr;
    a.tau_v = with_tau ? w.tau_v : nullptr;
    a.tau_p = with_tau ? w.tau_p : nullptr;
    a.scal = w.scal;
    a.alpha = T(kAlphas[st]);
    a.part = st == 3 ? w.part : nullptr;
    SG_CHECK(launch_stage<T>(w.o, a, nf, w.lanes, w.g, s));
    counts[C_STAGE] += 1;
  }
  return 0;
}

template <typename T>
int step_run(const void* const* P, int nf, const int* geo, int with_tau,
             int* counts, cudaStream_t s) {
  Work<T> w = make_work<T>(P, 1);
  SG_CHECK(stage_geometry(geo, nf, sizeof(T), &w.g));
  int rc = rk4<T>(w, nf, with_tau != 0, counts, s);
  if (rc) return rc;
  SG_CHECK(launch_quadratures<T>(w.o, w.bu, w.bv, w.omega, w.qpart, nf, 1,
                                 s));
  counts[C_DIAG] += 2;
  SG_CHECK(launch_step_finish<T>(
      w.part, w.g.nparts, w.qpart,
      static_cast<T*>(const_cast<void*>(P[P_METRICS])), nf, 1, s));
  counts[C_CONTROL] += 1;
  return 0;
}

template <typename T>
int smooth_run(const void* const* P, int nf, const int* geo, int n_steps,
               int with_tau, int* counts, cudaStream_t s) {
  Work<T> w = make_work<T>(P, 1);
  SG_CHECK(stage_geometry(geo, nf, sizeof(T), &w.g));
  auto m = [&](int k) { return static_cast<T*>(const_cast<void*>(P[k])); };
  T* const outs[2][3] = {{w.bu, w.bv, w.bp}, {m(P_CU), m(P_CV), m(P_CP)}};
  Work<T> wi = w;  // step i: base = step i-1's output (the input for i = 0)
  for (int i = 0; i < n_steps; ++i) {
    T* const* o = outs[(n_steps - 1 - i) % 2];
    wi.bu = o[0]; wi.bv = o[1]; wi.bp = o[2];
    int rc = rk4<T>(wi, nf, with_tau != 0, counts, s);
    if (rc) return rc;
    wi.u = wi.bu; wi.v = wi.bv; wi.p = wi.bp;
  }
  SG_CHECK(launch_quadratures<T>(w.o, w.bu, w.bv, w.omega, w.qpart, nf, 1,
                                 s));
  counts[C_DIAG] += 2;
  SG_CHECK(launch_step_finish<T>(w.part, w.g.nparts, w.qpart, m(P_METRICS),
                                 nf, 1, s));
  counts[C_CONTROL] += 1;
  return 0;
}

template <typename T>
int chunk_run(const void* const* P, int nf, const int* geo, int lanes,
              int chunk, int start_iter, int warmup, int metrics_every,
              int use_residual, double tol, int* counts, cudaStream_t s) {
  Work<T> w = make_work<T>(P, lanes);
  SG_CHECK(stage_geometry(geo, nf, sizeof(T), &w.g));
  T* rows = static_cast<T*>(const_cast<void*>(P[P_ROWS]));
  int* flags = static_cast<int*>(const_cast<void*>(P[P_FLAGS]));
  T* ref_norm = static_cast<T*>(const_cast<void*>(P[P_REFNORM]));
  for (int i = 0; i < chunk; ++i) {
    const int idx = start_iter + i;
    int rc = rk4<T>(w, nf, false, counts, s);
    if (rc) return rc;
    // the aligned kernel's cadence: the first step of every chunk and
    // every metrics_every-th global iteration (one decision for all lanes)
    const int sampled = (i == 0) || (idx % metrics_every == 0);
    if (sampled) {
      SG_CHECK(launch_quadratures<T>(w.o, w.bu, w.bv, w.omega, w.qpart, nf,
                                     lanes, s));
      counts[C_DIAG] += 2;
    }
    SG_CHECK(launch_control<T>(w.part, w.g.nparts, w.qpart, sampled, w.scal,
                               rows, i, idx, warmup, T(tol), use_residual,
                               flags, ref_norm, w.u, w.v, w.p, w.bu, w.bv,
                               w.bp, nf, lanes, s));
    counts[C_CONTROL] += 1;
  }
  return 0;
}

// Timing aid: `reps` launches of one kernel group on a chunk workspace of
// `lanes` lanes (0: one last-stage sg_stage launch, 1: sg_diag dt +
// quadratures, 2: sg_control on a sampled step). Not part of any solve.
template <typename T>
int bench_run(const void* const* P, int nf, const int* geo, int lanes,
              int which, int reps, cudaStream_t s) {
  Work<T> w = make_work<T>(P, lanes);
  SG_CHECK(stage_geometry(geo, nf, sizeof(T), &w.g));
  T* rows = static_cast<T*>(const_cast<void*>(P[P_ROWS]));
  int* flags = static_cast<int*>(const_cast<void*>(P[P_FLAGS]));
  T* ref_norm = static_cast<T*>(const_cast<void*>(P[P_REFNORM]));
  for (int r = 0; r < reps; ++r) {
    if (which == 0) {
      StageArgs<T> a;
      a.u_in = w.au; a.v_in = w.av; a.p_in = w.ap;
      a.u0 = w.u; a.v0 = w.v; a.p0 = w.p;
      a.u_out = w.bu; a.v_out = w.bv; a.p_out = w.bp;
      a.tau_u = a.tau_v = a.tau_p = nullptr;
      a.scal = w.scal;
      a.alpha = T(1);
      a.part = w.part;
      SG_CHECK(launch_stage<T>(w.o, a, nf, lanes, w.g, s));
    } else if (which == 1) {
      SG_CHECK(launch_dt<T>(w.o, w.u, w.v, w.scal, nf, lanes, s));
      SG_CHECK(launch_quadratures<T>(w.o, w.bu, w.bv, w.omega, w.qpart, nf,
                                     lanes, s));
    } else {
      SG_CHECK(launch_control<T>(w.part, w.g.nparts, w.qpart, 1, w.scal,
                                 rows, 0, 0, 1 << 30, T(0), 0, flags,
                                 ref_norm, w.u, w.v, w.p, w.bu, w.bv, w.bp,
                                 nf, lanes, s));
    }
  }
  return 0;
}

}  // namespace
}  // namespace sg

extern "C" {

// dtype: 0 = float32, 1 = float64. geo: the stage geometry (G_COUNT ints,
// sg_common.cuh:GeoSlot). The per-lane scalars are the table in the pointer
// table's P_LSC slot.
int sg_step_run(int dtype, int nf, const int* geo, const void* const* ptrs,
                int with_tau, int* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::step_run<double>(ptrs, nf, geo, with_tau, counts, s)
               : sg::step_run<float>(ptrs, nf, geo, with_tau, counts, s);
}

int sg_smooth_run(int dtype, int nf, const int* geo, const void* const* ptrs,
                  int n_steps, int with_tau, int* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::smooth_run<double>(ptrs, nf, geo, n_steps, with_tau,
                                        counts, s)
               : sg::smooth_run<float>(ptrs, nf, geo, n_steps, with_tau,
                                       counts, s);
}

int sg_lanes_chunk_run(int dtype, int nf, const int* geo, int lanes,
                       const void* const* ptrs, int chunk, int start_iter,
                       int warmup, int metrics_every, int use_residual,
                       double tol, int* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::chunk_run<double>(ptrs, nf, geo, lanes, chunk,
                                       start_iter, warmup, metrics_every,
                                       use_residual, tol, counts, s)
               : sg::chunk_run<float>(ptrs, nf, geo, lanes, chunk,
                                      start_iter, warmup, metrics_every,
                                      use_residual, tol, counts, s);
}

int sg_chunk_run(int dtype, int nf, const int* geo, const void* const* ptrs,
                 int chunk, int start_iter, int warmup, int metrics_every,
                 int use_residual, double tol, int* counts, void* stream) {
  return sg_lanes_chunk_run(dtype, nf, geo, 1, ptrs, chunk, start_iter,
                            warmup, metrics_every, use_residual, tol, counts,
                            stream);
}

int sg_bench_run(int dtype, int nf, const int* geo, int lanes,
                 const void* const* ptrs, int which, int reps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::bench_run<double>(ptrs, nf, geo, lanes, which, reps, s)
               : sg::bench_run<float>(ptrs, nf, geo, lanes, which, reps, s);
}

const char* sg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
