// C host entries of the SG kernels, loaded with ctypes by
// anap3_tpu_torch/ops/_build.py. Each enqueues its launches on the caller's
// stream, synchronizes nothing, allocates nothing (the wrapper passes every
// buffer in the pointer table, see sg_common.cuh:Ptr) and returns the first
// cudaGetLastError() that is not cudaSuccess.
//
// sg_chunk_run takes the place of the Pallas fori_loop of
// anap3_tpu/ops/pallas_aligned.py make_aligned_chunk_runner: it loops the
// step's launches `chunk` times with no Python and no host sync per step.
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
  T *u, *v, *p, *au, *av, *ap, *bu, *bv, *bp, *left, *omega, *part, *qpart,
      *scal;
  const T *tau_u, *tau_v, *tau_p;
  int nb;
};

template <typename T>
Work<T> make_work(const void* const* P, const double* h, int nf) {
  auto m = [&](int k) { return static_cast<T*>(const_cast<void*>(P[k])); };
  Work<T> w;
  w.o = make_ops<T>(P, h);
  w.u = m(P_U); w.v = m(P_V); w.p = m(P_P);
  w.au = m(P_AU); w.av = m(P_AV); w.ap = m(P_AP);
  w.bu = m(P_BU); w.bv = m(P_BV); w.bp = m(P_BP);
  w.left = m(P_LEFT); w.omega = m(P_OMEGA);
  w.part = m(P_PART); w.qpart = m(P_QPART); w.scal = m(P_SCAL);
  w.tau_u = m(P_TAUU); w.tau_v = m(P_TAUV); w.tau_p = m(P_TAUP);
  w.nb = tiles(nf) * tiles(nf);
  return w;
}

const double kAlphas[4] = {0.25, 1.0 / 3.0, 0.5, 1.0};

// dt plus the four RK stages from the base state into the B buffers
// (base -> A -> B -> A -> B); the last stage writes the partials.
template <typename T>
int rk4(const Work<T>& w, int nf, bool with_tau, int* counts,
        cudaStream_t s) {
  SG_CHECK(launch_dt<T>(w.o, w.u, w.v, w.scal, nf, s));
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
    a.left = w.left;
    a.tau_u = with_tau ? w.tau_u : nullptr;
    a.tau_v = with_tau ? w.tau_v : nullptr;
    a.tau_p = with_tau ? w.tau_p : nullptr;
    a.scal = w.scal;
    a.alpha = T(kAlphas[st]);
    a.part = st == 3 ? w.part : nullptr;
    SG_CHECK(launch_stage<T>(w.o, a, nf, s));
    counts[C_STAGE] += 2;
  }
  return 0;
}

template <typename T>
int step_run(const void* const* P, const double* h, int nf, int with_tau,
             int* counts, cudaStream_t s) {
  const Work<T> w = make_work<T>(P, h, nf);
  int rc = rk4<T>(w, nf, with_tau != 0, counts, s);
  if (rc) return rc;
  SG_CHECK(launch_quadratures<T>(w.o, w.bu, w.bv, w.omega, w.qpart, nf, s));
  counts[C_DIAG] += 2;
  SG_CHECK(launch_step_finish<T>(w.part, w.qpart, w.nb,
                                 static_cast<T*>(const_cast<void*>(P[P_METRICS])),
                                 s));
  counts[C_CONTROL] += 1;
  return 0;
}

template <typename T>
int chunk_run(const void* const* P, const double* h, int nf, int chunk,
              int start_iter, int warmup, int metrics_every,
              int use_residual, double tol, int* counts, cudaStream_t s) {
  const Work<T> w = make_work<T>(P, h, nf);
  T* rows = static_cast<T*>(const_cast<void*>(P[P_ROWS]));
  int* flags = static_cast<int*>(const_cast<void*>(P[P_FLAGS]));
  T* ref_norm = static_cast<T*>(const_cast<void*>(P[P_REFNORM]));
  for (int i = 0; i < chunk; ++i) {
    const int idx = start_iter + i;
    int rc = rk4<T>(w, nf, false, counts, s);
    if (rc) return rc;
    // the aligned kernel's cadence: the first step of every chunk and
    // every metrics_every-th global iteration
    const int sampled = (i == 0) || (idx % metrics_every == 0);
    if (sampled) {
      SG_CHECK(launch_quadratures<T>(w.o, w.bu, w.bv, w.omega, w.qpart, nf,
                                     s));
      counts[C_DIAG] += 2;
    }
    SG_CHECK(launch_control<T>(w.part, w.qpart, w.nb, sampled, w.scal, rows,
                               i, idx, warmup, T(tol), use_residual, flags,
                               ref_norm, w.u, w.v, w.p, w.bu, w.bv, w.bp, nf,
                               s));
    counts[C_CONTROL] += 1;
  }
  return 0;
}

// Timing aid: `reps` launches of one kernel group on a chunk workspace
// (0: one last-stage sg_stage pair, 1: sg_diag dt + quadratures,
// 2: sg_control on a sampled step). Not part of any solve.
template <typename T>
int bench_run(const void* const* P, const double* h, int nf, int which,
              int reps, cudaStream_t s) {
  const Work<T> w = make_work<T>(P, h, nf);
  T* rows = static_cast<T*>(const_cast<void*>(P[P_ROWS]));
  int* flags = static_cast<int*>(const_cast<void*>(P[P_FLAGS]));
  T* ref_norm = static_cast<T*>(const_cast<void*>(P[P_REFNORM]));
  for (int r = 0; r < reps; ++r) {
    if (which == 0) {
      StageArgs<T> a;
      a.u_in = w.au; a.v_in = w.av; a.p_in = w.ap;
      a.u0 = w.u; a.v0 = w.v; a.p0 = w.p;
      a.u_out = w.bu; a.v_out = w.bv; a.p_out = w.bp;
      a.left = w.left;
      a.tau_u = a.tau_v = a.tau_p = nullptr;
      a.scal = w.scal;
      a.alpha = T(1);
      a.part = w.part;
      SG_CHECK(launch_stage<T>(w.o, a, nf, s));
    } else if (which == 1) {
      SG_CHECK(launch_dt<T>(w.o, w.u, w.v, w.scal, nf, s));
      SG_CHECK(launch_quadratures<T>(w.o, w.bu, w.bv, w.omega, w.qpart, nf,
                                     s));
    } else {
      SG_CHECK(launch_control<T>(w.part, w.qpart, w.nb, 1, w.scal, rows, 0,
                                 0, 1 << 30, T(0), 0, flags, ref_norm, w.u,
                                 w.v, w.p, w.bu, w.bv, w.bp, nf, s));
    }
  }
  return 0;
}

}  // namespace
}  // namespace sg

extern "C" {

// dtype: 0 = float32, 1 = float64.
int sg_step_run(int dtype, int nf, const void* const* ptrs,
                const double* scal, int with_tau, int* counts,
                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::step_run<double>(ptrs, scal, nf, with_tau, counts, s)
               : sg::step_run<float>(ptrs, scal, nf, with_tau, counts, s);
}

int sg_chunk_run(int dtype, int nf, const void* const* ptrs,
                 const double* scal, int chunk, int start_iter, int warmup,
                 int metrics_every, int use_residual, double tol,
                 int* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::chunk_run<double>(ptrs, scal, nf, chunk, start_iter,
                                       warmup, metrics_every, use_residual,
                                       tol, counts, s)
               : sg::chunk_run<float>(ptrs, scal, nf, chunk, start_iter,
                                      warmup, metrics_every, use_residual,
                                      tol, counts, s);
}

int sg_bench_run(int dtype, int nf, const void* const* ptrs,
                 const double* scal, int which, int reps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::bench_run<double>(ptrs, scal, nf, which, reps, s)
               : sg::bench_run<float>(ptrs, scal, nf, which, reps, s);
}

const char* sg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
