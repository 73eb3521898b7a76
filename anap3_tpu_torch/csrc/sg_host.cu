// C host entries of the SG kernels, loaded with ctypes by
// anap3_tpu_torch/ops/_build.py. Each enqueues its launches on the caller's
// stream, synchronizes nothing, allocates nothing (the wrapper passes every
// buffer in the pointer table, see sg_common.cuh:Ptr) and returns the first
// cudaGetLastError() that is not cudaSuccess. Each takes the stage kernel's
// launch geometry as an int array (sg_common.cuh:GeoSlot, from
// ops/sg_kernels.py:stage_geometry) and refuses one it cannot take.
//
// A chunk step is ONE sg_stage launch per RK stage (four), the last one
// writing the step into the chunk's state in place, then one tail launch:
// sg_control's control_kernel, or on a sampled step sg_diag's tail_kernel
// (the quadratures and the same finish, one cooperative launch). The
// finish sets the next step's dt, so sg_diag's dt_kernel runs once a chunk,
// at its first step: 5 launches a step and 1 a chunk (6 a step, 8 sampled,
// when the tail copied the state and dt ran every step). A single step
// (sg_step_run) is dt, four stages and the tail kernel: 6.
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
// those. dt_kernel runs at the first step only: the last stage of every
// other step also writes the partials of the state it leaves (out of
// place, P_DPART), and the first stage of the next step takes its dt from
// their maxima (sg_stage.cu). So a call is 4 launches a step plus 2 (dt
// and the tail kernel), against 6 a step for n_steps calls of sg_step_run,
// with the same bits: a maximum is exact in any order and dt_of is the dt
// kernel's arithmetic. Bound: like the step, by the launches' latency at
// the V-cycle's sizes (a step's products are ~0.2 GFLOP at N=192).
//
// With x1 = 1 (matmul_algorithm=x1, float32 only) a chunk runs the x1
// instances of the stage and tail kernels (one bf16 tensor-core pass a
// product; sg_stage.cu, sg_diag.cu), counted as C_STAGE_X1 and C_DIAG_X1;
// dt and control are the exact chunk's, dt also rounding the chunk's
// starting state into its bf16 copy (P_X1S), which every x1 stage then
// keeps beside the float32 state it writes. The step and the smoother take no
// x1: the JAX package's per-step fallback keeps x3 and its V-cycle
// smoother runs x6.
//
// sg_resident_chunk_run is the same chunk in one launch of the resident
// kernel (sg_resident.cu), at the orders where a lane fits one
// thread-block cluster's shared memory (sg_resident_geometry), with the
// chunk's outputs bit for bit; the wrappers take it wherever that
// geometry exists.
//
// sg_lanes_chunk_run is sg_chunk_run for B sweep lanes at once (the lanes'
// state machines are independent, their flags carried in from the previous
// chunk): it takes the place of the Pallas fori_loops of
// anap3_tpu/ops/pallas_lanes.py make_lane_chunk_runner and
// pallas_lanes_aligned.py make_aligned_lane_runner. Every launch covers all
// lanes, so a B-lane step costs the launches of one step (5), not B times
// as many; sg_chunk_run is its B = 1 case.
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
  T *u, *v, *p, *au, *av, *ap, *bu, *bv, *bp, *omega, *part, *dpart, *qpart,
      *scal;
  const T *tau_u, *tau_v, *tau_p;
  __nv_bfloat16* x1s;  // x1: the bf16 state copies, sets base, A, B
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
  w.part = m(P_PART); w.dpart = m(P_DPART); w.qpart = m(P_QPART);
  w.scal = m(P_SCAL);
  w.tau_u = m(P_TAUU); w.tau_v = m(P_TAUV); w.tau_p = m(P_TAUP);
  w.x1s = static_cast<__nv_bfloat16*>(const_cast<void*>(P[P_X1S]));
  w.lanes = lanes;
  return w;
}

// The tail's partials and scalars; the caller adds where the results go.
template <typename T>
Tail<T> make_tail(const Work<T>& w) {
  Tail<T> t = {};
  t.part = w.part;
  t.nparts = w.g.nparts;
  t.qpart = w.qpart;
  t.scal = w.scal;
  t.lsc = w.o.lsc;
  t.lanes = w.lanes;
  return t;
}

// A chunk's tail of row i at global iteration idx: rows, state machine, and
// the next step's dt from the base the last stage left.
template <typename T>
Tail<T> chunk_tail(const Work<T>& w, const void* const* P, int i, int idx,
                   int warmup, double tol, int use_residual) {
  auto m = [&](int k) { return const_cast<void*>(P[k]); };
  Tail<T> t = make_tail(w);
  t.dpart = w.dpart;
  t.rows = static_cast<T*>(m(P_ROWS));
  t.row = i;
  t.idx = idx;
  t.warmup = warmup;
  t.tol = T(tol);
  t.use_residual = use_residual;
  t.flags = static_cast<int*>(m(P_FLAGS));
  t.ref_norm = static_cast<T*>(m(P_REFNORM));
  return t;
}

const double kAlphas[4] = {0.25, 1.0 / 3.0, 0.5, 1.0};

// Set k (0: the base, 1: A, 2: B) of the x1 state copies.
template <typename T>
__nv_bfloat16* x1_set(const Work<T>& w, int nf, int k) {
  return w.x1s + (size_t)k * w.lanes * x1_state_elems(nf);
}

// Where a step's dt comes from: dt_kernel on the base; scal[S_DT] as the
// previous step's tail left it (a chunk); the partials of the base that
// the previous step's last stage left in w.dpart (a smoother).
enum class Dt { KERNEL, SCAL, PARTS };

// The four RK stages from the base state (base -> A -> B -> A -> out),
// with dt from `dt`; the last stage writes the partials, and with
// `leave_parts` also the partials of the state it leaves (w.dpart).
// Without `flags` the step lands in the B buffers. With the chunk's
// `flags` it lands in the base itself, except where a lane began the step
// done. The x1 stages read and write the bf16 copies of the same buffers;
// dt rounds the base into its copy.
template <typename T>
int rk4(const Work<T>& w, int nf, bool with_tau, Dt dt, bool leave_parts,
        const int* flags, int* counts, cudaStream_t s) {
  const bool x1 = w.g.x1;
  if (dt == Dt::KERNEL) {
    SG_CHECK(launch_dt<T>(w.o, w.u, w.v, w.scal, nf, w.lanes, s,
                          x1 ? w.p : nullptr,
                          x1 ? x1_set(w, nf, 0) : nullptr));
    counts[C_DIAG] += 1;
    counts[C_DT] += 1;
  }
  const int x_in[4] = {0, 1, 2, 1};
  const int x_out[4] = {1, 2, 1, flags ? 0 : 2};
  const T* in_u[4] = {w.u, w.au, w.bu, w.au};
  const T* in_v[4] = {w.v, w.av, w.bv, w.av};
  const T* in_p[4] = {w.p, w.ap, w.bp, w.ap};
  T* out_u[4] = {w.au, w.bu, w.au, flags ? w.u : w.bu};
  T* out_v[4] = {w.av, w.bv, w.av, flags ? w.v : w.bv};
  T* out_p[4] = {w.ap, w.bp, w.ap, flags ? w.p : w.bp};
  for (int st = 0; st < 4; ++st) {
    StageArgs<T> a = {};
    a.u_in = in_u[st]; a.v_in = in_v[st]; a.p_in = in_p[st];
    a.u0 = w.u; a.v0 = w.v; a.p0 = w.p;
    a.u_out = out_u[st]; a.v_out = out_v[st]; a.p_out = out_p[st];
    a.tau_u = with_tau ? w.tau_u : nullptr;
    a.tau_v = with_tau ? w.tau_v : nullptr;
    a.tau_p = with_tau ? w.tau_p : nullptr;
    a.scal = w.scal;
    a.alpha = T(kAlphas[st]);
    a.part = st == 3 ? w.part : nullptr;
    a.flags = st == 3 ? flags : nullptr;
    a.dpart = st == 3 && leave_parts ? w.dpart : nullptr;
    a.dt_part = st == 0 && dt == Dt::PARTS ? w.dpart : nullptr;
    a.x1_in = x1 ? x1_set(w, nf, x_in[st]) : nullptr;
    a.x1_out = x1 ? x1_set(w, nf, x_out[st]) : nullptr;
    SG_CHECK(launch_stage<T>(w.o, a, nf, w.lanes, w.g, s));
    if (w.g.x1)
      counts[C_STAGE_X1] += 1;
    else
      counts[C_STAGE] += 1;
  }
  return 0;
}

// The six metrics of the state in the B buffers, in one tail launch.
template <typename T>
int metrics_tail(const Work<T>& w, const void* const* P, int nf,
                 int tail_blocks, int* counts, cudaStream_t s) {
  Tail<T> t = make_tail(w);
  t.metrics = static_cast<T*>(const_cast<void*>(P[P_METRICS]));
  SG_CHECK(launch_tail<T>(w.o, w.bu, w.bv, w.omega, t, nf, 1, tail_blocks,
                          s));
  counts[C_DIAG] += 1;
  return 0;
}

template <typename T>
int step_run(const void* const* P, int nf, const int* geo, int with_tau,
             int tail_blocks, int* counts, cudaStream_t s) {
  Work<T> w = make_work<T>(P, 1);
  SG_CHECK(stage_geometry(geo, nf, sizeof(T), 0, &w.g));
  int rc = rk4<T>(w, nf, with_tau != 0, Dt::KERNEL, false, nullptr, counts,
                  s);
  if (rc) return rc;
  return metrics_tail(w, P, nf, tail_blocks, counts, s);
}

template <typename T>
int smooth_run(const void* const* P, int nf, const int* geo, int n_steps,
               int with_tau, int tail_blocks, int* counts, cudaStream_t s) {
  Work<T> w = make_work<T>(P, 1);
  SG_CHECK(stage_geometry(geo, nf, sizeof(T), 0, &w.g));
  // the tree that reduces the partials (warp_tree) takes this many
  if (w.g.nparts > TREE_PASSES * RED_THREADS)
    return (int)cudaErrorInvalidValue;
  auto m = [&](int k) { return static_cast<T*>(const_cast<void*>(P[k])); };
  T* const outs[2][3] = {{w.bu, w.bv, w.bp}, {m(P_CU), m(P_CV), m(P_CP)}};
  Work<T> wi = w;  // step i: base = step i-1's output (the input for i = 0)
  for (int i = 0; i < n_steps; ++i) {
    T* const* o = outs[(n_steps - 1 - i) % 2];
    wi.bu = o[0]; wi.bv = o[1]; wi.bp = o[2];
    // dt: the kernel at the first step, then the previous step's partials
    int rc = rk4<T>(wi, nf, with_tau != 0, i == 0 ? Dt::KERNEL : Dt::PARTS,
                    i + 1 < n_steps, nullptr, counts, s);
    if (rc) return rc;
    wi.u = wi.bu; wi.v = wi.bv; wi.p = wi.bp;
  }
  return metrics_tail(w, P, nf, tail_blocks, counts, s);
}

template <typename T>
int chunk_run(const void* const* P, int nf, const int* geo, int lanes,
              int chunk, int start_iter, int warmup, int metrics_every,
              int use_residual, double tol, int x1, int tail_blocks,
              int* counts, cudaStream_t s) {
  Work<T> w = make_work<T>(P, lanes);
  SG_CHECK(stage_geometry(geo, nf, sizeof(T), x1, &w.g));
  if (x1 && (!w.o.x1b || !w.o.x1ops || !w.x1s))
    return (int)cudaErrorInvalidValue;
  const int* flags = static_cast<const int*>(P[P_FLAGS]);
  for (int i = 0; i < chunk; ++i) {
    const int idx = start_iter + i;
    // dt at the chunk's first step; later steps take it from the tail
    int rc = rk4<T>(w, nf, false, i == 0 ? Dt::KERNEL : Dt::SCAL, true,
                    flags, counts, s);
    if (rc) return rc;
    Tail<T> t = chunk_tail(w, P, i, idx, warmup, tol, use_residual);
    t.x1 = x1;
    // the aligned kernel's cadence: the first step of every chunk and
    // every metrics_every-th global iteration (one decision for all lanes)
    if (i == 0 || idx % metrics_every == 0) {
      SG_CHECK(launch_tail<T>(w.o, w.u, w.v, w.omega, t, nf, lanes,
                              tail_blocks, s));
      counts[x1 ? C_DIAG_X1 : C_DIAG] += 1;
    } else {
      SG_CHECK(launch_control<T>(t, nf, lanes, s));
      counts[C_CONTROL] += 1;
    }
  }
  return 0;
}

// The chunk of chunk_run in ONE launch of the resident kernel
// (sg_resident.cu), on the same pointer table: the same state, rows, flags
// and residual normalization, bit for bit, at the orders and dtypes where
// resident_geometry exists; the stage geometry `geo` fixes the tiles it
// computes.
template <typename T>
int resident_run(const void* const* P, int nf, const int* geo, int lanes,
                 int chunk, int start_iter, int warmup, int metrics_every,
                 int use_residual, double tol, int* counts, cudaStream_t s) {
  Work<T> w = make_work<T>(P, lanes);
  SG_CHECK(stage_geometry(geo, nf, sizeof(T), 0, &w.g));
  ResidentGeo r;
  SG_CHECK(resident_geometry(nf, sizeof(T), w.g, &r));
  if (chunk < 1) return 0;
  auto m = [&](int k) { return const_cast<void*>(P[k]); };
  ResArgs<T> a = {};
  a.u = w.u; a.v = w.v; a.p = w.p;
  a.rows = static_cast<T*>(m(P_ROWS));
  a.ref_norm = static_cast<T*>(m(P_REFNORM));
  a.flags = static_cast<int*>(m(P_FLAGS));
  a.nf = nf; a.lanes = lanes; a.chunk = chunk; a.start_iter = start_iter;
  a.warmup = warmup; a.metrics_every = metrics_every;
  a.use_residual = use_residual; a.tol = T(tol);
  a.cluster = r.cluster; a.sub = r.sub;
  SG_CHECK(launch_resident<T>(w.o, a, r, s));
  counts[C_RESIDENT] += 1;
  return 0;
}

// Timing aid: `reps` launches of one kernel group on a chunk workspace of
// `lanes` lanes (0: one last stage of a chunk step, out of place into the
// B buffers, with the base's partials; 1: dt; 2: a sampled step's tail;
// 3: an unsampled step's control), the x1 instances with x1; the x1 stage
// reads the bf16 copy of the A buffers, which one launch rounds first, and
// the x1 dt rounds the base into its copy (the x1 chunk's first launch).
// Not part of any solve.
template <typename T>
int bench_run(const void* const* P, int nf, const int* geo, int lanes,
              int which, int reps, int x1, int tail_blocks, cudaStream_t s) {
  Work<T> w = make_work<T>(P, lanes);
  SG_CHECK(stage_geometry(geo, nf, sizeof(T), x1, &w.g));
  if (x1 && (!w.o.x1b || (which == 1 && !w.x1s)))
    return (int)cudaErrorInvalidValue;
  Tail<T> t = chunk_tail(w, P, 0, 0, 1 << 30, 0.0, 0);
  t.x1 = x1;
  if (which == 0 && x1) {
    if constexpr (sizeof(T) == 4) {
      if (!w.o.x1ops || !w.x1s) return (int)cudaErrorInvalidValue;
      SG_CHECK(launch_x1_round(w.au, w.av, w.ap, x1_set(w, nf, 1), nf,
                               lanes, s));
    }
  }
  for (int r = 0; r < reps; ++r) {
    if (which == 0) {
      StageArgs<T> a = {};
      a.u_in = w.au; a.v_in = w.av; a.p_in = w.ap;
      a.u0 = w.u; a.v0 = w.v; a.p0 = w.p;
      a.u_out = w.bu; a.v_out = w.bv; a.p_out = w.bp;
      a.tau_u = a.tau_v = a.tau_p = nullptr;
      a.scal = w.scal;
      a.alpha = T(1);
      a.part = w.part;
      a.flags = t.flags;
      a.dpart = w.dpart;
      a.x1_in = x1 ? x1_set(w, nf, 1) : nullptr;
      a.x1_out = x1 ? x1_set(w, nf, 2) : nullptr;
      SG_CHECK(launch_stage<T>(w.o, a, nf, lanes, w.g, s));
    } else if (which == 1) {  // with x1, rounding the base into its copy
      SG_CHECK(launch_dt<T>(w.o, w.u, w.v, w.scal, nf, lanes, s,
                            x1 ? w.p : nullptr,
                            x1 ? x1_set(w, nf, 0) : nullptr));
    } else if (which == 2) {
      SG_CHECK(launch_tail<T>(w.o, w.u, w.v, w.omega, t, nf, lanes,
                              tail_blocks, s));
    } else {
      SG_CHECK(launch_control<T>(t, nf, lanes, s));
    }
  }
  return 0;
}

}  // namespace
}  // namespace sg

extern "C" {

// dtype: 0 = float32, 1 = float64. geo: the stage geometry (G_COUNT ints,
// sg_common.cuh:GeoSlot). tail_blocks: the tail kernel's grid (the
// wrapper's ops/sg_kernels.py:tail_grid). The per-lane scalars are the
// table in the pointer table's P_LSC slot.
int sg_step_run(int dtype, int nf, const int* geo, const void* const* ptrs,
                int with_tau, int tail_blocks, int* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::step_run<double>(ptrs, nf, geo, with_tau, tail_blocks,
                                      counts, s)
               : sg::step_run<float>(ptrs, nf, geo, with_tau, tail_blocks,
                                     counts, s);
}

int sg_smooth_run(int dtype, int nf, const int* geo, const void* const* ptrs,
                  int n_steps, int with_tau, int tail_blocks, int* counts,
                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::smooth_run<double>(ptrs, nf, geo, n_steps, with_tau,
                                        tail_blocks, counts, s)
               : sg::smooth_run<float>(ptrs, nf, geo, n_steps, with_tau,
                                       tail_blocks, counts, s);
}

// x1: 1 for matmul_algorithm=x1 (float32 only; refused in float64).
int sg_lanes_chunk_run(int dtype, int nf, const int* geo, int lanes,
                       const void* const* ptrs, int chunk, int start_iter,
                       int warmup, int metrics_every, int use_residual,
                       double tol, int x1, int tail_blocks, int* counts,
                       void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::chunk_run<double>(ptrs, nf, geo, lanes, chunk,
                                       start_iter, warmup, metrics_every,
                                       use_residual, tol, x1, tail_blocks,
                                       counts, s)
               : sg::chunk_run<float>(ptrs, nf, geo, lanes, chunk,
                                      start_iter, warmup, metrics_every,
                                      use_residual, tol, x1, tail_blocks,
                                      counts, s);
}

int sg_chunk_run(int dtype, int nf, const int* geo, const void* const* ptrs,
                 int chunk, int start_iter, int warmup, int metrics_every,
                 int use_residual, double tol, int x1, int tail_blocks,
                 int* counts, void* stream) {
  return sg_lanes_chunk_run(dtype, nf, geo, 1, ptrs, chunk, start_iter,
                            warmup, metrics_every, use_residual, tol, x1,
                            tail_blocks, counts, stream);
}

// sg_lanes_chunk_run's chunk (x1 = 0) in one launch, where
// sg_resident_geometry exists; cudaErrorInvalidValue elsewhere.
int sg_resident_chunk_run(int dtype, int nf, const int* geo, int lanes,
                          const void* const* ptrs, int chunk, int start_iter,
                          int warmup, int metrics_every, int use_residual,
                          double tol, int* counts, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::resident_run<double>(ptrs, nf, geo, lanes, chunk,
                                          start_iter, warmup, metrics_every,
                                          use_residual, tol, counts, s)
               : sg::resident_run<float>(ptrs, nf, geo, lanes, chunk,
                                         start_iter, warmup, metrics_every,
                                         use_residual, tol, counts, s);
}

// The resident kernel's geometry at order nf - 1 under the stage geometry
// geo (x1 = 0): its cluster, sub-blocks and shared memory in bytes into
// out[0..2]; cudaErrorInvalidValue where a lane does not fit one cluster
// (sg_common.cuh:res_layout is the one account of its shared memory).
int sg_resident_geometry(int dtype, int nf, const int* geo, int* out) {
  const int elem = dtype ? 8 : 4;
  sg::StageGeo g;
  cudaError_t err = sg::stage_geometry(geo, nf, elem, 0, &g);
  sg::ResidentGeo r;
  if (err == cudaSuccess) err = sg::resident_geometry(nf, elem, g, &r);
  if (err != cudaSuccess) return (int)err;
  out[0] = r.cluster;
  out[1] = r.sub;
  out[2] = r.smem;
  return 0;
}

int sg_bench_run(int dtype, int nf, const int* geo, int lanes,
                 const void* const* ptrs, int which, int reps, int x1,
                 int tail_blocks, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return dtype ? sg::bench_run<double>(ptrs, nf, geo, lanes, which, reps,
                                       x1, tail_blocks, s)
               : sg::bench_run<float>(ptrs, nf, geo, lanes, which, reps, x1,
                                      tail_blocks, s);
}

// The co-resident blocks of the tail kernel of `dtype` (its x1 instance
// with x1) on the current device into *blocks (the most its cooperative
// launch may take).
int sg_tail_coresident(int dtype, int x1, int* blocks) {
  return dtype ? (int)sg::tail_coresident<double>(blocks, x1)
               : (int)sg::tail_coresident<float>(blocks, x1);
}

const char* sg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
