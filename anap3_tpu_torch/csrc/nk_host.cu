// C host entries of the Newton-Krylov kernel, loaded with ctypes by
// anap3_tpu_torch/ops/_build.py. Each enqueues its launch on the caller's
// stream, synchronizes nothing, allocates nothing (the wrapper passes every
// buffer in the pointer table, see nk_common.cuh:Ptr) and returns the first
// error that is not cudaSuccess.
#include "nk_common.cuh"

extern "C" {

// The Schur BiCGSTAB of one Stokes-preconditioner application (nk_schur.cu)
// for (ni x ni) float64 operands and the (8 x np x np) folded operator
// table; tol2 = tol * tol.
int nk_schur_run(int ni, const void* const* ptrs, double tol2, double beta_sq,
                 int maxiter, void* stream) {
  if (ni < 1 || maxiter < 0) return (int)cudaErrorInvalidValue;
  auto m = [&](int k) {
    return static_cast<double*>(const_cast<void*>(ptrs[k]));
  };
  nk::Schur S;
  S.ni = ni;
  S.nt = (ni + nk::TILE - 1) / nk::TILE;
  S.np = S.nt * nk::TILE;
  S.tiles = S.nt * S.nt;
  S.maxiter = maxiter;
  S.tol2 = tol2;
  S.beta_sq = beta_sq;
  S.ops = m(nk::P_OPS);
  S.inv_hlam = m(nk::P_INV_HLAM);
  S.inv_dt = m(nk::P_INV_DT);
  S.b = m(nk::P_B);
  S.x = m(nk::P_X);
  S.k = static_cast<int*>(const_cast<void*>(ptrs[nk::P_K]));
  S.r = m(nk::P_R); S.p[0] = m(nk::P_P0); S.p[1] = m(nk::P_P1);
  S.q = m(nk::P_Q); S.s = m(nk::P_S); S.t = m(nk::P_T);
  const size_t n2 = (size_t)S.np * S.np;
  for (int br = 0; br < 2; ++br)
    for (int lv = 0; lv < 3; ++lv) S.w[br][lv] = m(nk::P_W) + (3 * br + lv) * n2;
  S.part = m(nk::P_PART);
  return (int)nk::launch_schur(S, static_cast<cudaStream_t>(stream));
}

// The launch geometry of order ni on the current device: out[0] 1 where
// the operator bands stay in shared memory (0: streamed), out[1] the grid.
int nk_schur_geometry(int ni, int* out) {
  if (ni < 1) return (int)cudaErrorInvalidValue;
  return (int)nk::schur_geometry(ni, out, out + 1);
}

const char* nk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
