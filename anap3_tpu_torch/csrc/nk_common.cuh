// Declarations shared by the Newton-Krylov kernel (nk_schur.cu) and its C
// host entries (nk_host.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace nk {

constexpr int TILE = 16;           // output tiles of 16 x 16
constexpr int NT = TILE * TILE;    // threads a block: one an element
constexpr int WARPS = NT / 32;
constexpr int KS = 128;            // depth of a k slab in shared memory

// The folded operators, in the order of their (np x np) slices of the
// zero-padded table (ops/nk_kernels.py:_FOLDED).
enum Op { O_LX, O_LY, O_RX, O_RY, O_CX, O_VX, O_VYT, O_EY, O_COUNT };

// Pointer-table order (ops/nk_kernels.py:_PTR_NAMES): the folded operator
// table, H^{-1}'s eigenvalues, inv_dt (a 0-d device value), the right-hand
// side, the outputs x and k (int32), then the workspace.
enum Ptr {
  P_OPS, P_INV_HLAM, P_INV_DT, P_B,
  P_X, P_K,
  P_R, P_P0, P_P1, P_Q, P_S, P_T,
  P_W,     // 6 x (np x np): [branch][level 1-3] products of an S-apply
  P_PART,  // tiles x PT_COUNT partial sums
  P_COUNT
};

// Partial-sum columns, one row a tile.
enum Part { PT_RR, PT_RHR, PT_RHQ, PT_SS, PT_TS, PT_TT, PT_COUNT };

struct Schur {
  int ni, np, nt, tiles;  // np = nt * TILE, tiles = nt * nt
  int maxiter;
  double tol2, beta_sq;
  const double* ops;  // O_COUNT x (np x np), zero beyond ni
  const double *inv_hlam, *inv_dt, *b;  // (ni x ni), inv_dt 0-d
  double* x;                            // (ni x ni)
  double *r, *p[2], *q, *s, *t;         // (np x np), kept zero beyond ni
  double* w[2][3];                      // [branch x / y][level 1-3]
  double* part;
  int* k;
};

cudaError_t launch_schur(const Schur& S, cudaStream_t s);
cudaError_t schur_geometry(int ni, int* resident, int* grid);

}  // namespace nk
