// Declarations shared by the Newton-Krylov kernel (nk_schur.cu) and its C
// host entries (nk_host.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace nk {

constexpr int TILE = 16;           // output tiles of 16 x 16
constexpr int NT = TILE * TILE;    // threads a block: one an element
constexpr int KS = 128;            // depth of a k slab in shared memory

// Pointer-table order (ops/nk_kernels.py:_PTR_NAMES): the ten (ni x ni)
// operators, H^{-1}'s eigenvalues, inv_dt (a 0-d device value), the
// right-hand side, the outputs x and k (int32), then the workspace.
enum Ptr {
  P_GXR, P_IYTR, P_IXR, P_GYTR, P_VXI, P_VYIT, P_VYT, P_VX, P_DXI, P_DYTI,
  P_INV_HLAM, P_INV_DT, P_B,
  P_X, P_K,
  P_R, P_P0, P_P1, P_Q, P_S, P_T,
  P_W,     // 4 x (ni x ni): [branch][ping-pong] products of the chain
  P_PART,  // tiles x PT_COUNT partial sums
  P_COUNT
};

// Partial-sum columns, one row a tile.
enum Part { PT_RR, PT_RHR, PT_RHQ, PT_SS, PT_TS, PT_TT, PT_COUNT };

struct Schur {
  int ni, nt, tiles;  // nt tiles a side, tiles = nt * nt
  int maxiter;
  double tol2, beta_sq;
  const double *Gxr, *IyTr, *Ixr, *GyTr, *Vxi, *VyiT, *VyT, *Vx, *Dxi,
      *DyTi;
  const double *inv_hlam, *inv_dt, *b;
  double *x, *r, *p[2], *q, *s, *t;
  double* w[2][2];  // [branch x / y][ping-pong]
  double* part;
  int* k;
};

cudaError_t launch_schur(const Schur& S, cudaStream_t s);

}  // namespace nk
