#!/usr/bin/env python3
"""What each step of the Schur kernel's design buys, on one CUDA card: the
kernel against copies of itself with one step taken out.

Usage (from the repository root, on a machine with a card; ~2 min):

    python3 scripts/nk_schur_steps.py

Each variant is the kernel's source (``csrc/nk_schur.cu``) with one text
patch, built with the repository's nvcc flags into
``build/nk_steps/<variant>/`` and loaded in place of the kernel library:

- ``streamed``: the operator bands streamed from L2 at every order (the
  resident geometry never taken);
- ``fma``: the tile products as per-thread FMA chains out of shared
  memory, with the same k blocks a warp (each lane 8 elements of the tile),
  instead of f64 ``mma.sync``;
- ``trees``: the block and tile sums as 8-level ``__syncthreads`` trees
  (one tree a sum) instead of warp shuffles.

``sum_orders`` patches the tile products' sum order the same way, for
``scripts/nk_accuracy.py --variants``.

The fold (15 to 9 grid barriers an iteration) has no variant here: the
parent's kernel is the unfolded one (``scripts/nk_schur_ab.py``).

Prints the card's name and power limit, then for each variant at N = 96,
128 and 256 (the sharp lid at Re=1000, dt 1: ``chip_smoke.nk_system``) the
us an iteration at the default budget 40 (CUDA events over 20 solves
after one), and the variant's relative distance from the kernel at budget
8 (they differ only in sum order).
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from anap3_tpu_torch.ops import _build  # noqa: E402
from anap3_tpu_torch.ops import nk_kernels as nk  # noqa: E402

ORDERS = (96, 128, 256)

FMA_SLAB = '''__device__ __forceinline__ void mma_slab(double (&acc)[2][2][2],
                                         const double* A, const double* B,
                                         int kn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int steps = kn / 4, per = (steps + WARPS - 1) / WARPS;
  const int lo = warp * per * 4, hi = min(kn, lo + per * 4);
  for (int k = lo; k < hi; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = lane + 32 * j;
      double& a = acc[j >> 2][(j >> 1) & 1][j & 1];
      a = fma(A[(e / TILE) * SA + k], B[k * SB + e % TILE], a);
    }
  }
}
'''

FMA_WRITE = '''#pragma unroll
  for (int j = 0; j < 8; ++j)
    cb[warp * NT + lane + 32 * j] = acc[j >> 2][(j >> 1) & 1][j & 1];
  (void)g;
  (void)t;
'''

TREES = '''template <bool RES>
__device__ __forceinline__ void block_partial(double* row, int c0, double v0,
                                              int c1, double v1) {
  double* red = smem + Lay<RES>::RED;
  const int tid = threadIdx.x;
  __syncthreads();
  red[tid] = v0;
  red[NT + tid] = v1;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[tid] += red[tid + s];
      red[NT + tid] += red[NT + tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    row[c0] = red[0];
    if (c1 >= 0) row[c1] = red[NT];
  }
}

template <bool RES>
__device__ __forceinline__ double tile_sum_tree(const Schur& S, int c) {
  double* red = smem + Lay<RES>::RED + 2 * NT;
  const int tid = threadIdx.x;
  __syncthreads();
  double a = 0.0;
  for (int t = tid; t < S.tiles; t += NT)
    a += S.part[(size_t)t * PT_COUNT + c];
  red[tid] = a;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  return red[0];
}
'''


def patch(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"patch target not found: {old[:60]!r}")
    return src.replace(old, new)


def cut(src: str, start: str, end: str, new: str) -> str:
    """src with the text from ``start`` up to ``end`` replaced by new."""
    i = src.index(start)
    return src[:i] + new + src[src.index(end, i):]


def variants(src: str) -> dict:
    out = {"streamed": patch(src, "if (nt * TILE <= KS) {", "if (false) {")}
    fma = cut(src, "__device__ __forceinline__ void mma_slab(",
              "__device__ __forceinline__ void zero(", FMA_SLAB + "\n")
    out["fma"] = cut(fma, "#pragma unroll\n  for (int m = 0; m < 2; ++m)\n"
                     "#pragma unroll\n    for (int n = 0; n < 2; ++n) {\n"
                     "      double* at", "  __syncthreads();\n  double sum",
                     FMA_WRITE)
    trees = cut(src, "template <bool RES>\n__device__ __forceinline__ void "
                "block_partial(", "// p = r + beta", TREES + "\n")
    trees = patch(trees, "static constexpr int SIZE = RED + 2 * WARPS;",
                  "static constexpr int SIZE = RED + 3 * NT;")
    out["trees"] = re.sub(r"\btile_sum\(S, ", "tile_sum_tree<RES>(S, ",
                          trees)
    return out


# The sum orders of the tile products (scripts/nk_accuracy.py --variants):
# the kernel takes k in contiguous blocks over the warps and sums the warp
# partials compensated; "interleaved" gives warp w the k steps w, w + 8, ...;
# "plain-sum" sums the partials without the TwoSum term; "first" (the first
# design) does both.
K_BLOCKS = ("  const int lo = warp * per, hi = min(steps, lo + per);\n"
            "  for (int ks = lo; ks < hi; ++ks) {")
K_INTERLEAVED = ("  (void)per;\n"
                 "  for (int ks = warp; ks < steps; ks += WARPS) {")
SUM_COMPENSATED = "  return __dadd_rn(sum, err);"
SUM_PLAIN = "  (void)err;\n  return sum;"


def sum_orders(src: str) -> dict:
    inter = patch(src, K_BLOCKS, K_INTERLEAVED)
    return {"interleaved": inter,
            "plain-sum": patch(src, SUM_COMPENSATED, SUM_PLAIN),
            "first": patch(inter, SUM_COMPENSATED, SUM_PLAIN)}


def load(name: str, src: str):
    """The nk library with ``src`` in place of csrc/nk_schur.cu, built into
    build/nk_steps/<name>/ and bound as _build binds it; and the registers
    ptxas reports."""
    out = ROOT / "build" / "nk_steps" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "nk_schur.cu").write_text(src)
    lib_path = out / "libnkkernels.so"
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(lib_path), str(out / "nk_schur.cu"),
         str(_build.CSRC / "nk_host.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    regs = re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(lib_path))
    _build._BIND["nk"](lib)
    return lib, regs


def main() -> int:
    if not torch.cuda.is_available():
        print("nk_schur_steps: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    systems = {n: cs.nk_system(n, "singular", 1.0) for n in ORDERS}
    kernel = nk._lib()
    ref = {n: nk.schur_kernel(pre.schur, rhs, inv_dt, inv_hlam, 1e-8, 8)[0]
           for n, (pre, rhs, inv_dt, inv_hlam) in systems.items()}
    src = (_build.CSRC / "nk_schur.cu").read_text()
    libs = {"kernel": (kernel, [])}
    for name, text in variants(src).items():
        libs[name] = load(name, text)
    try:
        for name, (lib, regs) in libs.items():
            nk._lib = lambda lib=lib: lib
            line = []
            for n, (pre, rhs, inv_dt, inv_hlam) in systems.items():
                def solve(budget=40):
                    return nk.schur_kernel(pre.schur, rhs, inv_dt, inv_hlam,
                                           1e-8, budget)
                k = int(solve()[1])
                ms = cs.cuda_ms(solve, 20)
                err = cs.norm_rel(solve(8)[0], ref[n])
                line.append(f"N={n} {ms / k * 1e3:.2f} us an iteration "
                            f"({k} iterations; budget 8 from the kernel "
                            f"{err:.2e})")
            print(f"[steps] {name}{' registers ' + '/'.join(regs) if regs else ''}"
                  f": " + "; ".join(line), flush=True)
    finally:
        nk._lib = lambda: kernel
    return 0


if __name__ == "__main__":
    sys.exit(main())
