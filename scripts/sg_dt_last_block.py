#!/usr/bin/env python3
"""Make a copy of this checkout's port whose smoother takes each step's dt
from the last block of the last stage, the design not taken, so that
``scripts/sg_tail_ab.py`` can time it beside the tree's.

    python3 scripts/sg_dt_last_block.py build/dt_last_block
    python3 scripts/sg_tail_ab.py build/parent . build/dt_last_block . build/parent

The copy is ``anap3_tpu_torch/`` under the given directory (listed in
.gitignore when under ``build/``), with three text patches of its CUDA
sources:

- the tree: every smoother step after the first reduces the maxima of the
  partials the previous step's last stage left in its FIRST stage, in
  every block, while the first slab is in flight (``StageArgs::dt_part``);
- the copy: the LAST stage of every smoother step but the last reduces
  them, in the one block of each lane that finishes last: each block's
  thread 0 writes its partials, fences (``__threadfence``) and draws a
  ticket (``atomicAdd`` on an int in the lane's unused ``scal[S_E]``
  slot, reset by the kernel itself); the block that draws nparts - 1
  reads every block's partials from L2 and writes ``scal[S_DT]``, which
  the next step's stages read.

Both take the maxima of the same partials and dt_of's arithmetic, so the
copy's states keep the tree's bits.
"""

import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PATCHES = (
    ("csrc/sg_common.cuh",
     "  const T* dt_part;\n",
     "  const T* dt_part;\n"
     "  // the lane tickets: scal (lane 0's); an int in each lane's S_E slot\n"
     "  T* dt_ticket;\n"),
    ("csrc/sg_host.cu",
     "    a.dt_part = st == 0 && dt == Dt::PARTS ? w.dpart : nullptr;\n",
     "    a.dt_part = nullptr;  // the next step's dt: the last block's\n"
     "    a.dt_ticket = st == 3 && leave_parts && !flags ? w.scal : nullptr;\n"),
    ("csrc/sg_stage.cu",
     "  cluster_wait();  // no block leaves while a peer may read its slices\n"
     "}\n",
     "  if (a0.dt_ticket) {  // the last block of the lane sets the next dt\n"
     "    int* tk = reinterpret_cast<int*>(a0.dt_ticket +\n"
     "                                     (size_t)lane * S_COUNT + S_E);\n"
     "    if (tid == 0) {\n"
     "      __threadfence();  // this block's partials, before its ticket\n"
     "      red[0] = atomicAdd(tk, 1) == g.nparts - 1 ? T(1) : T(0);\n"
     "    }\n"
     "    __syncthreads();\n"
     "    if (red[0] != T(0) && tid < 32) {\n"
     "      const T* dl = a0.dpart + (size_t)lane * g.nparts * NDPART;\n"
     "      T um = T(0), vm = T(0);\n"
     "      for (int b = tid; b < g.nparts; b += 32) {\n"
     "        um = nan_max(um, __ldcg(dl + (size_t)b * NDPART));\n"
     "        vm = nan_max(vm, __ldcg(dl + (size_t)b * NDPART + 1));\n"
     "      }\n"
     "      for (int off = 16; off > 0; off >>= 1) {\n"
     "        um = nan_max(um, __shfl_down_sync(0xffffffffu, um, off));\n"
     "        vm = nan_max(vm, __shfl_down_sync(0xffffffffu, vm, off));\n"
     "      }\n"
     "      if (tid == 0) {\n"
     "        a0.scal[(size_t)lane * S_COUNT + S_DT] =\n"
     "            dt_of(um, vm, o0.lsc + (size_t)lane * H_COUNT);\n"
     "        *tk = 0;\n"
     "      }\n"
     "    }\n"
     "  }\n"
     "  cluster_wait();  // no block leaves while a peer may read its slices\n"
     "}\n"),
)


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    out = Path(argv[0]).resolve() / "anap3_tpu_torch"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(ROOT / "anap3_tpu_torch", out,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name, old, new in PATCHES:
        path = out / name
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: patch target found "
                               f"{text.count(old)} times: {old[:60]!r}")
        path.write_text(text.replace(old, new))
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
