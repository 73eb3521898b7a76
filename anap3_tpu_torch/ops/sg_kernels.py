"""Wrappers of the hand-written SG CUDA kernels, each beside its plain
PyTorch version.

``csrc/`` holds three kernels (sg_stage.cu, sg_diag.cu, sg_control.cu; see
the note at the top of each) and the C host entries (sg_host.cu) that this
module calls through ``ctypes``:

- ``make_sg_step(ops, with_tau=False)`` has the contract of
  ``anap3_tpu/ops/pallas_tiled.py:make_tiled_sg_step``:
  ``step(state[, tau]) -> (state, metrics)`` with the six metric keys.
- ``make_sg_chunk_runner(ops, chunk, tol, warmup, convergence_metric,
  metrics_every)`` has the contract of ``make_aligned_chunk_runner`` /
  ``make_tiled_chunk_runner``: ``chunk_fn(state, start_iter, ref_norm) ->
  (state, done, conv_iter, converged, rows[chunk, 7], ref_norm)``, rows in
  runner.METRIC_KEYS order and in the working dtype. With
  ``metrics_every=1`` the rows are those of
  ``anap3_tpu/ops/pallas_chunk.py:make_pallas_chunk_runner`` (the x6 chunk,
  quadratures every step).
- ``make_sg_smoother(ops)`` is the FAS smoothing loop of a
  V-cycle level: ``smooth(state, tau, n_steps) -> (state, metrics)``,
  ``n_steps`` steps of ``anap3_tpu/ops/pallas_aligned.py:
  make_aligned_tau_step`` (tau, when given, added to every stage residual)
  with the metrics of the last step, in one host entry (sg_smooth_run).

Dispatch is by the state's device and nothing else: a CPU tensor takes the
plain version; a CUDA tensor launches the kernels or raises (a failed build
or launch is an error, never a fall-back).

The kernels take B lanes per launch (``ops/sg_lane_kernels.py`` runs sweep
lanes through them); the wrappers here are the B = 1 case. The scalars of
the operators (nu, beta^2, CFL, lid, 1/dx, 1/dy) reach the kernels as a
device table in the working dtype (``scalar_table``), built once per
wrapper.

Cadence of the chunk rows: the quadratures (energy, enstrophy,
palinstrophy) are computed on the first step of a chunk and on every step
whose global index is a multiple of ``metrics_every`` (the aligned kernel's
rule); other rows hold the last sampled values. The residual-norm columns
are exact on every step, because their partial sums come out of the last
RK stage anyway; the JAX aligned kernel holds them between samples unless
the residual criterion is on.

Launch geometry: ``stage_geometry(nf, dtype, lanes)`` chooses the stage
kernel's tile, cluster, k groups, shared memory and k-slab ring for an
order, and every host entry takes it as an int array
(``csrc/sg_common.cuh:GeoSlot``), so the CPU tests check each geometry the
card will launch. The kernels take every order up to ``MAX_KERNEL_N`` =
767 (a row band of at most 16 blocks of 48 columns; above N = 383 in a
non-portable cluster, which the stage launcher checks the card can
schedule before its first launch); ``stage_geometry`` raises above it,
and the solvers route such a level to the plain step by design
(``models/spectral.py:make_fused_paths``).

The step's tail: the last stage of a chunk step writes the step into the
chunk's state in place (not where a lane began the step done) and sums the
base it leaves; then one launch finishes the step: ``control_kernel``
(sg_control.cu) on an unsampled step, or on a sampled one ``tail_kernel``
(sg_diag.cu), the quadratures and the same finish in one cooperative launch
of ``tail_grid(nf, lanes, co-resident blocks)`` blocks. The finish sets the
next step's dt, so ``dt_kernel`` runs at a chunk's first step only. A
chunk is ``chunk_launches(chunk, start_iter, metrics_every)`` launches; a
step is dt, four stages and the tail kernel; the smoother dt, four stages
a step, then the tail kernel: its last stage of a step leaves the
partials of the next step's base, and the next step's first stage takes
dt from their maxima, so ``smoother_launches(n)`` is 4 n + 2.
``dt_kernel`` is one thread-block cluster a lane (csrc/sg_diag.cu);
``base_parts`` and ``dt_from_parts`` are the plain versions of the
partials and of dt from them.

The resident chunk: where a lane's operators and state fit one
thread-block cluster's shared memory (``resident_geometry``: float32 to
N = 51, float64 to N = 31, no x1), a chunk is ONE launch of
csrc/sg_resident.cu's kernel (``sg_resident_chunk_run``), which marches
every step in shared memory and leaves the multi-launch chunk's state,
rows, flags and residual normalization bit for bit;
``chunk_launches(..., resident=True)`` is its plan, one launch a chunk.
The chunk runners take it wherever that geometry exists, and the
multi-launch chunk elsewhere; nothing else selects it.

matmul_algorithm=x1: ``make_sg_chunk_runner(..., x1=True)`` (float32
only) runs the chunk with every product as one bf16 tensor-core pass, the
semantics of ``anap3_tpu/ops/pallas_aligned.py:make_aligned_chunk_runner``
with ``algorithm="x1"`` on its bordered core (the x1 instances of the
stage and tail kernels; see the note in csrc/sg_stage.cu). The x1 stage
reads bf16 operands only: the operator table of ``x1_operator_table``,
made once a run, and a bf16 copy of the state (``x1_state_copy`` is its
plain version) that the launch writing the state writes beside it
(``x1_workspace`` holds the pointer-table entries). Its plain
version is ``chunk_plain(..., hi=x1_operators(ops))``: the same roundings
(``bf16_round``) with float32 matmuls of the rounded operands, which are
exact products, so only the sum order differs from the kernel's.
``x1_supported`` is the JAX package's aligned tier, the orders where x1
applies; the step and the smoother have no x1 mode.

Launch counts: ``LAUNCHES`` counts the kernel launches the wrappers made,
by kernel (sg_stage: one per RK stage; sg_diag: dt and the tail kernel;
sg_control: the unsampled control; sg_stage_x1 and sg_diag_x1: the x1
stage and x1 tail launches; sg_resident: the resident chunks);
``PART_LAUNCHES`` counts dt_kernel's alone (also in sg_diag's);
``PLAIN_CALLS`` counts calls of the plain versions.
``STEPS["sg_chunk"]`` counts the steps the chunk runners were asked to
march, kernel and plain path alike (a done state marches frozen to the
chunk's end). ``SMOOTH_STEPS`` counts the steps each call of a smoother
(``make_sg_smoother``) was asked for, kernel and plain path alike, keyed
by the level's order N; it is a table of its own, apart from ``STEPS``,
whose sum counts chunk steps only. ``reset_counts()`` zeroes the first
four and empties ``SMOOTH_STEPS``.
"""

from __future__ import annotations

import ctypes
import functools
from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from ..models import spectral_sg as core
from ..models.runner import WARMUP_ITERS, control_step, freeze, rel_change
from ..models.spectral_sg import SpectralOps, SpectralState

__all__ = ["make_sg_step", "make_sg_chunk_runner", "make_sg_smoother",
           "step_plain", "chunk_plain", "smooth_plain", "LAUNCHES",
           "EXACT_KERNELS", "X1_KERNELS", "X1Operators", "x1_operators",
           "x1_supported", "MAX_X1_N", "bf16_round", "x1_residuals",
           "x1_rk4_step", "x1_conserved_quantities", "stage_x1_plain",
           "x1_border_table", "x1_step_stages", "tc_matmul",
           "x1_operator_table", "x1_state_copy", "x1_workspace",
           "PLAIN_CALLS", "reset_counts", "ALIGNED_METRICS_EVERY", "KERNELS",
           "bench_kernel", "chunk_workspace", "scalar_table", "chunk_body",
           "stage_geometry", "StageGeometry", "MAX_KERNEL_N", "tail_grid",
           "tail_block_items", "MAX_TAIL_ITEMS", "chunk_launches",
           "smoother_launches", "BENCH_GROUPS", "PARTS", "PART_LAUNCHES",
           "base_parts", "dt_from_parts", "STEPS", "SMOOTH_STEPS",
           "resident_geometry", "ResidentGeometry"]

# quadratures every 16th step, the production cadence of the aligned kernel
ALIGNED_METRICS_EVERY = 16

# the exact kernels, the x1 instances, then the resident chunk
# (csrc/sg_common.cuh:Count)
EXACT_KERNELS = ("sg_stage", "sg_diag", "sg_control")
X1_KERNELS = ("sg_stage_x1", "sg_diag_x1")
KERNELS = EXACT_KERNELS + X1_KERNELS + ("sg_resident",)
# the orders where matmul_algorithm=x1 applies: the JAX package's aligned
# tier (anap3_tpu/ops/pallas_aligned.py:aligned_supported, the same cap
# for both lids)
MAX_X1_N = 320
# the timed launch groups of bench_kernel (csrc/sg_host.cu:bench_run)
BENCH_GROUPS = ("sg_stage", "dt", "tail", "sg_control")
LAUNCHES = {k: 0 for k in KERNELS}
# a kernel's launches counted apart from its counter's
# (csrc/sg_common.cuh:C_DT, after the KERNELS counts)
PARTS = ("dt_kernel",)
PART_LAUNCHES = {k: 0 for k in PARTS}
PLAIN_CALLS = {"sg_step": 0, "sg_chunk": 0, "sg_smooth": 0}
# steps asked of the chunk runners: a chunk's n, once per call
STEPS = {"sg_chunk": 0}
# steps asked of the smoothers, by the level's order N: a sweep's n_steps,
# once per call
SMOOTH_STEPS = {}

# pointer-table order of csrc/sg_common.cuh:Ptr
_PTR_NAMES = (
    "Dx", "DyT", "Dxx", "DyyT", "Ix", "IyT", "Gx", "GyT", "bc_u", "bc_v",
    "W2d", "sing_u", "sing_v", "sing_dudx", "sing_dudy", "sing_dvdx",
    "sing_dvdy", "sing_w", "sing_dwx", "sing_dwy",
    "u", "v", "p", "au", "av", "ap", "bu", "bv", "bp",
    "omega", "part", "dpart", "qpart", "scal", "tau_u", "tau_v", "tau_p",
    "metrics", "rows", "flags", "ref_norm", "cu", "cv", "cp", "lsc", "x1b",
    "x1ops", "x1s")
_OP_NAMES = _PTR_NAMES[:20]
_STEP_KEYS = ("u_eq", "v_eq", "continuity", "energy", "enstrophy",
              "palinstrophy")
_NPART, _NDPART, _NQPART, _NSCAL = 5, 4, 3, 6  # csrc/sg_common.cuh
_TILE = 16  # the quadrature tiles (csrc/sg_common.cuh:TILE)
# (tile, lane) items a block of the tail kernel may take
# (csrc/sg_common.cuh:MAX_TAIL_ITEMS)
MAX_TAIL_ITEMS = 128
# csrc/sg_common.cuh: STAGE_TM, STAGE_RM, STAGE_RN, MAX_CLUSTER,
# MAX_CLUSTER_NP, MAX_SMEM, GeoSlot
STAGE_TM, STAGE_RM, STAGE_RN, MAX_CLUSTER, MAX_SMEM = 8, 2, 2, 8, 232448
MAX_CLUSTER_NP = 16  # a non-portable cluster, 48-wide tiles only
_GEO_SLOTS = ("tn", "cluster", "rows", "ks", "depth", "smem", "nparts",
              "ksplit")
_STAGE_TNS = (16, 32, 48)
_KSPLITS = (1, 2, 4, 8)


def stage_group_threads(tn: int) -> int:
    """Threads of one k group (csrc/sg_common.cuh:stage_group_threads)."""
    return (STAGE_TM // STAGE_RM) * (tn // STAGE_RN)


def stage_max_threads(elem: int, tn: int) -> int:
    """The stage kernel's launch bound for elements of ``elem`` bytes and
    ``tn`` columns (csrc/sg_common.cuh:stage_max_threads)."""
    return (384 if elem == 4 else 192) if tn == 48 else 256


class StageGeometry(NamedTuple):
    """The stage kernel's launch geometry at one order and dtype (slots
    ``tn`` .. ``ksplit`` in ``csrc/sg_common.cuh:GeoSlot`` order, then the
    derived launch shape)."""
    tn: int        # output columns of a block (rows: STAGE_TM)
    cluster: int   # blocks of a row band = grid x
    rows: int      # row bands = grid y
    ks: int        # k-slab width (>= nf: the whole band in one slab)
    depth: int     # ring slots
    smem: int      # dynamic shared memory of a block, bytes
    nparts: int    # last-stage partial-sum blocks a lane
    ksplit: int    # warp groups that share each contraction
    threads: int   # threads of a block
    grid: tuple    # (x, y) blocks a lane

    def as_c(self):
        """The int array the C entries take."""
        return (ctypes.c_int * len(_GEO_SLOTS))(
            *(getattr(self, k) for k in _GEO_SLOTS))


def _stage_smem_elems(nf: int, tn: int, ks: int, depth: int,
                      ksplit: int) -> int:
    """Shared memory of a stage block in elements, as
    csrc/sg_stage.cu:stage_smem_elems lays it out: its own Gx p / Ix p
    slices, the gathered bands (nip = (nf - 2) | 1 rows of 8), the k
    groups' reduction (32 sums a thread) or the warps' partial sums (of
    the stage and of the base a chunk step leaves), then
    ``depth`` ring slots of the largest phase's slab (4 row bands and 4
    column bands)."""
    nip = (nf - 2) | 1
    nt0 = stage_group_threads(tn)
    red = max((ksplit - 1) * 32 * nt0,
              ksplit * nt0 // 32 * (_NPART + _NDPART))
    red += red % 2
    slot = 4 * ks * STAGE_TM + 4 * ks * tn
    return 2 * STAGE_TM * tn + 2 * STAGE_TM * nip + red + depth * slot


def _x1_k16(k: int) -> int:
    """k rounded up to whole mma k steps (csrc/sg_common.cuh:x1_k16)."""
    return (k + 15) & ~15


def _x1_kp(k: int) -> int:
    """A bf16 band row of the x1 stage (csrc/sg_common.cuh:x1_kp)."""
    return _x1_k16(k) + 8


# copy groups of the x1 stage (csrc/sg_stage.cu:X1_GROUPS): phase 1's, the
# left and right velocity products', phase 3's columns
_X1_GROUPS = 4


def _x1_group_elems(g: int, nf: int, tn: int) -> int:
    """bf16 elements of x1 copy group ``g`` (csrc/sg_stage.cu:
    x1_group_elems)."""
    k1, k2, tm = _x1_k16(nf - 2), _x1_k16(nf - 1), STAGE_TM
    kp1, kp2, tp = k1 + 8, k2 + 8, tn + 8
    return (2 * tm * kp1 + k1 * tp, 2 * tm * kp2 + 2 * k2 * tp,
            2 * tn * kp2 + 2 * tm * kp2, 2 * tn * kp1)[g]


def _stage_x1_smem_bytes(nf: int, tn: int, ksplit: int, depth: int) -> int:
    """Shared memory of an x1 stage block in bytes, as
    csrc/sg_stage.cu:stage_x1_smem_bytes lays it out: float32, the block's
    Gx p / Ix p slices, the warps' partial sums, the stash of the ten
    products and the corner; bf16, the rounded slices, the gathered rows,
    then ``depth`` regions of the four copy groups (group g in region
    g % depth, each region its largest group's size)."""
    red = (ksplit * stage_group_threads(tn) // 32 * (_NPART + _NDPART)
           + 3) & ~3
    f32 = 12 * STAGE_TM * tn + red + 4
    b16 = 2 * STAGE_TM * tn + 2 * STAGE_TM * _x1_kp(nf - 2)
    b16 += sum(max(_x1_group_elems(g, nf, tn)
                   for g in range(r, _X1_GROUPS, depth))
               for r in range(depth))
    return 4 * f32 + 2 * b16


def x1_supported(n: int) -> bool:
    """True where matmul_algorithm=x1 applies at order ``n``: the JAX
    package's aligned tier, N % 8 == 0 and 32 <= N <= 320 (the same cap
    for both lids)."""
    return n % 8 == 0 and 32 <= n <= MAX_X1_N


# warp groups sharing each contraction, by column tile, and the staging
# rule of stage_geometry: measured on an H100 by scripts/sg_stage_tune.py
# (PERF.md, section 6)
_KSPLIT_OF_TN = {16: 4, 32: 2, 48: 2}
SMS = 132  # streaming multiprocessors of an H100 SXM: one wave of blocks
# the largest order the stage kernel takes: 16 blocks of 48 columns
MAX_KERNEL_N = MAX_CLUSTER_NP * _STAGE_TNS[-1] - 1


@functools.lru_cache(maxsize=None)
def stage_geometry(nf: int, dtype: torch.dtype, lanes: int = 1,
                   tn: int = None, ksplit: int = None, ks: int = None,
                   depth: int = None, x1: bool = False) -> StageGeometry:
    """The stage kernel's geometry at order nf - 1 in ``dtype`` for a launch
    of ``lanes`` lanes.

    The column tile is the narrowest of 16, 32, 48 whose row band fits a
    portable cluster (<= 8 blocks), which keeps the blocks small and many
    (N <= 383); above that, 48 columns in a non-portable cluster of up to
    ``MAX_CLUSTER_NP`` blocks (N <= ``MAX_KERNEL_N``); rows are 8 a
    block; ``_KSPLIT_OF_TN`` warp groups share each contraction. Tile and k groups fix the arithmetic, so they do not
    depend on ``lanes``: lane b of a B-lane launch gives the bits of a
    one-lane launch. The staging does: a launch of one wave of blocks (at
    most ``SMS``) takes every band whole (ks = nf, one slot), as does any
    launch up to N = 63; a larger one streams the bands through a ring of
    two 32-wide slabs, which keeps a block's shared memory small so that
    several blocks share an SM; where that does not fit, a ring of 32- or
    16-wide slabs, 3 slots where they fit, else 2. ``tn``, ``ksplit``, ``ks`` and ``depth`` override the
    choice (scripts/sg_stage_tune.py sweeps them). ``x1``: the x1 stage's
    geometry (float32): the same tile and cluster, as many k groups as
    the launch bound takes, the bands whole (ks = nf) in bf16, and
    ``depth`` the regions of its four copy groups, the most of 4, 3, 2
    that fit; raises where they do not.
    Raises on an order, dtype or override the kernel cannot take."""
    elem = {torch.float32: 4, torch.float64: 8}.get(dtype)
    if elem is None:
        raise TypeError(f"the SG kernels take float32 or float64, not {dtype}")
    if x1 and elem != 4:
        raise ValueError(f"the x1 stage runs in float32, not {dtype}")
    if nf < 3:
        raise ValueError(f"order {nf - 1} is too small for the stage kernel")
    if tn is None:
        tn = next((t for t in _STAGE_TNS if -(-nf // t) <= MAX_CLUSTER),
                  _STAGE_TNS[-1])
        if -(-nf // tn) > MAX_CLUSTER_NP:
            raise ValueError(f"order {nf - 1}: the row band needs more than "
                             f"{MAX_CLUSTER_NP} blocks of {tn} columns")
    cluster, rows = -(-nf // tn), -(-nf // STAGE_TM)
    if tn not in _STAGE_TNS or cluster > (
            MAX_CLUSTER_NP if tn == _STAGE_TNS[-1] else MAX_CLUSTER):
        raise ValueError(f"order {nf - 1}: no tile of {tn} columns")
    most = stage_max_threads(elem, tn) // stage_group_threads(tn)
    if ksplit is None:
        # x1: a warp runs a product's whole k, so its k groups only add
        # warps, as many as the launch bound takes
        ksplit = most if x1 else min(_KSPLIT_OF_TN[tn], most)
    if ksplit not in _KSPLITS or ksplit > most:
        raise ValueError(f"ksplit {ksplit} is not one of {_KSPLITS} up to "
                         f"{most}")

    def smem(k, d):
        return elem * _stage_smem_elems(nf, tn, k, d, ksplit)

    if x1:
        if depth is None:
            depth = next((d for d in range(_X1_GROUPS, 1, -1)
                          if _stage_x1_smem_bytes(nf, tn, ksplit, d)
                          <= MAX_SMEM), 2)
        size = _stage_x1_smem_bytes(nf, tn, ksplit, depth)
        if not 2 <= depth <= _X1_GROUPS or size > MAX_SMEM:
            raise ValueError(f"order {nf - 1}: the x1 stage's bands in "
                             f"{depth} regions need {size} bytes of shared "
                             f"memory")
        return StageGeometry(
            tn=tn, cluster=cluster, rows=rows, ks=nf, depth=depth, smem=size,
            nparts=cluster * rows, ksplit=ksplit,
            threads=ksplit * stage_group_threads(tn), grid=(cluster, rows))
    if ks is None or depth is None:
        first = ((nf, 1) if lanes * cluster * rows <= SMS or nf <= 64
                 else (32, 2))
        candidates = [first] + [(k, d) for k in (32, 16) for d in (3, 2)]
        ks, depth = next(((k, d) for k, d in candidates
                          if smem(k, d) <= MAX_SMEM), (None, None))
        if ks is None:
            raise ValueError(f"order {nf - 1} {dtype}: no ring fits in "
                             f"{MAX_SMEM} bytes of shared memory")
    if not 1 <= depth <= 3 or (ks < nf and ks % ksplit) or smem(
            ks, depth) > MAX_SMEM:
        raise ValueError(f"order {nf - 1} {dtype}: ks {ks} depth {depth} "
                         f"ksplit {ksplit} cannot be launched")
    return StageGeometry(
        tn=tn, cluster=cluster, rows=rows, ks=ks, depth=depth,
        smem=smem(ks, depth), nparts=cluster * rows, ksplit=ksplit,
        threads=ksplit * stage_group_threads(tn), grid=(cluster, rows))


class ResidentGeometry(NamedTuple):
    """The resident chunk kernel's launch shape at one order and dtype."""
    cluster: int   # blocks of a lane's cluster = grid x: a row band each
    sub: int       # sub-blocks of a block: a column tile of the band each
    threads: int   # threads of a block: 4 k-group warps a sub-block


# The largest order whose lane fits one portable cluster, by element size:
# where csrc/sg_common.cuh:res_layout, the one account of a resident
# block's shared memory, still fits the card's (the C entry
# sg_resident_geometry answers at every order; the card tests hold the two
# to each other).
RESIDENT_MAX_N = {4: 51, 8: 31}


@functools.lru_cache(maxsize=None)
def resident_geometry(nf: int, dtype: torch.dtype, lanes: int = 1,
                      x1: bool = False):
    """The resident chunk kernel's launch shape at order nf - 1 in
    ``dtype`` for ``lanes`` lanes, or None where a lane does not fit one
    cluster (its chunk then runs the multi-launch kernels).

    A lane is a portable cluster of a block a row band of the stage
    geometry (8 rows), a block a sub-block of 128 threads a column tile of
    its band (16 columns, the stage geometry's tiles and 4 k groups at
    these orders). It takes float32 up to N = 51 and float64 up to N = 31
    (``RESIDENT_MAX_N``); x1 and more than 65,535 lanes take None. The
    geometry does not depend on the lane count."""
    elem = {torch.float32: 4, torch.float64: 8}.get(dtype)
    if elem is None:
        raise TypeError(f"the SG kernels take float32 or float64, not {dtype}")
    if x1 or not 1 <= lanes <= 65535 or nf - 1 > RESIDENT_MAX_N[elem]:
        return None
    g = stage_geometry(nf, dtype)
    return ResidentGeometry(cluster=g.rows, sub=g.cluster,
                            threads=g.cluster * g.threads)


def tail_grid(nf: int, lanes: int, coresident: int) -> int:
    """Blocks of the tail kernel's cooperative launch at order nf - 1 for
    ``lanes`` lanes on a card where ``coresident`` of its blocks fit at
    once: one block a (16x16 tile, lane) item, at most ``coresident``, the
    blocks striding over the items (``tail_block_items``); block b also
    finishes lane b. Raises where the card holds fewer blocks than lanes,
    or where a block would take more than ``MAX_TAIL_ITEMS`` items: such a
    launch is refused, never run another way."""
    if coresident < max(lanes, 1):
        raise RuntimeError(f"the tail kernel needs a cooperative launch of "
                           f"a block a lane at least ({lanes}); the card "
                           f"holds {coresident}")
    nt = -(-nf // _TILE)
    items = nt * nt * lanes
    blocks = min(items, coresident)
    if -(-items // blocks) > MAX_TAIL_ITEMS:
        raise ValueError(f"order {nf - 1}, {lanes} lanes: {items} tail items "
                         f"on {blocks} co-resident blocks is more than "
                         f"{MAX_TAIL_ITEMS} a block")
    return blocks


def tail_block_items(nf: int, lanes: int, blocks: int, b: int):
    """The (lane, tile row, tile column) items block ``b`` of a
    ``blocks``-block tail launch takes, in its order (both tile phases of
    csrc/sg_diag.cu:tail_kernel)."""
    nt = -(-nf // _TILE)
    nb = nt * nt
    return [(it // nb, it % nb // nt, it % nt)
            for it in range(b, nb * lanes, blocks)]


# dtype code -> co-resident blocks on this card of the tail kernel, and of
# its x1 instance
_CORESIDENT = {}
_CORESIDENT_X1 = {}


def _tail_blocks(ops: SpectralOps, lanes: int, lib, x1: bool = False) -> int:
    """The tail kernel's grid (its x1 instance's with ``x1``) for ``lanes``
    lanes of ``ops`` on this card (its co-resident count asked once per
    dtype and instance)."""
    code = _dtype_code(ops.dtype)
    table = _CORESIDENT_X1 if x1 else _CORESIDENT
    if code not in table:
        most = ctypes.c_int(0)
        _raise_on(lib, lib.sg_tail_coresident(code, int(x1),
                                              ctypes.byref(most)),
                  "sg_tail_coresident")
        table[code] = most.value
    return tail_grid(ops.nf, lanes, table[code])


def chunk_launches(chunk: int, start_iter: int, metrics_every: int,
                   x1: bool = False, resident: bool = False) -> dict:
    """The launches of one chunk by kernel: four stages a step, dt at the
    first step, and one tail a step: the tail kernel (sg_diag) on a sampled
    step (the first, and every ``metrics_every``-th global iteration, as
    ``chunk_plain`` samples), control (sg_control) on the others. With
    ``x1`` the stages and sampled tails are the x1 instances' (sg_stage_x1,
    sg_diag_x1); dt stays sg_diag's. With ``resident`` (an order of
    ``resident_geometry``) the whole chunk is one launch of sg_resident."""
    if resident:
        return {"sg_resident": int(chunk > 0)}
    sampled = sum(1 for i in range(chunk)
                  if i == 0 or (start_iter + i) % metrics_every == 0)
    if x1:
        return {"sg_stage_x1": 4 * chunk, "sg_diag": int(chunk > 0),
                "sg_diag_x1": sampled, "sg_control": chunk - sampled}
    return {"sg_stage": 4 * chunk, "sg_diag": int(chunk > 0) + sampled,
            "sg_control": chunk - sampled}


def smoother_launches(n_steps: int) -> dict:
    """The launches of one smoother call of ``n_steps`` steps by kernel:
    four stages a step, dt at the first step and the tail kernel at the
    end (sg_diag), 4 n + 2 in all."""
    return {"sg_stage": 4 * n_steps, "sg_diag": 2}


def _check_launches(counts, chunk, start_iter, metrics_every, x1=False,
                    resident=False):
    """Raise where the C entry's counts (KERNELS', then PARTS' where
    given) differ from the chunk's plan: dt_kernel once, at the first step
    (none in a resident chunk, which takes its first dt itself)."""
    got = {k: 0 for k in KERNELS}
    got.update(zip(KERNELS + PARTS, (int(n) for n in counts)))
    plan = chunk_launches(chunk, start_iter, metrics_every, x1, resident)
    want = {k: plan.get(k, 0) for k in KERNELS}
    if "dt_kernel" in got:
        want["dt_kernel"] = int(chunk > 0 and not resident)
    if got != want:
        raise RuntimeError(f"chunk launches {got}, planned {want}")


def _new_counts():
    """The C entries' launch counts (csrc/sg_common.cuh:Count), zeroed."""
    return (ctypes.c_int * (len(KERNELS) + len(PARTS)))()


def reset_counts() -> None:
    for table in (LAUNCHES, PART_LAUNCHES, PLAIN_CALLS, STEPS):
        for k in table:
            table[k] = 0
    SMOOTH_STEPS.clear()


def scalar_table(ops_list) -> torch.Tensor:
    """The (lanes, 6) table of per-lane scalars in csrc/sg_common.cuh:Scal
    order, in the working dtype on the operators' device: each value is the
    host double cast to the working type."""
    o0 = ops_list[0]
    return torch.tensor([[o.nu, o.beta_sq, o.CFL, o.lid_velocity,
                          o.inv_dx_min, o.inv_dy_min] for o in ops_list],
                        dtype=o0.dtype, device=o0.device)


def _dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.float64:
        return 1
    raise TypeError(f"the SG kernels take float32 or float64, not {dtype}")


def _check(name, t: torch.Tensor, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_ops(ops: SpectralOps):
    nf, ni = ops.nf, ops.nf - 2
    shapes = {"Ix": (nf, ni), "Gx": (nf, ni), "IyT": (ni, nf),
              "GyT": (ni, nf)}
    for name in _OP_NAMES:
        t = getattr(ops, name)
        if t is None:
            if not name.startswith("sing_"):
                raise ValueError(f"ops.{name} is missing")
            continue
        _check(f"ops.{name}", t, shapes.get(name, (nf, nf)), ops.dtype,
               ops.device)


def _check_state(ops: SpectralOps, state: SpectralState):
    nf = ops.nf
    for name, t, shape in (("u", state.u, (nf, nf)), ("v", state.v, (nf, nf)),
                           ("p", state.p, (nf - 2, nf - 2))):
        _check(f"state.{name}", t, shape, ops.dtype, ops.device)


def _workspace(ops: SpectralOps, lanes: int = 1, **bufs) -> dict:
    """The pointer table's operators and per-step scratch for ``lanes``
    lanes (lane-major), updated with ``bufs``: the stage kernel's partial
    sums (``stage_geometry(...).nparts`` blocks a lane, of the stage and of
    the base a chunk step leaves) and the quadratures' (one per 16x16
    tile) differ in number."""
    nf, ni = ops.nf, ops.nf - 2
    tiles = (nf + _TILE - 1) // _TILE
    nparts = stage_geometry(nf, ops.dtype).nparts
    kw = dict(dtype=ops.dtype, device=ops.device)
    ws = {name: getattr(ops, name) for name in _OP_NAMES}
    ws.update(
        au=torch.empty((lanes, nf, nf), **kw),
        av=torch.empty((lanes, nf, nf), **kw),
        ap=torch.empty((lanes, ni, ni), **kw),
        omega=torch.empty((lanes, nf, nf), **kw),
        part=torch.empty((lanes, nparts, _NPART), **kw),
        dpart=torch.empty((lanes, nparts, _NDPART), **kw),
        qpart=torch.empty((lanes, tiles * tiles, _NQPART), **kw),
        scal=torch.zeros((lanes, _NSCAL), **kw))
    ws.update(bufs)
    return ws


def _ptr_table(ws: dict):
    ptrs = [ws[n].data_ptr() if ws.get(n) is not None else None
            for n in _PTR_NAMES]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.sg_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")


def _geo(ops: SpectralOps, lanes: int = 1, x1: bool = False):
    """The stage geometry of ``ops`` for ``lanes`` lanes (the x1 stage's
    with ``x1``) as the C entries take it."""
    return stage_geometry(ops.nf, ops.dtype, lanes, x1=x1).as_c()


def _count(counts):
    for k, n in zip(KERNELS, counts):
        LAUNCHES[k] += int(n)
    for k, n in zip(PARTS, counts[len(KERNELS):]):
        PART_LAUNCHES[k] += int(n)


def _on_cuda(ops: SpectralOps, state: SpectralState) -> bool:
    """Check the state against the operators; True for the kernel path."""
    _check_state(ops, state)
    if ops.device.type not in ("cuda", "cpu"):
        raise ValueError("the SG kernels run on cuda, and their plain "
                         f"versions on cpu, not on {ops.device}")
    return ops.device.type == "cuda"


# ---------------------------------------------------------------- step


def step_plain(ops, state, tau=None):
    """The step kernel's plain version (models/spectral_sg.sg_step)."""
    PLAIN_CALLS["sg_step"] += 1
    return core.sg_step(ops, state, tau)


def _taus(ops, tau) -> dict:
    """The FAS forcing's pointer-table entries, checked; none without it."""
    if tau is None:
        return {}
    nf, ni = ops.nf, ops.nf - 2
    for name, t, shape in zip(("tau_u", "tau_v", "tau_p"), tau,
                              ((nf, nf), (nf, nf), (ni, ni))):
        _check(name, t, shape, ops.dtype, ops.device)
    return dict(zip(("tau_u", "tau_v", "tau_p"), tau))


def _step_kernel(ops, state, tau, lsc):
    from ._build import load_library

    lib = load_library("sg")
    nf = ops.nf
    taus = _taus(ops, tau)
    out = SpectralState(torch.empty_like(state.u), torch.empty_like(state.v),
                        torch.empty_like(state.p))
    metrics = torch.empty(6, dtype=ops.dtype, device=ops.device)
    ws = _workspace(ops, u=state.u, v=state.v, p=state.p, bu=out.u,
                    bv=out.v, bp=out.p, metrics=metrics, lsc=lsc, **taus)
    counts = _new_counts()
    rc = lib.sg_step_run(_dtype_code(ops.dtype), nf, _geo(ops),
                         _ptr_table(ws), int(tau is not None),
                         _tail_blocks(ops, 1, lib), counts, _stream())
    _count(counts)
    _raise_on(lib, rc, "sg_step_run")
    return out, dict(zip(_STEP_KEYS, metrics.unbind()))


def make_sg_step(ops: SpectralOps, with_tau: bool = False):
    """One RK4 step with its six metrics: ``step(state) -> (state,
    metrics)``, or ``step(state, (tau_u, tau_v, tau_p))`` with the FAS
    forcing added to every stage residual when ``with_tau``."""
    _check_ops(ops)
    lsc = scalar_table([ops])

    def run(state, tau):
        if _on_cuda(ops, state):
            return _step_kernel(ops, state, tau, lsc)
        return step_plain(ops, state, tau)

    return run if with_tau else (lambda state: run(state, None))


# ---------------------------------------------------------------- smoother


def smooth_plain(ops, state, tau, n_steps):
    """The smoothing loop's plain version: ``n_steps`` calls of
    ``models/spectral_sg.sg_step`` and the last step's metrics (the scan of
    ``anap3_tpu/models/spectral_vmg.py:make_v_cycle``'s ``smooth``)."""
    PLAIN_CALLS["sg_smooth"] += 1
    metrics = None
    for _ in range(n_steps):
        state, metrics = core.sg_step(ops, state, tau)
    return state, metrics


def make_sg_smoother(ops: SpectralOps):
    """``n_steps`` RK4 steps in one host entry: ``smooth(state, tau,
    n_steps) -> (state, metrics)`` with the six metrics of the last step;
    ``tau`` (tau_u, tau_v, tau_p) is added to every stage residual, or is
    None for an unforced level.

    Every call returns fresh state and metrics tensors (a V-cycle keeps the
    smoother's input and output side by side); the per-step scratch, which
    never leaves the call, is allocated once per smoother and reused in
    stream order."""
    _check_ops(ops)
    scratch = {}
    order = ops.nf - 1

    def kernel(state, taus, n_steps):
        from ._build import load_library

        lib = load_library("sg")
        if not scratch:
            scratch.update(_workspace(ops, lsc=scalar_table([ops])))
            for name, like in (("cu", state.u), ("cv", state.v),
                               ("cp", state.p)):
                scratch[name] = torch.empty_like(like)
        out = SpectralState(torch.empty_like(state.u),
                            torch.empty_like(state.v),
                            torch.empty_like(state.p))
        metrics = torch.empty(6, dtype=ops.dtype, device=ops.device)
        ws = dict(scratch, u=state.u, v=state.v, p=state.p, bu=out.u,
                  bv=out.v, bp=out.p, metrics=metrics, **taus)
        counts = _new_counts()
        rc = lib.sg_smooth_run(_dtype_code(ops.dtype), ops.nf, _geo(ops),
                               _ptr_table(ws), int(n_steps), int(bool(taus)),
                               _tail_blocks(ops, 1, lib), counts, _stream())
        _count(counts)
        _raise_on(lib, rc, "sg_smooth_run")
        got = dict(zip(KERNELS + PARTS, (int(n) for n in counts)))
        want = dict({k: 0 for k in got}, dt_kernel=1,
                    **smoother_launches(int(n_steps)))
        if got != want:
            raise RuntimeError(f"smoother launches {got}, planned {want}")
        return out, dict(zip(_STEP_KEYS, metrics.unbind()))

    def run(state, tau, n_steps):
        if int(n_steps) < 1:
            raise ValueError(f"n_steps must be >= 1, not {n_steps}")
        SMOOTH_STEPS[order] = SMOOTH_STEPS.get(order, 0) + int(n_steps)
        on_cuda = _on_cuda(ops, state)
        taus = _taus(ops, tau)  # checked on both paths
        if on_cuda:
            return kernel(state, taus, n_steps)
        return smooth_plain(ops, state, tau, int(n_steps))

    return run


# ---------------------------------------------------------------- dt


def base_parts(ops: SpectralOps, u: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """The partials of a base (u, v) as the last stage writes them for the
    next step (csrc/sg_stage.cu's epilogue, P_DPART): an (nparts, 4) table,
    one row a block of ``stage_geometry(ops.nf, ops.dtype)`` in the
    kernel's order (row band y, column block x at y * cluster + x; the
    block covers rows [8 y, 8 y + 8) and columns [tn x, tn x + tn)), with
    max|u + su|, max|v + sv|, sum u^2, sum v^2 over the block (the sums in
    torch's order, not the kernel's)."""
    g = stage_geometry(ops.nf, ops.dtype)
    ut, vt = (u + ops.sing_u, v + ops.sing_v) if ops.singular else (u, v)
    rows, nf = g.rows * STAGE_TM, ops.nf

    def blocks(x):  # zero padding changes neither a max of |x| nor a sum
        x = torch.nn.functional.pad(x, (0, g.cluster * g.tn - nf,
                                        0, rows - nf))
        return x.reshape(g.rows, STAGE_TM, g.cluster, g.tn).transpose(
            1, 2).reshape(g.nparts, -1)

    return torch.stack([blocks(ut.abs()).amax(1), blocks(vt.abs()).amax(1),
                        blocks(u * u).sum(1), blocks(v * v).sum(1)], dim=1)


def _round_exact(q: Fraction, dtype):
    """The rational q rounded to the numpy float type ``dtype`` (to
    nearest, ties to even)."""
    x = dtype(float(q))  # within an ulp of q (float64: q rounded)
    if dtype is np.float64 or not np.isfinite(x):
        return x
    bits = np.dtype(dtype).itemsize * 8
    as_int = getattr(np, f"uint{bits}")
    cands = (np.nextafter(x, dtype(-np.inf)), x,
             np.nextafter(x, dtype(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q),
                                     int(np.array(c).view(as_int)) & 1))


def _fma(a, b, c, dtype):
    """a * b + c rounded once, as the card's fused multiply-add."""
    if not all(np.isfinite((a, b, c))):
        return dtype(a * b + c)
    return _round_exact(Fraction(float(a)) * Fraction(float(b))
                        + Fraction(float(c)), dtype)


def _nan_max(a, b):
    """csrc/sg_common.cuh:nan_max."""
    return a if (a > b or a != a) else b


def dt_from_parts(ops: SpectralOps, parts: torch.Tensor,
                  kernel: bool = False) -> torch.Tensor:
    """The step's dt from the partials of its base (``base_parts``, or the
    P_DPART table a last stage wrote), as the first stage of a smoother step
    takes it: the largest of columns 0 and 1 over the blocks (a maximum is
    exact in any order), then the CFL dt of ``models/spectral_sg.
    adaptive_dt``, whose bits it has; ``kernel`` computes dt as the card
    does instead (csrc/sg_common.cuh:dt_of, the arithmetic of dt_kernel and
    of the smoother's stages: each fused multiply-add rounded once, on the
    lane scalars of ``scalar_table``), exactly, on the host."""
    umax, vmax = parts[:, 0].max(), parts[:, 1].max()
    if not kernel:
        return core.dt_of_maxima(ops, umax, vmax)
    dt = np.float32 if ops.dtype == torch.float32 else np.float64
    nu, beta, cfl, lid, idx, idy = (dt(x) for x in (
        ops.nu, ops.beta_sq, ops.CFL, ops.lid_velocity, ops.inv_dx_min,
        ops.inv_dy_min))
    u_max = _nan_max(dt(umax.item()), lid)
    v_max = _nan_max(dt(vmax.item()), dt(1e-10))
    wx = u_max + np.sqrt(_fma(u_max, u_max, beta, dt))
    wy = v_max + np.sqrt(_fma(v_max, v_max, beta, dt))
    lam_x = _fma(nu, idx * idx, idx * wx, dt)
    lam_y = _fma(nu, idy * idy, idy * wy, dt)
    return torch.tensor(cfl / (lam_x + lam_y), dtype=ops.dtype)


# ---------------------------------------------------------------- x1


class X1Operators(NamedTuple):
    """The bf16 hi halves of the operators (each float32 entry rounded to
    bfloat16, held in float32) that the x1 products contract with, over
    the bordered core: the velocity operators without their border index
    N = nf - 1 (its term is added exactly), the pressure operators whole
    (their contraction runs over the inner grid)."""
    Dx: torch.Tensor    # (nf, N)
    Dxx: torch.Tensor   # (nf, N)
    DyT: torch.Tensor   # (N, nf)
    DyyT: torch.Tensor  # (N, nf)
    Gx: torch.Tensor    # (nf, ni)
    Ix: torch.Tensor    # (nf, ni)
    IyT: torch.Tensor   # (ni, nf)
    GyT: torch.Tensor   # (ni, nf)
    # True: the stage's products summed as the x1 stage kernel's tensor
    # cores sum them (``tc_matmul``), the yardstick of the kernel's sum
    # order; False: float32 matmuls, the plain version
    tc: bool = False


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 (to nearest even) and held in its dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def x1_operators(ops: SpectralOps, tc: bool = False) -> X1Operators:
    """The hi halves of ``ops`` (float32 only: x1 is a float32 mode); with
    ``tc`` the stage sums as the tensor cores do (``X1Operators.tc``)."""
    if ops.dtype != torch.float32:
        raise ValueError(f"matmul_algorithm=x1 runs in float32, not "
                         f"{ops.dtype}")
    n = ops.nf - 1
    return X1Operators(
        Dx=bf16_round(ops.Dx[:, :n]), Dxx=bf16_round(ops.Dxx[:, :n]),
        DyT=bf16_round(ops.DyT[:n]), DyyT=bf16_round(ops.DyyT[:n]),
        Gx=bf16_round(ops.Gx), Ix=bf16_round(ops.Ix),
        IyT=bf16_round(ops.IyT), GyT=bf16_round(ops.GyT), tc=tc)


def tc_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of float32 operands that hold bf16 values, summed as the
    x1 stage kernel's mma.sync products are on an H100: k in blocks of 16
    from k = 0, each block's products summed exactly and added to the
    float32 accumulator, the sum rounded toward zero (scripts/x1_parity.py
    measured this order against the kernel; PERF.md, Findings)."""
    k = a.shape[-1]
    kb = -(-k // 16)
    pad = kb * 16 - k
    a64 = torch.nn.functional.pad(a.double(), (0, pad))
    b64 = torch.nn.functional.pad(b.double(), (0, 0, 0, pad))
    blocks = torch.einsum("mbk,bkn->bmn", a64.reshape(a.shape[0], kb, 16),
                          b64.reshape(kb, 16, b.shape[-1]))
    acc = torch.zeros(blocks.shape[1:], dtype=torch.float32, device=a.device)
    for block in blocks:
        exact = acc.double() + block
        acc = exact.float()
        over = acc.double().abs() > exact.abs()
        acc = torch.where(over, torch.nextafter(acc, torch.zeros_like(acc)),
                          acc)
    return acc


def x1_border_table(ops: SpectralOps) -> torch.Tensor:
    """The x1 stage's per-run constants (csrc/sg_common.cuh:Ops::x1b): the
    velocity products on the constant border strip, in float64 from the
    boundary values, cast to float32, as the aligned kernel's constant
    strips (``_prep_aligned``): rows Dx u, Dxx u, Dx v, Dxx v at column N
    and u DyT, u DyyT, v DyT, v DyyT at row N, each (nf,)."""
    n = ops.nf - 1
    d = lambda t: t.double()
    bu, bv = d(ops.bc_u), d(ops.bc_v)
    rows = [d(ops.Dx) @ bu[:, n], d(ops.Dxx) @ bu[:, n],
            d(ops.Dx) @ bv[:, n], d(ops.Dxx) @ bv[:, n],
            bu[n] @ d(ops.DyT), bu[n] @ d(ops.DyyT),
            bv[n] @ d(ops.DyT), bv[n] @ d(ops.DyyT)]
    return torch.stack(rows).to(ops.dtype).contiguous()


# the x1 operator table's bands: the x1_operators field, whether it is
# stored transposed. Mirrors csrc/sg_common.cuh: the order of X1Op and the
# band sizes of x1_op_offset (velocity bands nf x k16(N), pressure bands
# nf x k16(ni)); change both together.
_X1_TABLE = (("Dx", False), ("Dxx", False), ("DyT", True), ("DyyT", True),
             ("Gx", False), ("Ix", False), ("IyT", True), ("GyT", True))


def x1_operator_table(ops: SpectralOps) -> torch.Tensor:
    """The x1 stage kernel's operators (csrc/sg_common.cuh:X1Op, pointer
    slot P_X1OPS), written once a run: the hi halves of
    ``x1_operators(ops)`` as bf16 (torch's round to nearest even), in bands
    of nf rows with k contiguous, each row zero from the contraction's end
    (N for the velocity operators, ni for the pressure ones) up to whole
    16-wide k steps: Dx, Dxx, then DyT, DyyT transposed (a row a column),
    then Gx, Ix, then IyT, GyT transposed. One flat bf16 tensor; the bands
    are ``_x1_table_views``."""
    hi = x1_operators(ops)
    bands = []
    for name, transposed in _X1_TABLE:
        t = getattr(hi, name)
        t = t.T if transposed else t
        band = torch.zeros((ops.nf, _x1_k16(t.shape[1])), dtype=torch.bfloat16,
                           device=ops.device)
        band[:, :t.shape[1]] = t.to(torch.bfloat16)
        bands.append(band.reshape(-1))
    return torch.cat(bands)


def _x1_table_views(table: torch.Tensor, nf: int) -> dict:
    """The eight (nf, k16) bands of ``x1_operator_table``'s table by
    ``x1_operators`` field name (DyT, DyyT, IyT, GyT transposed)."""
    views, at = {}, 0
    for name, _ in _X1_TABLE:
        k16 = _x1_k16(nf - 1 if name in ("Dx", "Dxx", "DyT", "DyyT")
                      else nf - 2)
        views[name] = table[at:at + nf * k16].view(nf, k16)
        at += nf * k16
    return views


def _x1_state_lds(nf: int):
    """(u and v, p) leading dims of the x1 state copy
    (csrc/sg_common.cuh:x1_sld, x1_pld)."""
    return _x1_k16(nf), _x1_k16(nf - 2)


def _x1_state_elems(nf: int) -> int:
    """bf16 elements of one lane's x1 state copy
    (csrc/sg_common.cuh:x1_state_elems)."""
    s, sp = _x1_state_lds(nf)
    return 2 * s * s + sp * sp


def _x1_state_views(xs: torch.Tensor, nf: int):
    """(u, v, p) of one lane's flat x1 state copy: (S, S), (S, S) and
    (Sp, Sp) views, S and Sp its leading dims."""
    s, sp = _x1_state_lds(nf)
    return (xs[:s * s].view(s, s), xs[s * s:2 * s * s].view(s, s),
            xs[2 * s * s:].view(sp, sp))


def x1_state_copy(state: SpectralState) -> torch.Tensor:
    """The plain version of the x1 state copy that ``dt_kernel`` (a chunk's
    start), every x1 stage (its output) and the bench entry (its input)
    write: u and v rounded to bf16 on [0, N)^2, p on the inner grid, zero
    elsewhere (the border row and column N enter the products unrounded),
    flat in csrc/sg_common.cuh's layout."""
    nf = state.u.shape[-1]
    n = nf - 1
    xs = torch.zeros(_x1_state_elems(nf), dtype=torch.bfloat16,
                     device=state.u.device)
    u, v, p = _x1_state_views(xs, nf)
    u[:n, :n] = state.u[:n, :n].to(torch.bfloat16)
    v[:n, :n] = state.v[:n, :n].to(torch.bfloat16)
    p[:n - 1, :n - 1] = state.p.to(torch.bfloat16)
    return xs


def _x1_tables(ops: SpectralOps) -> dict:
    """The x1 kernels' per-run pointer-table entries: the border constants
    (x1b) and the operator table (x1ops)."""
    return {"x1b": x1_border_table(ops), "x1ops": x1_operator_table(ops)}


def x1_workspace(ops: SpectralOps, lanes: int = 1, tables=None) -> dict:
    """The x1 entries of a pointer table: the per-run ones (``tables``
    when made already, else made here) and the three zeroed sets (base,
    A, B) of bf16 state copies (x1s) the chunk's launches write."""
    tables = _x1_tables(ops) if tables is None else tables
    xs = torch.zeros((3, lanes, _x1_state_elems(ops.nf)), dtype=torch.bfloat16,
                     device=ops.device)
    return dict(tables, x1s=xs)


def x1_left(hi_op, op, w, exact_border_column: bool, tc: bool = False):
    """``op @ w`` as one bf16 pass of the aligned kernel's bordered core
    (``anap3_tpu/ops/pallas_aligned.py``, ``_DotEngine`` x1): the sum over
    k < N of bf16 products in float32, plus the border term op[:, N] w[N]
    unrounded. Where w's border column is a per-run constant (a velocity)
    the output column N is exact, as the kernel's constant strips are;
    else (the vorticity) only the corner (N, N) is. ``tc``: the core
    summed by ``tc_matmul`` and the border term added in one rounding, as
    the x1 stage kernel does."""
    n = w.shape[0] - 1
    if tc:
        out = (tc_matmul(hi_op, bf16_round(w[:n])).double()
               + op[:, n:].double() @ w[n:].double()).float()
    else:
        out = hi_op @ bf16_round(w[:n]) + op[:, n:] @ w[n:]
    if exact_border_column:  # a per-run constant: float64, as the kernel's
        out[:, n] = (op.double() @ w[:, n].double()).to(out.dtype)
    else:
        out[n, n] = op[n] @ w[:, n]
    return out


def x1_right(w, hi_opT, opT, exact_border_row: bool, tc: bool = False):
    """``w @ opT``, the transpose of ``x1_left``'s rule: bf16 over k < N
    plus w[:, N] opT[N] unrounded; the output row N exact where w's
    border row is constant, else its corner only; ``tc`` as there."""
    n = w.shape[1] - 1
    if tc:
        out = (tc_matmul(bf16_round(w[:, :n]), hi_opT).double()
               + w[:, n:].double() @ opT[n:].double()).float()
    else:
        out = bf16_round(w[:, :n]) @ hi_opT + w[:, n:] @ opT[n:]
    if exact_border_row:
        out[n] = (w[n].double() @ opT.double()).to(out.dtype)
    else:
        out[n, n] = w[n] @ opT[:, n]
    return out


def x1_residuals(ops: SpectralOps, hi: X1Operators, u, v, p):
    """``models/spectral_sg.residuals`` with the x1 products: the velocity
    products by ``x1_left`` / ``x1_right``; the pressure chain as the
    aligned kernel runs it, (Gx p) rounded to bf16 before its contraction
    with IyT, both passes bf16 over the inner grid, except the corner
    (N, N), which contracts the unrounded row with IyT's border column
    (its ``_corner_dot``)."""
    tc = hi.tc
    mm = tc_matmul if tc else torch.matmul
    du_dx = x1_left(hi.Dx, ops.Dx, u, True, tc)
    dv_dx = x1_left(hi.Dx, ops.Dx, v, True, tc)
    du_dy = x1_right(u, hi.DyT, ops.DyT, True, tc)
    dv_dy = x1_right(v, hi.DyT, ops.DyT, True, tc)
    lap_u = (x1_left(hi.Dxx, ops.Dxx, u, True, tc)
             + x1_right(u, hi.DyyT, ops.DyyT, True, tc))
    lap_v = (x1_left(hi.Dxx, ops.Dxx, v, True, tc)
             + x1_right(v, hi.DyyT, ops.DyyT, True, tc))
    p_h = bf16_round(p)
    a5, a6 = mm(hi.Gx, p_h), mm(hi.Ix, p_h)
    dp_dx = mm(bf16_round(a5), hi.IyT)
    dp_dy = mm(bf16_round(a6), hi.GyT)
    n = ops.nf - 1
    dp_dx[n, n] = a5[n] @ ops.IyT[:, n]
    dp_dy[n, n] = a6[n] @ ops.GyT[:, n]
    if ops.singular:
        U = u + ops.sing_u
        V = v + ops.sing_v
        conv_u = U * (du_dx + ops.sing_dudx) + V * (du_dy + ops.sing_dudy)
        conv_v = U * (dv_dx + ops.sing_dvdx) + V * (dv_dy + ops.sing_dvdy)
    else:
        conv_u = u * du_dx + v * du_dy
        conv_v = u * dv_dx + v * dv_dy
    R_u = -conv_u - dp_dx + ops.nu * lap_u
    R_v = -conv_v - dp_dy + ops.nu * lap_v
    R_p = -ops.beta_sq * (du_dx + dv_dy)[1:-1, 1:-1]
    return R_u, R_v, R_p


def x1_rk4_step(ops: SpectralOps, hi: X1Operators, state: SpectralState):
    """``models/spectral_sg.rk4_step`` with ``x1_residuals``."""
    u0, v0, p0 = state
    dt = core.adaptive_dt(ops, u0, v0)
    u_in, v_in, p_in = u0, v0, p0
    for alpha in core.RK4_ALPHAS:
        R_u, R_v, R_p = x1_residuals(ops, hi, u_in, v_in, p_in)
        adt = alpha * dt
        u_in, v_in = core.enforce_bc(ops, u0 + adt * R_u, v0 + adt * R_v)
        p_in = p0 + adt * R_p
    return SpectralState(u_in, v_in, p_in), (R_u, R_v, R_p)


def x1_conserved_quantities(ops: SpectralOps, hi: X1Operators, u, v):
    """``models/spectral_sg.conserved_quantities`` with the x1 products:
    omega = Dx v - u DyT by the velocity rule, grad(omega) with omega
    rounded to bf16 and its border taken unrounded (the aligned kernel's
    metrics pass)."""
    omega = (x1_left(hi.Dx, ops.Dx, v, True)
             - x1_right(u, hi.DyT, ops.DyT, True))
    dwx = x1_left(hi.Dx, ops.Dx, omega, False)
    dwy = x1_right(omega, hi.DyT, ops.DyT, False)
    if ops.singular:
        u = u + ops.sing_u
        v = v + ops.sing_v
        omega = omega + ops.sing_w
        dwx = dwx + ops.sing_dwx
        dwy = dwy + ops.sing_dwy
    energy = 0.5 * torch.sum(ops.W2d * (u * u + v * v))
    enstrophy = 0.5 * torch.sum(ops.W2d * omega * omega)
    palinstrophy = 0.5 * torch.sum(ops.W2d * (dwx * dwx + dwy * dwy))
    return energy, enstrophy, palinstrophy


def stage_x1_plain(ops, hi, u_in, v_in, p_in, u0, v0, p0, adt):
    """One x1 RK stage from base (u0, v0, p0): the stage state and the
    residuals (the x1 stage kernel's plain version)."""
    R_u, R_v, R_p = x1_residuals(ops, hi, u_in, v_in, p_in)
    u, v = core.enforce_bc(ops, u0 + adt * R_u, v0 + adt * R_v)
    return SpectralState(u, v, p0 + adt * R_p), (R_u, R_v, R_p)


# ---------------------------------------------------------------- chunk


def chunk_plain(ops, state, start_iter, ref_norm, chunk, tolerance, warmup,
                 use_residual, metrics_every, hi=None):
    """The chunk kernel's arithmetic in plain torch, at its cadence; with
    the hi halves ``hi`` (``x1_operators``), the x1 chunk's."""
    PLAIN_CALLS["sg_chunk"] += 1
    return chunk_body(ops, state, start_iter, ref_norm, chunk, tolerance,
                      warmup, use_residual, metrics_every, hi=hi)


def chunk_body(ops, state, start_iter, ref_norm, chunk, tolerance, warmup,
               use_residual, metrics_every, carry=None, hi=None):
    """``chunk_plain`` without its count, starting from the flags ``carry``
    = (done, conv_iter, converged) of a previous chunk (fresh when None):
    a lane of ``ops/sg_lane_kernels.lanes_plain``. ``hi`` selects the x1
    products."""
    dev, dtype = ops.device, ops.dtype
    if carry is None:
        done = torch.zeros((), dtype=torch.bool, device=dev)
        converged = torch.zeros((), dtype=torch.bool, device=dev)
        conv_iter = torch.full((), -1, dtype=torch.int32, device=dev)
    else:
        done, conv_iter, converged = carry
    ref_norm = torch.as_tensor(ref_norm, dtype=dtype, device=dev)
    held = None
    rows = []
    for i in range(chunk):
        idx = int(start_iter) + i
        if hi is None:
            new, (R_u, R_v, R_p) = core.rk4_step(ops, state)
        else:
            new, (R_u, R_v, R_p) = x1_rk4_step(ops, hi, state)
        if i == 0 or idx % metrics_every == 0:
            held = torch.stack(
                core.conserved_quantities(ops, new.u, new.v) if hi is None
                else x1_conserved_quantities(ops, hi, new.u, new.v))
        rel = torch.maximum(rel_change(new.u, state.u),
                            rel_change(new.v, state.v))
        row = torch.cat([torch.stack([rel, torch.linalg.norm(R_u),
                                      torch.linalg.norm(R_v),
                                      torch.linalg.norm(R_p)]), held])
        row, now_done, conv_iter, converged, ref_norm = control_step(
            row, idx, done, conv_iter, converged, ref_norm, tolerance, warmup,
            use_residual)
        rows.append(row)
        state = freeze(done, state, new)
        done = now_done
    return state, done, conv_iter, converged, torch.stack(rows), ref_norm


def chunk_workspace(ops: SpectralOps, state: SpectralState, chunk: int,
                    ref_norm, lsc=None) -> dict:
    """Fresh output tensors (the chunk's state starts as a copy of
    ``state``) plus scratch, for one kernel chunk; ``lsc`` is the scalar
    table (built here when not given)."""
    kw = dict(dtype=ops.dtype, device=ops.device)
    flags = torch.tensor([0, -1, 0], dtype=torch.int32, device=ops.device)
    return _workspace(
        ops, u=state.u.clone(), v=state.v.clone(), p=state.p.clone(),
        bu=torch.empty_like(state.u), bv=torch.empty_like(state.v),
        bp=torch.empty_like(state.p), rows=torch.empty((chunk, 7), **kw),
        flags=flags,
        ref_norm=torch.as_tensor(ref_norm, **kw).reshape(1).clone(),
        lsc=scalar_table([ops]) if lsc is None else lsc)


def _run_resident(ops, lanes, ws, chunk, start_iter, warmup, metrics_every,
                  use_residual, tolerance, launches, key):
    """One chunk of ``lanes`` lanes on the workspace ``ws`` in one launch of
    the resident kernel (an order of ``resident_geometry``), its launches
    counted in ``launches[key]`` and held to the plan."""
    from ._build import load_library

    lib = load_library("sg")
    counts = _new_counts()
    rc = lib.sg_resident_chunk_run(
        _dtype_code(ops.dtype), ops.nf, _geo(ops, lanes), lanes,
        _ptr_table(ws), int(chunk), int(start_iter), int(warmup),
        int(metrics_every), int(use_residual), float(tolerance), counts,
        _stream())
    launches[key] += sum(int(n) for n in counts[:len(KERNELS)])
    _raise_on(lib, rc, "sg_resident_chunk_run")
    _check_launches(counts, chunk, start_iter, metrics_every, resident=True)


def _run_chunk(ops, ws, chunk, start_iter, warmup, metrics_every,
               use_residual, tolerance, x1=False):
    """One kernel chunk on the workspace ``ws`` (its state advanced in
    place), with the launches counted and held to the plan: one launch of
    the resident kernel where ``resident_geometry`` takes the order, the
    multi-launch chunk elsewhere."""
    from ._build import load_library

    if resident_geometry(ops.nf, ops.dtype, 1, x1) is not None:
        return _run_resident(ops, 1, ws, chunk, start_iter, warmup,
                             metrics_every, use_residual, tolerance,
                             LAUNCHES, "sg_resident")
    lib = load_library("sg")
    counts = _new_counts()
    rc = lib.sg_chunk_run(_dtype_code(ops.dtype), ops.nf, _geo(ops, x1=x1),
                          _ptr_table(ws), int(chunk), int(start_iter),
                          int(warmup), int(metrics_every), int(use_residual),
                          float(tolerance), int(x1),
                          _tail_blocks(ops, 1, lib, x1), counts, _stream())
    _count(counts)
    _raise_on(lib, rc, "sg_chunk_run")
    _check_launches(counts, chunk, start_iter, metrics_every, x1)


def _chunk_kernel(ops, state, start_iter, ref_norm, chunk, tolerance, warmup,
                  use_residual, metrics_every, lsc, x1_tables=None):
    ws = chunk_workspace(ops, state, chunk, ref_norm, lsc)
    x1 = x1_tables is not None
    if x1:
        ws.update(x1_workspace(ops, tables=x1_tables))
    _run_chunk(ops, ws, chunk, start_iter, warmup, metrics_every,
               use_residual, tolerance, x1)
    flags = ws["flags"]
    return (SpectralState(ws["u"], ws["v"], ws["p"]), flags[0] > 0,
            flags[1], flags[2] > 0, ws["rows"], ws["ref_norm"][0])


def make_sg_chunk_runner(ops: SpectralOps, chunk: int, tolerance: float,
                         warmup: int = WARMUP_ITERS,
                         convergence_metric: str = "rel_iter",
                         metrics_every: int = ALIGNED_METRICS_EVERY,
                         x1: bool = False):
    """``chunk`` RK4 steps with the convergence state machine, as one
    device-side loop (see the module docstring for the contract). ``x1``
    runs the products as one bf16 pass (float32 only; the solvers route it
    to ``x1_supported`` orders): the x1 kernels on CUDA, the x1 plain
    version on the CPU."""
    if convergence_metric not in ("rel_iter", "residual"):
        raise ValueError(
            f"chunk runners take the mapped criterion (rel_iter or "
            f"residual), not {convergence_metric!r}")
    _check_ops(ops)
    if x1 and ops.dtype != torch.float32:
        raise ValueError(f"matmul_algorithm=x1 runs in float32, not "
                         f"{ops.dtype}")
    args = dict(chunk=int(chunk), tolerance=float(tolerance),
                warmup=int(warmup),
                use_residual=convergence_metric == "residual",
                metrics_every=max(1, int(metrics_every)))
    lsc = scalar_table([ops])
    # x1: the kernels' per-run tables, the plain version's hi halves
    made = {}

    def chunk_fn(state, start_iter, ref_norm):
        STEPS["sg_chunk"] += args["chunk"]
        if _on_cuda(ops, state):
            if x1 and "tables" not in made:
                made["tables"] = _x1_tables(ops)
            return _chunk_kernel(ops, state, start_iter, ref_norm, lsc=lsc,
                                 x1_tables=made.get("tables"), **args)
        if x1 and "hi" not in made:
            made["hi"] = x1_operators(ops)
        return chunk_plain(ops, state, start_iter, ref_norm, **args,
                           hi=made.get("hi"))

    return chunk_fn


def bench_kernel(ops: SpectralOps, ws: dict, which: str, reps: int,
                 lanes: int = 1, geometry: StageGeometry = None,
                 x1: bool = False) -> None:
    """Enqueue ``reps`` launches of one group of ``BENCH_GROUPS`` on a chunk
    workspace of ``lanes`` lanes, for timing only (not counted in
    LAUNCHES): "sg_stage" is a chunk step's last stage (out of place, with
    the base's partials), "dt" the dt launch, "tail" a sampled step's tail
    launch, "sg_control" an unsampled step's control launch; with ``x1``
    the x1 stage and tail (the x1 stage needs ``x1_workspace``'s entries:
    the entry rounds the A buffers into their bf16 copy first).
    ``geometry`` (one of the same tile and cluster, so the partial sums
    fit) replaces the stage geometry of ``ops``."""
    from ._build import load_library

    lib = load_library("sg")
    geo = _geo(ops, lanes, x1) if geometry is None else geometry.as_c()
    rc = lib.sg_bench_run(_dtype_code(ops.dtype), ops.nf, geo,
                          int(lanes), _ptr_table(ws),
                          BENCH_GROUPS.index(which), int(reps), int(x1),
                          _tail_blocks(ops, lanes, lib, x1), _stream())
    _raise_on(lib, rc, f"sg_bench_run({which})")


def x1_step_stages(ops: SpectralOps, state: SpectralState):
    """One x1 step of the kernels from ``state``, one launch at a time
    through the bench entry (CUDA only, not counted in LAUNCHES): dt_kernel,
    then each RK stage with its alpha * dt. Returns the four stage inputs
    (``state`` first), the four stage outputs and the alpha * dt of each,
    so that each stage can be held against ``stage_x1_plain`` on the same
    inputs; the last output is the x1 chunk's step from ``state``."""
    ws = chunk_workspace(ops, state, 1, float("inf"))
    ws.update(x1_workspace(ops))
    bench_kernel(ops, ws, "dt", 1)
    dt = ws["scal"][0, 0].clone()
    ins, outs, adts = [], [], []
    cur = state
    for alpha in core.RK4_ALPHAS:
        adt = torch.tensor(alpha, dtype=ops.dtype, device=ops.device) * dt
        for name, t in zip(("au", "av", "ap"), cur):
            ws[name].copy_(t)
        ws["scal"][0, 0] = adt  # the launch's alpha is 1
        bench_kernel(ops, ws, "sg_stage", 1, x1=True)
        out = SpectralState(ws["bu"].clone(), ws["bv"].clone(),
                            ws["bp"].clone())
        ins.append(cur)
        outs.append(out)
        adts.append(adt)
        cur = out
    return ins, outs, adts
