"""Sweep lanes through the FV-SIMPLE CUDA kernels: B solves of one grid per
launch.

The counterpart of ``anap3_tpu/ops/pallas_fv_lanes.py``
(``_validate_fv_lanes``, ``fv_lanes_supported``, ``maybe_fv_lane_runner``,
``make_fv_lane_runner``: TPU kernel #11). ``csrc/fv_host.cu:
fv_lanes_chunk_run`` runs the kernels of ``ops/fv_kernels.py`` with every
launch covering all lanes, so a B-lane SIMPLE iteration costs the 2
launches of one and the chain of dependent grid-wide reductions that
bounds a single solve is paid once for the batch. Lanes
share the grid, scheme and pressure-solve operators; mu, alpha_uv, alpha_p,
rho and the lid (so aP_bc and b_bc_u) are per lane. Lane b of a B-lane chunk
gives the bits of a one-lane ``fv_chunk_run`` on its data, in float32 and
float64 (the JAX lane kernel agrees with its B=1 kernel to rounding only).
The row-stacked layout, its where-selects and the VMEM lane budget are not
ported: a lane's halo reads stop at its own grid's edge, and a batch runs
whole.

Contract: ``chunk_fn(states, start_iter, carry=None) -> (states, carry,
rows)`` as in ``ops/sg_lane_kernels.py``. Both criteria are taken per lane:
rel_iter, and residual (the continuity norm over its value at the warmup
iteration) with each lane's own normalization in the carry; the JAX lane
kernel takes rel_iter only. Dispatch is by the states' device: CPU tensors
take ``lanes_plain``, CUDA tensors launch the kernels or raise.

Launch counts: ``LAUNCHES["fv_lanes"]`` counts the kernel launches of lane
chunks; ``PLAIN_CALLS["fv_lanes"]`` counts calls of ``lanes_plain``;
``STEPS["fv_lanes"]`` the batch iterations asked of a lane chunk function,
a chunk's n once per call, kernel and plain path alike.
"""

from __future__ import annotations

import ctypes
import logging

import torch

from ..models.fv import FVState
from ..models.params import lane_kernels_on
from ..models.runner import WARMUP_ITERS, LaneCarry, fresh_carry
from . import fv_kernels as fvk

log = logging.getLogger(__name__)

__all__ = ["make_fv_lane_runner", "maybe_fv_lane_runner", "lanes_plain",
           "validate_lanes", "fv_lanes_supported", "LAUNCHES", "PLAIN_CALLS",
           "KERNELS", "reset_counts", "run_lanes", "lane_statics", "STEPS"]

KERNELS = ("fv_lanes",)
LAUNCHES = {"fv_lanes": 0}
PLAIN_CALLS = {"fv_lanes": 0}
STEPS = {"fv_lanes": 0}


def reset_counts() -> None:
    LAUNCHES["fv_lanes"] = 0
    PLAIN_CALLS["fv_lanes"] = 0
    STEPS["fv_lanes"] = 0


def validate_lanes(params_list, ops_list) -> None:
    """Lanes must share the grid, dtype, device, BiCGSTAB count,
    discretization and pressure refinement (``_validate_fv_lanes``), in a
    configuration the fused FV kernels take (``fv_kernels.validate``). Raises
    ValueError otherwise."""
    if not ops_list:
        raise ValueError("need at least one lane")
    p0, o0 = params_list[0], ops_list[0]
    for k, (p, o) in enumerate(zip(params_list[1:], ops_list[1:]), 1):
        if (o.ny, o.nx) != (o0.ny, o0.nx):
            raise ValueError(f"lane {k} grid differs from lane 0")
        if (o.dtype, o.device) != (o0.dtype, o0.device):
            raise ValueError(f"lane {k} dtype/device differs from lane 0")
        if int(p.fv_inner_iters) != int(p0.fv_inner_iters):
            raise ValueError(
                f"lane {k} fv_inner_iters differs from lane 0: the lane "
                "kernels run one shared inner count")
        for name in ("dx", "dy", "scheme", "limiter", "rhie_chow",
                     "n_refine"):
            if getattr(o, name) != getattr(o0, name):
                raise ValueError(
                    f"lane {k} FV op {name!r} differs from lane 0: the lane "
                    "kernels need a shared discretization")
    fvk.validate(o0)


def fv_lanes_supported(params_list, ops_list) -> bool:
    """True when the FV lane kernels take this batch."""
    try:
        validate_lanes(params_list, ops_list)
    except ValueError:
        return False
    return True


def _check_states(ops, B, states):
    ny, nx = ops.ny, ops.nx
    for name, t, shape in zip(FVState._fields, states,
                              ((B, ny, nx), (B, ny, nx), (B, ny, nx),
                               (B, ny, nx - 1), (B, ny - 1, nx))):
        fvk._check(f"states.{name}", t, shape, ops.dtype, ops.device)
    if ops.device.type not in ("cuda", "cpu"):
        raise ValueError("the FV lane kernels run on cuda, and their plain "
                         f"version on cpu, not on {ops.device}")
    return ops.device.type == "cuda"


def lanes_plain(S_list, states, start_iter, carry: LaneCarry, chunk,
                tolerance, warmup, K, use_residual=False):
    """The lane kernel's arithmetic in plain torch: per lane, the B=1 chunk
    kernel's plain version (``fv_kernels.chunk_body``) from the lane's
    carried flags and normalization."""
    PLAIN_CALLS["fv_lanes"] += 1
    outs = []
    for b, S in enumerate(S_list):
        f = carry.flags[b]
        outs.append(fvk.chunk_body(
            S, FVState(*(t[b] for t in states)), start_iter,
            carry.ref_norm[b], chunk, tolerance, warmup, K, use_residual,
            carry=(f[0] > 0, f[1], f[2] > 0)))
    new = FVState(*(torch.stack([o[0][i] for o in outs]) for i in range(5)))
    flags = torch.stack([torch.stack([o[k].to(torch.int32)
                                      for k in (1, 2, 3)]) for o in outs])
    return (new, LaneCarry(flags, torch.stack([o[5] for o in outs])),
            torch.stack([o[4] for o in outs], dim=1))


def lane_statics(S_list) -> dict:
    """The per-lane pointer-table entries of a batch, stacked lane-major:
    the scalar table and the boundary statics aP_bc and b_bc_u."""
    statics = {"lsc": fvk.scalar_table(S_list)}
    for name in ("aP_bc", "b_bc_u"):
        statics[name] = torch.stack([S[name] for S in S_list]).contiguous()
    return statics


def run_lanes(S_list, ops, statics, states, start_iter, carry, chunk,
              tolerance, warmup, K, use_residual):
    """One ``fv_lanes_chunk_run`` call; returns its workspace (the lanes'
    states, flags, normalizations and rows, and the last iteration's
    intermediates: ``x`` holds each lane's BiCGSTAB solution u*, v*)."""
    lib = fvk._lib()
    S0, B = S_list[0], len(S_list)
    fvk.check_launch(ops, B)
    ws = fvk.workspace(S0, ops, states, K, chunk, statics["lsc"],
                       carry.flags, lanes=B, ref_norm=carry.ref_norm,
                       aP_bc=statics["aP_bc"], b_bc_u=statics["b_bc_u"])
    counts = (ctypes.c_int * len(fvk.KERNELS))()
    rc = lib.fv_lanes_chunk_run(
        fvk._dtype_code(ops.dtype), ops.ny, ops.nx, B, fvk._ptr_table(ws),
        int(K), S0["n_refine"], int(S0["upwind"]), int(chunk),
        int(start_iter), int(warmup), int(use_residual), float(tolerance),
        counts, fvk._stream())
    LAUNCHES["fv_lanes"] += sum(int(n) for n in counts)
    fvk._raise_on(lib, rc, "fv_lanes_chunk_run")
    return ws


def make_fv_lane_runner(params_list, ops_list, chunk: int, tolerance: float,
                        warmup: int = WARMUP_ITERS, bicgstab_iters: int = 16,
                        convergence_metric: str = "rel_iter"):
    """``chunk`` fused SIMPLE iterations of every lane with per-lane state
    machines, as one device-side loop (see the module docstring)."""
    if convergence_metric not in ("rel_iter", "residual"):
        raise ValueError(
            f"chunk runners take the mapped criterion (rel_iter or "
            f"residual), not {convergence_metric!r}")
    validate_lanes(params_list, ops_list)
    ops0, B = ops_list[0], len(ops_list)
    S_list = [fvk.statics(p, o) for p, o in zip(params_list, ops_list)]
    statics = lane_statics(S_list)
    args = dict(chunk=int(chunk), tolerance=float(tolerance),
                warmup=int(warmup), K=int(bicgstab_iters),
                use_residual=convergence_metric == "residual")

    def chunk_fn(states, start_iter, carry=None):
        STEPS["fv_lanes"] += args["chunk"]
        if carry is None:
            carry = fresh_carry(B, ops0.dtype, ops0.device)
        if _check_states(ops0, B, states):
            ws = run_lanes(S_list, ops0, statics, states, start_iter, carry,
                           **args)
            return (FVState(*(ws[k] for k in FVState._fields)),
                    LaneCarry(ws["flags"], ws["ref_norm"]), ws["rows"])
        return lanes_plain(S_list, states, start_iter, carry, **args)

    return chunk_fn


def maybe_fv_lane_runner(params_list, ops_list):
    """Factory ``(chunk, tol, warmup, metric) -> chunk_fn`` of the FV lane
    kernels for this batch, or None for the plain batched path, with the
    ``use_pallas`` rules of ``ops/sg_lane_kernels.maybe_lane_runner``: false
    and auto on the CPU take the plain path; true, and auto on CUDA, take
    the kernels, and a batch they cannot take (a differing discretization,
    a configuration the fused FV kernels refuse) raises ValueError."""
    p0 = params_list[0]
    if not lane_kernels_on(p0, ops_list[0].device):
        return None
    validate_lanes(params_list, ops_list)
    K = int(p0.fv_inner_iters)
    log.info("FV lane kernels: %d lanes of %dx%d", len(params_list),
             ops_list[0].ny, ops_list[0].nx)
    return lambda chunk, tol, warmup, metric: make_fv_lane_runner(
        params_list, ops_list, chunk, tol, warmup, bicgstab_iters=K,
        convergence_metric=metric)
