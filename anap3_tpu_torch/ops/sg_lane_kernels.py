"""Sweep lanes through the SG CUDA kernels: B solves of one order per launch.

The counterpart of ``anap3_tpu/ops/pallas_lanes.py`` (``maybe_lane_runner``,
``make_lane_chunk_runner``: TPU kernel #9) and
``anap3_tpu/ops/pallas_lanes_aligned.py`` (``aligned_lanes_supported``,
``make_aligned_lane_runner``: #10). On the card a lane is a grid axis, not a
layout: ``csrc/sg_host.cu:sg_lanes_chunk_run`` runs the kernels of
``ops/sg_kernels.py`` with every launch covering all lanes (lane b's blocks
run the one-lane code on lane b's buffers and scalars), so lane b of a
B-lane chunk gives the bits of a one-lane ``sg_chunk_run`` on its data, in
float32 and float64. The Pallas tiled and aligned lane kernels differ on the
card only by the quadrature cadence, so one family closes both:

- ``metrics_every = 16`` (``ALIGNED_METRICS_EVERY``) where the JAX dispatch
  takes the aligned lane kernel, N % 8 == 0 and 32 <= N <= 320
  (``pallas_aligned.aligned_supported``);
- ``metrics_every = 1`` elsewhere, the tiled lane kernel's rows.

The row-stacked layouts, bordered cores and VMEM lane budgets of the TPU
kernels are not ported: a batch runs whole. A batch that mixes corner modes
(singular and regularized lids) runs as one lane group per mode, each group
through the kernels, within one chunk function.

Contract of a lane chunk function (the B=1 chunk runner's, per lane, with
the state machine carried between chunks)::

    chunk_fn(states, start_iter, carry=None) -> (states, carry, rows)

``states`` holds (B, ...) fields, ``carry`` is a ``runner.LaneCarry`` (flags
(B, 3) int32: done, conv_iter, converged; residual normalization (B,)),
fresh when None, and ``rows`` is (chunk, B, 7) in runner.METRIC_KEYS order.
A lane done in an earlier chunk stays frozen with NaN rows. The JAX lane
kernels restart every chunk with no lane done instead (see ROADMAP Queue 3).
Both criteria are taken per lane: rel_iter, and residual with each lane's
own normalization.

Dispatch is by the states' device: CPU tensors take ``lanes_plain``, the
kernel's arithmetic at its cadence, lane by lane; CUDA tensors launch the
kernels or raise. ``plain_lane_runner`` is the plain batched path of SG
lanes: ``lanes_plain`` with quadratures every step on any device.

Where ``sg_kernels.resident_geometry`` takes the order, a lane chunk is one
launch of the resident kernel (``csrc/sg_resident.cu``, a thread-block
cluster a lane, ``sg_resident_chunk_run``), with the multi-launch chunk's
outputs bit for bit.

Launch counts: ``LAUNCHES`` counts the kernel launches of lane chunks by the
TPU kernel they stand for ("sg_lanes_tiled": #9, "sg_lanes_aligned": #10),
the resident kernel's apart ("sg_lanes_resident", #9 and #10 alike);
``PLAIN_CALLS["sg_lanes"]`` counts calls of ``lanes_plain``;
``STEPS["sg_lanes"]`` the batch steps asked of a lane chunk function, a
chunk's n once per call of a batch (of each corner-mode group), kernel and
plain path alike.
"""

from __future__ import annotations

import logging

import torch

from ..models.runner import WARMUP_ITERS, LaneCarry, fresh_carry
from ..models.spectral_sg import SpectralState
from ..models.params import lane_kernels_on
from ..utils.profiling import span
from . import sg_kernels as sgk

log = logging.getLogger(__name__)

__all__ = ["make_lane_chunk_runner", "maybe_lane_runner",
           "plain_lane_runner", "sg_lane_runner", "lanes_plain",
           "validate_lanes",
           "aligned_supported", "aligned_lanes_supported",
           "lane_metrics_every", "LAUNCHES", "PLAIN_CALLS", "KERNELS",
           "reset_counts", "MAX_ALIGNED_N", "STEPS"]

# the aligned tier's order cap, smoothed and singular
# (anap3_tpu/ops/pallas_aligned.py MAX_ALIGNED_N, MAX_ALIGNED_SINGULAR_N)
MAX_ALIGNED_N = 320
KERNELS = ("sg_lanes_tiled", "sg_lanes_aligned", "sg_lanes_resident")
LAUNCHES = {k: 0 for k in KERNELS}
PLAIN_CALLS = {"sg_lanes": 0}
STEPS = {"sg_lanes": 0}

_SHARED = ("Dx", "DyT", "Dxx", "DyyT", "Ix", "IyT", "Gx", "GyT", "interior",
           "W2d")
_PER_LANE = ("bc_u", "bc_v", "sing_u", "sing_v", "sing_dudx", "sing_dudy",
             "sing_dvdx", "sing_dvdy", "sing_w", "sing_dwx", "sing_dwy")


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in PLAIN_CALLS:
        PLAIN_CALLS[k] = 0
    STEPS["sg_lanes"] = 0


def aligned_supported(n: int) -> bool:
    """True where the JAX package takes its aligned lane kernel: N % 8 == 0
    and 32 <= N <= 320 (smoothed and singular lids share the cap)."""
    return n % 8 == 0 and 32 <= n <= MAX_ALIGNED_N


def lane_metrics_every(n: int) -> int:
    """The quadrature cadence of the JAX lane kernel this batch would take:
    16 on the aligned kernel, every step on the tiled one."""
    return sgk.ALIGNED_METRICS_EVERY if aligned_supported(n) else 1


def validate_lanes(ops_list) -> None:
    """Lanes must share every operator matrix (same N, basis and domain),
    dtype and device, and one corner mode, at an order the kernels take
    (``sg_kernels.MAX_KERNEL_N``); scalars, boundary values and the
    singular fields may differ. Raises ValueError otherwise."""
    if not ops_list:
        raise ValueError("need at least one lane")
    o0 = ops_list[0]
    if o0.nf - 1 > sgk.MAX_KERNEL_N:
        raise ValueError(f"N={o0.nf - 1} is above the SG kernels' largest "
                         f"order {sgk.MAX_KERNEL_N}")
    for k, o in enumerate(ops_list[1:], 1):
        if (o.dtype, o.device) != (o0.dtype, o0.device):
            raise ValueError(f"lane {k} dtype/device differs from lane 0")
        if o.singular != o0.singular:
            raise ValueError("the lane kernels need one corner mode across "
                             f"lanes (lane {k} differs from lane 0)")
        # a span a lane: a batch's comparisons hold many of the
        # profiler's events
        with span("level.setup"):
            for name in _SHARED:
                a, b = getattr(o0, name), getattr(o, name)
                if a.shape != b.shape or not torch.equal(a, b):
                    raise ValueError(
                        f"lane {k} operator {name!r} differs from lane 0: "
                        "lane-batched kernels need shared operators")


def aligned_lanes_supported(ops_list) -> bool:
    """True when the JAX dispatch would take the aligned lane kernel for
    this batch (its order and shared operators; the VMEM budget is not
    ported)."""
    try:
        validate_lanes(ops_list)
    except ValueError:
        return False
    return aligned_supported(ops_list[0].nf - 1)


def _check_states(ops, B, states):
    nf, ni = ops.nf, ops.nf - 2
    for name, t, shape in zip(SpectralState._fields, states,
                              ((B, nf, nf), (B, nf, nf), (B, ni, ni))):
        sgk._check(f"states.{name}", t, shape, ops.dtype, ops.device)
    if ops.device.type not in ("cuda", "cpu"):
        raise ValueError("the SG lane kernels run on cuda, and their plain "
                         f"version on cpu, not on {ops.device}")
    return ops.device.type == "cuda"


def lanes_plain(ops_list, states, start_iter, carry: LaneCarry, chunk,
                tolerance, warmup, use_residual, metrics_every):
    """The lane kernel's arithmetic in plain torch: per lane, the B=1 chunk
    kernel's plain version (``sg_kernels.chunk_body``) from the lane's
    carried flags."""
    PLAIN_CALLS["sg_lanes"] += 1
    outs = []
    for b, ops in enumerate(ops_list):
        f = carry.flags[b]
        outs.append(sgk.chunk_body(
            ops, SpectralState(*(t[b] for t in states)), start_iter,
            carry.ref_norm[b], chunk, tolerance, warmup, use_residual,
            metrics_every, carry=(f[0] > 0, f[1], f[2] > 0)))
    new = SpectralState(*(torch.stack([o[0][i] for o in outs])
                          for i in range(3)))
    flags = torch.stack([torch.stack([o[k].to(torch.int32)
                                      for k in (1, 2, 3)]) for o in outs])
    return (new, LaneCarry(flags, torch.stack([o[5] for o in outs])),
            torch.stack([o[4] for o in outs], dim=1))


def _lane_statics(ops_list) -> dict:
    """The per-lane pointer-table entries, stacked lane-major once per
    runner: boundary values, singular fields (None in the regularized
    modes) and the scalar table."""
    out = {"lsc": sgk.scalar_table(ops_list)}
    for name in _PER_LANE:
        vals = [getattr(o, name) for o in ops_list]
        out[name] = None if vals[0] is None else torch.stack(vals).contiguous()
    return out


def _lanes_kernel(ops_list, statics, states, start_iter, carry, chunk,
                  tolerance, warmup, use_residual, metrics_every):
    from ._build import load_library

    lib = load_library("sg")
    ops0, B = ops_list[0], len(ops_list)
    ws = sgk._workspace(
        ops0, lanes=B, **statics,
        u=states.u.clone(), v=states.v.clone(), p=states.p.clone(),
        bu=torch.empty_like(states.u), bv=torch.empty_like(states.v),
        bp=torch.empty_like(states.p),
        rows=torch.empty((chunk, B, 7), dtype=ops0.dtype, device=ops0.device),
        flags=carry.flags.clone(), ref_norm=carry.ref_norm.clone())
    if sgk.resident_geometry(ops0.nf, ops0.dtype, B) is not None:
        sgk._run_resident(ops0, B, ws, chunk, start_iter, warmup,
                          metrics_every, use_residual, tolerance, LAUNCHES,
                          "sg_lanes_resident")
    else:
        counts = sgk._new_counts()
        # sweeps pass no matmul algorithm (exact products: x1 = 0)
        rc = lib.sg_lanes_chunk_run(sgk._dtype_code(ops0.dtype), ops0.nf,
                                    sgk._geo(ops0, B), B, sgk._ptr_table(ws),
                                    int(chunk), int(start_iter), int(warmup),
                                    int(metrics_every), int(use_residual),
                                    float(tolerance), 0,
                                    sgk._tail_blocks(ops0, B, lib), counts,
                                    sgk._stream())
        key = "sg_lanes_tiled" if metrics_every == 1 else "sg_lanes_aligned"
        LAUNCHES[key] += sum(int(n) for n in counts[:len(sgk.KERNELS)])
        sgk._raise_on(lib, rc, "sg_lanes_chunk_run")
        sgk._check_launches(counts, chunk, start_iter, metrics_every)
    return (SpectralState(ws["u"], ws["v"], ws["p"]),
            LaneCarry(ws["flags"], ws["ref_norm"]), ws["rows"])


def _check_metric(convergence_metric):
    if convergence_metric not in ("rel_iter", "residual"):
        raise ValueError(
            f"chunk runners take the mapped criterion (rel_iter or "
            f"residual), not {convergence_metric!r}")


def make_lane_chunk_runner(ops_list, chunk: int, tolerance: float,
                           warmup: int = WARMUP_ITERS,
                           convergence_metric: str = "rel_iter"):
    """``chunk`` RK4 steps of every lane with per-lane state machines, as
    one device-side loop, quadratures at the JAX dispatch's cadence (see
    the module docstring for the contract)."""
    _check_metric(convergence_metric)
    validate_lanes(ops_list)
    for o in ops_list:
        sgk._check_ops(o)
    ops0, B = ops_list[0], len(ops_list)
    args = dict(chunk=int(chunk), tolerance=float(tolerance),
                warmup=int(warmup),
                use_residual=convergence_metric == "residual",
                metrics_every=lane_metrics_every(ops0.nf - 1))
    with span("level.setup"):
        statics = _lane_statics(ops_list)

    def chunk_fn(states, start_iter, carry=None):
        STEPS["sg_lanes"] += args["chunk"]
        if carry is None:
            carry = fresh_carry(B, ops0.dtype, ops0.device)
        if _check_states(ops0, B, states):
            return _lanes_kernel(ops_list, statics, states, start_iter,
                                 carry, **args)
        return lanes_plain(ops_list, states, start_iter, carry, **args)

    return chunk_fn


def plain_lane_runner(ops_list):
    """Factory ``(chunk, tol, warmup, metric) -> chunk_fn`` of the plain
    batched path: ``lanes_plain`` with quadratures every step, on the
    states' device (the plain batched chunk of ``parallel/sweep.py`` with
    ``sg_step``, bit for bit). Lanes may mix corner modes."""
    def factory(chunk, tol, warmup, metric):
        _check_metric(metric)
        o0, B = ops_list[0], len(ops_list)
        args = dict(chunk=int(chunk), tolerance=float(tol),
                    warmup=int(warmup), use_residual=metric == "residual",
                    metrics_every=1)

        def chunk_fn(states, start_iter, carry=None):
            STEPS["sg_lanes"] += args["chunk"]
            if carry is None:
                carry = fresh_carry(B, o0.dtype, o0.device)
            return lanes_plain(ops_list, states, start_iter, carry, **args)

        return chunk_fn

    return factory


def _grouped(groups, runners, B):
    """One chunk function over lane groups (index lists): each group's
    lanes go through its own runner and come back to their places."""
    sels = None

    def chunk_fn(states, start_iter, carry=None):
        nonlocal sels
        dev = states[0].device
        if sels is None:
            sels = [torch.tensor(g, device=dev) for g in groups]
        if carry is None:
            carry = fresh_carry(B, states[0].dtype, dev)
        outs = [run(type(states)(*(t.index_select(0, sel) for t in states)),
                    start_iter, LaneCarry(carry.flags.index_select(0, sel),
                                          carry.ref_norm.index_select(0, sel)))
                for sel, run in zip(sels, runners)]
        new = [torch.empty_like(t) for t in states]
        flags, ref = torch.empty_like(carry.flags), torch.empty_like(
            carry.ref_norm)
        rows = outs[0][2].new_empty((outs[0][2].shape[0], B)
                                    + outs[0][2].shape[2:])
        for sel, (st, c, r) in zip(sels, outs):
            for dst, src in zip(new, st):
                dst.index_copy_(0, sel, src)
            flags.index_copy_(0, sel, c.flags)
            ref.index_copy_(0, sel, c.ref_norm)
            rows.index_copy_(1, sel, r)
        return type(states)(*new), LaneCarry(flags, ref), rows

    return chunk_fn


def maybe_lane_runner(ops_list, params):
    """Factory ``(chunk, tol, warmup, metric) -> chunk_fn`` of the lane
    kernels for this batch, or None for the plain batched path
    (``plain_lane_runner``).

    ``params.use_pallas``: false, and auto on the CPU, take the plain path;
    true, and auto on CUDA, take the lane kernels (their plain version on
    CPU tensors). A batch that mixes corner modes runs one lane group per
    mode; a batch the kernels cannot take (differing operators, dtypes or
    devices) raises ValueError, never the plain path."""
    ops0 = ops_list[0]
    if not lane_kernels_on(params, ops0.device):
        return None
    groups = {}
    for b, o in enumerate(ops_list):
        groups.setdefault(o.singular, []).append(b)
    groups = list(groups.values())
    for g in groups:
        validate_lanes([ops_list[b] for b in g])
    log.info("SG lane kernels: %d lanes of N=%d in %d corner-mode group(s), "
             "quadratures every %d step(s)", len(ops_list), ops0.nf - 1,
             len(groups), lane_metrics_every(ops0.nf - 1))
    if len(groups) == 1:
        return lambda chunk, tol, warmup, metric: make_lane_chunk_runner(
            ops_list, chunk, tol, warmup, metric)
    return lambda chunk, tol, warmup, metric: _grouped(
        groups, [make_lane_chunk_runner([ops_list[b] for b in g], chunk, tol,
                                        warmup, metric) for g in groups],
        len(ops_list))


def sg_lane_runner(ops_list, params):
    """``lanes -> factory``: the chunk-runner factory of the lanes
    ``ops_list[lanes]`` (a slice) of this batch, the lane kernels where
    ``maybe_lane_runner`` takes them, else ``plain_lane_runner``. A sweep
    over a mesh calls it with each rank's own lanes
    (``parallel/sweep.run_batched_sweep``'s ``lane_runner``)."""
    def for_lanes(lanes: slice):
        part = list(ops_list[lanes])
        return maybe_lane_runner(part, params) or plain_lane_runner(part)

    return for_lanes
