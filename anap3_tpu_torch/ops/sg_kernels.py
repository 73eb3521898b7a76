"""Wrappers of the hand-written SG CUDA kernels, each beside its plain
PyTorch version.

``csrc/`` holds three kernels (sg_stage.cu, sg_diag.cu, sg_control.cu; see
the note at the top of each) and two C host entries (sg_host.cu) that this
module calls through ``ctypes``:

- ``make_sg_step(ops, with_tau=False)`` has the contract of
  ``anap3_tpu/ops/pallas_tiled.py:make_tiled_sg_step``:
  ``step(state[, tau]) -> (state, metrics)`` with the six metric keys.
- ``make_sg_chunk_runner(ops, chunk, tol, warmup, convergence_metric,
  metrics_every)`` has the contract of ``make_aligned_chunk_runner`` /
  ``make_tiled_chunk_runner``: ``chunk_fn(state, start_iter, ref_norm) ->
  (state, done, conv_iter, converged, rows[chunk, 7], ref_norm)``, rows in
  runner.METRIC_KEYS order and in the working dtype.

Dispatch is by the state's device and nothing else: a CPU tensor takes the
plain version; a CUDA tensor launches the kernels or raises (a failed build
or launch is an error, never a fall-back).

Cadence of the chunk rows: the quadratures (energy, enstrophy,
palinstrophy) are computed on the first step of a chunk and on every step
whose global index is a multiple of ``metrics_every`` (the aligned kernel's
rule); other rows hold the last sampled values. The residual-norm columns
are exact on every step, because their partial sums come out of the last
RK stage anyway; the JAX aligned kernel holds them between samples unless
the residual criterion is on.

Launch counts: ``LAUNCHES`` counts the kernel launches the wrappers made,
by kernel (sg_stage, sg_diag, sg_control); ``PLAIN_CALLS`` counts calls of
the plain versions. ``reset_counts()`` zeroes both.
"""

from __future__ import annotations

import ctypes

import torch

from ..models import spectral_sg as core
from ..models.runner import WARMUP_ITERS, control_step, freeze, rel_change
from ..models.spectral_sg import SpectralOps, SpectralState

__all__ = ["make_sg_step", "make_sg_chunk_runner", "step_plain", "chunk_plain",
           "LAUNCHES", "PLAIN_CALLS",
           "reset_counts", "ALIGNED_METRICS_EVERY", "KERNELS", "bench_kernel",
           "chunk_workspace"]

# quadratures every 16th step, the production cadence of the aligned kernel
ALIGNED_METRICS_EVERY = 16

KERNELS = ("sg_stage", "sg_diag", "sg_control")
LAUNCHES = {k: 0 for k in KERNELS}
PLAIN_CALLS = {"sg_step": 0, "sg_chunk": 0}

# pointer-table order of csrc/sg_common.cuh:Ptr
_PTR_NAMES = (
    "Dx", "DyT", "Dxx", "DyyT", "Ix", "IyT", "Gx", "GyT", "bc_u", "bc_v",
    "W2d", "sing_u", "sing_v", "sing_dudx", "sing_dudy", "sing_dvdx",
    "sing_dvdy", "sing_w", "sing_dwx", "sing_dwy",
    "u", "v", "p", "au", "av", "ap", "bu", "bv", "bp",
    "left", "omega", "part", "qpart", "scal", "tau_u", "tau_v", "tau_p",
    "metrics", "rows", "flags", "ref_norm")
_OP_NAMES = _PTR_NAMES[:20]
_NPART, _NQPART, _NSCAL = 5, 3, 6  # csrc/sg_common.cuh
_TILE = 16


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in PLAIN_CALLS:
        PLAIN_CALLS[k] = 0


def _scalars(ops: SpectralOps):
    vals = (ops.nu, ops.beta_sq, ops.CFL, ops.lid_velocity, ops.inv_dx_min,
            ops.inv_dy_min)
    return (ctypes.c_double * len(vals))(*vals)


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


def _workspace(ops: SpectralOps, **bufs) -> dict:
    nf, ni = ops.nf, ops.nf - 2
    tiles = (nf + _TILE - 1) // _TILE
    nb = tiles * tiles
    kw = dict(dtype=ops.dtype, device=ops.device)
    ws = {name: getattr(ops, name) for name in _OP_NAMES}
    ws.update(
        au=torch.empty((nf, nf), **kw), av=torch.empty((nf, nf), **kw),
        ap=torch.empty((ni, ni), **kw),
        left=torch.empty(4 * nf * nf + 2 * nf * ni, **kw),
        omega=torch.empty((nf, nf), **kw),
        part=torch.empty((nb, _NPART), **kw),
        qpart=torch.empty((nb, _NQPART), **kw),
        scal=torch.zeros(_NSCAL, **kw))
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


def _count(counts):
    for k, n in zip(KERNELS, counts):
        LAUNCHES[k] += int(n)


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


def _step_kernel(ops, state, tau=None):
    from ._build import load_library

    lib = load_library("sg")
    nf, ni = ops.nf, ops.nf - 2
    taus = {}
    if tau is not None:
        for name, t, shape in zip(("tau_u", "tau_v", "tau_p"), tau,
                                  ((nf, nf), (nf, nf), (ni, ni))):
            _check(name, t, shape, ops.dtype, ops.device)
            taus[name] = t
    out = SpectralState(torch.empty_like(state.u), torch.empty_like(state.v),
                        torch.empty_like(state.p))
    metrics = torch.empty(6, dtype=ops.dtype, device=ops.device)
    ws = _workspace(ops, u=state.u, v=state.v, p=state.p, bu=out.u,
                    bv=out.v, bp=out.p, metrics=metrics, **taus)
    counts = (ctypes.c_int * 3)()
    rc = lib.sg_step_run(_dtype_code(ops.dtype), nf, _ptr_table(ws),
                         _scalars(ops), int(tau is not None), counts,
                         _stream())
    _count(counts)
    _raise_on(lib, rc, "sg_step_run")
    keys = ("u_eq", "v_eq", "continuity", "energy", "enstrophy",
            "palinstrophy")
    return out, dict(zip(keys, metrics.unbind()))


def make_sg_step(ops: SpectralOps, with_tau: bool = False):
    """One RK4 step with its six metrics: ``step(state) -> (state,
    metrics)``, or ``step(state, (tau_u, tau_v, tau_p))`` with the FAS
    forcing added to every stage residual when ``with_tau``."""
    _check_ops(ops)

    def run(state, tau):
        if _on_cuda(ops, state):
            return _step_kernel(ops, state, tau)
        return step_plain(ops, state, tau)

    return run if with_tau else (lambda state: run(state, None))


# ---------------------------------------------------------------- chunk


def chunk_plain(ops, state, start_iter, ref_norm, chunk, tolerance, warmup,
                 use_residual, metrics_every):
    """The chunk kernel's arithmetic in plain torch, at its cadence."""
    PLAIN_CALLS["sg_chunk"] += 1
    dev, dtype = ops.device, ops.dtype
    done = torch.zeros((), dtype=torch.bool, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    conv_iter = torch.full((), -1, dtype=torch.int32, device=dev)
    ref_norm = torch.as_tensor(ref_norm, dtype=dtype, device=dev)
    held = None
    rows = []
    for i in range(chunk):
        idx = int(start_iter) + i
        new, (R_u, R_v, R_p) = core.rk4_step(ops, state)
        if i == 0 or idx % metrics_every == 0:
            held = torch.stack(core.conserved_quantities(ops, new.u, new.v))
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
                    ref_norm) -> dict:
    """Fresh output tensors (the chunk's state starts as a copy of
    ``state``) plus scratch, for one kernel chunk."""
    kw = dict(dtype=ops.dtype, device=ops.device)
    flags = torch.tensor([0, -1, 0], dtype=torch.int32, device=ops.device)
    return _workspace(
        ops, u=state.u.clone(), v=state.v.clone(), p=state.p.clone(),
        bu=torch.empty_like(state.u), bv=torch.empty_like(state.v),
        bp=torch.empty_like(state.p), rows=torch.empty((chunk, 7), **kw),
        flags=flags,
        ref_norm=torch.as_tensor(ref_norm, **kw).reshape(1).clone())


def _chunk_kernel(ops, state, start_iter, ref_norm, chunk, tolerance, warmup,
                  use_residual, metrics_every):
    from ._build import load_library

    lib = load_library("sg")
    ws = chunk_workspace(ops, state, chunk, ref_norm)
    counts = (ctypes.c_int * 3)()
    rc = lib.sg_chunk_run(_dtype_code(ops.dtype), ops.nf, _ptr_table(ws),
                          _scalars(ops), int(chunk), int(start_iter),
                          int(warmup), int(metrics_every), int(use_residual),
                          float(tolerance), counts, _stream())
    _count(counts)
    _raise_on(lib, rc, "sg_chunk_run")
    flags = ws["flags"]
    return (SpectralState(ws["u"], ws["v"], ws["p"]), flags[0] > 0,
            flags[1], flags[2] > 0, ws["rows"], ws["ref_norm"][0])


def make_sg_chunk_runner(ops: SpectralOps, chunk: int, tolerance: float,
                         warmup: int = WARMUP_ITERS,
                         convergence_metric: str = "rel_iter",
                         metrics_every: int = ALIGNED_METRICS_EVERY):
    """``chunk`` RK4 steps with the convergence state machine, as one
    device-side loop (see the module docstring for the contract)."""
    if convergence_metric not in ("rel_iter", "residual"):
        raise ValueError(
            f"chunk runners take the mapped criterion (rel_iter or "
            f"residual), not {convergence_metric!r}")
    _check_ops(ops)
    args = dict(chunk=int(chunk), tolerance=float(tolerance),
                warmup=int(warmup),
                use_residual=convergence_metric == "residual",
                metrics_every=max(1, int(metrics_every)))

    def chunk_fn(state, start_iter, ref_norm):
        if _on_cuda(ops, state):
            return _chunk_kernel(ops, state, start_iter, ref_norm, **args)
        return chunk_plain(ops, state, start_iter, ref_norm, **args)

    return chunk_fn


def bench_kernel(ops: SpectralOps, ws: dict, which: str, reps: int) -> None:
    """Enqueue ``reps`` launches of one kernel on a chunk workspace, for
    timing only (not counted in LAUNCHES): "sg_stage" is one last-stage
    left+row pair, "sg_diag" the dt and quadrature launches, "sg_control"
    one sampled-step control launch."""
    from ._build import load_library

    lib = load_library("sg")
    rc = lib.sg_bench_run(_dtype_code(ops.dtype), ops.nf, _ptr_table(ws),
                          _scalars(ops), KERNELS.index(which), int(reps),
                          _stream())
    _raise_on(lib, rc, f"sg_bench_run({which})")
