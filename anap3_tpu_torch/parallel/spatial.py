"""Tensor-parallel spectral stepping: one SG solve sharded over ranks.

The counterpart of ``anap3_tpu/parallel/spatial.py`` on
``torch.distributed``, with its formulation. Every state array is
(N+1, N+1), rows = x index, and each rank of the ``"x"`` group holds one
block of rows; the PN-PN-2 inner-grid pressure is EMBEDDED in a full-grid
array with a zero boundary ring, so every array shares one row split and no
cross-block slicing is needed::

    du/dy  = U_loc @ Dy^T                                (local)
    du/dx  = reduce_scatter(Dx[:, cols] @ U_loc)         (one collective)
    dp/dx  = reduce_scatter(GxP[:, cols] @ P_loc) @ IyP^T
    dp/dy  = reduce_scatter(IxP[:, cols] @ P_loc) @ GyP^T

with GxP = Dx IxP and IxP the inner-to-full interpolation padded with zero
boundary columns. The x-direction partial products of one RK stage share
one reduce-scatter (the JAX package issues one ``psum_scatter`` each and
lets XLA schedule them), and a chunk step's vorticity takes the next
step's first products: 4 reduce-scatters a step. The CFL maxima are one
``all_reduce(MAX)`` and a chunk step's norms and quadratures one
``all_reduce(SUM)``, so dt, the criterion and every history row are the
same on every rank. A leading
batch (sweep) axis composes: the lanes of the batched step may be split
over a ``"sweep"`` mesh dimension.

A ``mesh`` is a ``DeviceMesh`` with an ``"x"`` dimension (and a
``"sweep"`` one for the batched step), or a ``ProcessGroup`` whose ranks
are the row blocks in rank order. The products stay ``torch.matmul``, as
JAX computes them with ``jnp.matmul`` outside any Pallas kernel: this
module launches no kernel of the port.

``spatial_mesh_from_config`` takes every rank or none, where JAX takes the
first n devices for the largest divisor n of the row count: with one
process a card, the ranks left over would hold no rows.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models import spectral_sg as core
from ..models.params import SpectralParameters
from ..models.runner import WARMUP_ITERS, control_step
from ..utils.checkpoint import CheckpointManager

__all__ = ["ShardedSpectralOps", "build_sharded_ops", "shard_ops",
           "make_sharded_step", "make_sharded_chunk_runner", "shard_state",
           "gather_state", "pad_pressure", "unpad_pressure",
           "spatial_mesh_from_config", "mesh_axis",
           "ShardedCheckpointManager"]

# the collective's name moved in recent releases; gloo and NCCL take both
_REDUCE_SCATTER = (dist.reduce_scatter_single
                   if hasattr(dist, "reduce_scatter_single")
                   else dist.reduce_scatter_tensor)


def spatial_mesh_from_config(machine_cfg: dict, nf: int, device="cuda"):
    """The ``("x",)`` mesh that ``machine.mesh_axes`` asks for: every rank
    of the initialized process group when ``"x"`` is requested, there are
    at least two ranks and their count divides the row count ``nf``; None
    otherwise."""
    axes = machine_cfg.get("mesh_axes") or []
    if "x" not in axes or not dist.is_initialized():
        return None
    world = dist.get_world_size()
    if world <= 1 or nf % world:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, (world,),
                            mesh_dim_names=("x",))


def mesh_axis(mesh, axis: str = "x") -> Tuple[object, int, int]:
    """(process group, this rank's index in it, its size) of the mesh
    dimension ``axis``, or of ``mesh`` itself when it is a process
    group."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        group = mesh if mesh is not None else dist.group.WORLD
        return group, dist.get_rank(group), dist.get_world_size(group)
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} dimension: {names}")
    dim = tuple(names).index(axis)
    return mesh.get_group(dim), mesh.get_local_rank(dim), mesh.size(dim)


@dataclass
class ShardedSpectralOps:
    """Operator set for the sharded step (padded-pressure formulation),
    every field a tensor (the scalars 0-d)."""

    Dx: torch.Tensor      # (nf, nf) - split by columns
    Dxx: torch.Tensor     # (nf, nf) - split by columns
    DyT: torch.Tensor     # (nf, nf) - whole
    DyyT: torch.Tensor    # (nf, nf) - whole
    GxP: torch.Tensor     # (nf, nf) = Dx @ IxP - split by columns
    IxP: torch.Tensor     # (nf, nf) padded interpolation - split by columns
    IyPT: torch.Tensor    # (nf, nf) - whole
    GyPT: torch.Tensor    # (nf, nf) = (Dy @ IyP)^T - whole
    bc_u: torch.Tensor    # (nf, nf) - split by rows
    bc_v: torch.Tensor
    interior: torch.Tensor   # velocity interior mask (0/1) - split by rows
    p_mask: torch.Tensor     # inner-grid mask of the padded pressure
    W2d: torch.Tensor        # quadrature weights - split by rows
    nu: torch.Tensor
    beta_sq: torch.Tensor
    CFL: torch.Tensor
    lid_velocity: torch.Tensor
    inv_dx_min: torch.Tensor
    inv_dy_min: torch.Tensor


# the fields each rank keeps a column block / row block of
# (anap3_tpu/parallel/spatial.py make_step_ops_spec)
_COLS = ("Dx", "Dxx", "GxP", "IxP")
_ROWS = ("bc_u", "bc_v", "interior", "p_mask", "W2d")


def _pad_cols(M: np.ndarray) -> np.ndarray:
    """(nf, ni) -> (nf, nf) with zero first/last columns."""
    nf = M.shape[0]
    out = np.zeros((nf, nf))
    out[:, 1:-1] = M
    return out


def build_sharded_ops(params: SpectralParameters, n: Optional[int] = None,
                      dtype=None, device=None
                      ) -> Tuple[ShardedSpectralOps, dict]:
    """The whole operator set (every rank's blocks) and the grid, built in
    float64 on the host and cast to ``dtype`` (default ``params.dtype``) on
    ``device`` (default ``params.device``). ``shard_ops`` takes a rank's
    part."""
    base, grid = core.build_spectral_ops(params, n=n, dtype=torch.float64,
                                         device="cpu")
    dtype = getattr(torch, str(params.dtype)) if dtype is None else dtype
    device = torch.device(params.device if device is None else device)
    nf = grid["shape_full"][0]
    IxP = _pad_cols(np.asarray(grid["Ix"]))
    IyP = _pad_cols(np.asarray(grid["Iy"]))
    p_mask = np.zeros((nf, nf))
    p_mask[1:-1, 1:-1] = 1.0
    host = {
        "Dx": grid["Dx"], "Dxx": grid["Dxx"], "DyT": grid["Dy"].T,
        "DyyT": grid["Dyy"].T, "GxP": grid["Dx"] @ IxP, "IxP": IxP,
        "IyPT": IyP.T, "GyPT": (grid["Dy"] @ IyP).T,
        "bc_u": base.bc_u.numpy(), "bc_v": base.bc_v.numpy(),
        "interior": base.interior.numpy().astype(float), "p_mask": p_mask,
        "W2d": base.W2d.numpy(),
    }
    host.update({k: getattr(base, k) for k in (
        "nu", "beta_sq", "CFL", "lid_velocity", "inv_dx_min", "inv_dy_min")})
    ops = ShardedSpectralOps(**{
        k: torch.as_tensor(np.array(v, np.float64, order="C"), dtype=dtype,
                           device=device) for k, v in host.items()})
    return ops, grid


def shard_ops(ops: ShardedSpectralOps, rank: int,
              world: int) -> ShardedSpectralOps:
    """Rank ``rank``'s part of ``world``: column blocks of Dx, Dxx, GxP and
    IxP, row blocks of bc_u, bc_v, interior, p_mask and W2d, the rest
    whole."""
    nf = int(ops.Dx.shape[0])
    if nf % world:
        raise ValueError(f"grid rows ({nf}) must divide over {world} ranks")
    k = nf // world
    blk = slice(rank * k, (rank + 1) * k)
    parts = {}
    for f in fields(ops):
        t = getattr(ops, f.name)
        if f.name in _COLS:
            t = t[:, blk].contiguous()
        elif f.name in _ROWS:
            t = t[blk].contiguous()
        parts[f.name] = t
    return ShardedSpectralOps(**parts)


def pad_pressure(p_inner: torch.Tensor) -> torch.Tensor:
    nf = p_inner.shape[-1] + 2
    out = p_inner.new_zeros(p_inner.shape[:-2] + (nf, nf))
    out[..., 1:-1, 1:-1] = p_inner
    return out


def unpad_pressure(p_pad: torch.Tensor) -> torch.Tensor:
    return p_pad[..., 1:-1, 1:-1]


def _dx_apply(pairs, group, world):
    """x-direction operator applies ``A[:, cols] @ F_rows`` of every (A, F)
    pair: the local partial products, summed over the group and scattered
    by rows in one collective. Returns the row blocks, in pair order."""
    parts = torch.stack([A @ F for A, F in pairs])   # (P, ..., nf, nf)
    rows_first = parts.movedim(-2, 0).contiguous()   # (nf, P, ..., nf)
    out = rows_first.new_empty((rows_first.shape[0] // world,)
                               + rows_first.shape[1:])
    _REDUCE_SCATTER(out, rows_first, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, -2).unbind(0)


class _Axis:
    """The x group of a mesh: its process group and size."""

    def __init__(self, mesh):
        self.group, self.rank, self.world = mesh_axis(mesh, "x")

    def dx(self, *pairs):
        return _dx_apply(pairs, self.group, self.world)

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.group)
        return t


def _x_products(ops: ShardedSpectralOps, u, v, p, x: _Axis):
    """The x-direction products of one residual evaluation, row blocks:
    Dx u, Dx v, Dxx u, Dxx v, GxP p, IxP p (one reduce-scatter)."""
    return x.dx((ops.Dx, u), (ops.Dx, v), (ops.Dxx, u), (ops.Dxx, v),
                (ops.GxP, p), (ops.IxP, p))


def _rk4_local(ops: ShardedSpectralOps, u, v, p, x: _Axis, first=None):
    """One RK4 pseudo-timestep on LOCAL row blocks, (nloc, nf) or with a
    leading lane axis (B, nloc, nf). ``first``: the first stage's
    ``_x_products`` of (u, v, p), when the caller has them.

    Returns (u, v, p, (R_u, R_v, R_p)) with the last stage's residuals for
    the runner's algebraic-residual metrics.
    """
    def residuals(u, v, p, prods):
        du_dx, dv_dx, d2u, d2v, gp, ip = prods
        du_dy = u @ ops.DyT
        dv_dy = v @ ops.DyT
        lap_u = d2u + u @ ops.DyyT
        lap_v = d2v + v @ ops.DyyT
        dp_dx = gp @ ops.IyPT
        dp_dy = ip @ ops.GyPT
        R_u = -(u * du_dx + v * du_dy) - dp_dx + ops.nu * lap_u
        R_v = -(u * dv_dx + v * dv_dy) - dp_dy + ops.nu * lap_v
        R_p = -ops.beta_sq * (du_dx + dv_dy) * ops.p_mask
        return R_u, R_v, R_p

    def enforce(u, v):
        u = ops.interior * u + (1.0 - ops.interior) * ops.bc_u
        v = ops.interior * v + (1.0 - ops.interior) * ops.bc_v
        return u, v

    # global CFL timestep (per lane): local maxima + one all-reduce
    maxima = x.all_reduce(torch.stack([u.abs().amax(dim=(-2, -1)),
                                       v.abs().amax(dim=(-2, -1))]),
                          dist.ReduceOp.MAX)
    u_max = torch.maximum(maxima[0], ops.lid_velocity)
    v_max = torch.maximum(maxima[1], maxima.new_tensor(1e-10))
    lam_x = (u_max + torch.sqrt(u_max**2 + ops.beta_sq)) * ops.inv_dx_min \
        + ops.nu * ops.inv_dx_min**2
    lam_y = (v_max + torch.sqrt(v_max**2 + ops.beta_sq)) * ops.inv_dy_min \
        + ops.nu * ops.inv_dy_min**2
    dt = (ops.CFL / (lam_x + lam_y))[..., None, None]

    u0, v0, p0 = u, v, p
    R_u = R_v = R_p = None
    for alpha in core.RK4_ALPHAS:
        if first is None:
            first = _x_products(ops, u, v, p, x)
        R_u, R_v, R_p = residuals(u, v, p, first)
        first = None
        u = u0 + (alpha * dt) * R_u
        v = v0 + (alpha * dt) * R_v
        p = (p0 + (alpha * dt) * R_p) * ops.p_mask
        u, v = enforce(u, v)
    return u, v, p, (R_u, R_v, R_p)


def make_sharded_step(mesh):
    """The RK4 step on this rank's blocks: ``step(ops, u, v, p_pad) ->
    (u, v, p_pad)`` with ``ops`` from ``shard_ops`` and the state's rows
    split over ``mesh["x"]``. A state with a leading lane axis (this rank's
    lanes, ``shard_state(..., batch_axis=...)``) steps each lane with its
    own dt; the JAX step's ``batch_axis`` only names those lanes'
    sharding, which the local blocks already are."""
    x = _Axis(mesh)

    def step(ops: ShardedSpectralOps, u, v, p):
        u, v, p, _R = _rk4_local(ops, u, v, p, x)
        return u, v, p

    return step


def make_sharded_chunk_runner(mesh, ops_sharded: ShardedSpectralOps,
                              chunk: int, tolerance: float,
                              warmup: int = WARMUP_ITERS,
                              convergence_metric: str = "rel_iter"):
    """Chunked convergence runner over the sharded step.

    The port's chunk contract (``models/runner.py``): ``chunk_fn(state,
    start_iter, ref_norm) -> (state, done, conv_iter, converged,
    rows[chunk, 7], ref_norm)``, with ``state`` the (u, v, p_padded) row
    blocks of this rank and every other output the same on every rank.
    The rows, done-freezing, warmup gate, residual criterion and NaN
    divergence test are ``runner.control_step``'s, on global reductions;
    nothing is read back to the host inside a chunk."""
    x = _Axis(mesh)
    use_residual = convergence_metric == "residual"
    chunk = int(chunk)
    ops = ops_sharded

    def chunk_fn(state, start_iter, ref_norm):
        u, v, p = state
        dev, dtype = u.device, u.dtype
        done = torch.zeros((), dtype=torch.bool, device=dev)
        converged = torch.zeros((), dtype=torch.bool, device=dev)
        conv_iter = torch.full((), -1, dtype=torch.int32, device=dev)
        ref_norm = torch.as_tensor(ref_norm, dtype=dtype, device=dev)
        rows = []
        prods = _x_products(ops, u, v, p, x)
        for offset in range(chunk):
            idx = int(start_iter) + offset
            u_n, v_n, p_n, (R_u, R_v, R_p) = _rk4_local(ops, u, v, p, x,
                                                        prods)
            # the next step's first products give this step's vorticity:
            # omega = Dx v - u Dy^T and Dx omega = Dxx v - (Dx u) Dy^T
            prods_n = _x_products(ops, u_n, v_n, p_n, x)
            dux, dvx, _, dvxx = prods_n[:4]
            omega = dvx - u_n @ ops.DyT
            dwx = dvxx - dux @ ops.DyT
            dwy = omega @ ops.DyT
            W = ops.W2d
            sums = x.all_reduce(torch.stack([
                torch.sum((u_n - u) ** 2), torch.sum(u * u),
                torch.sum((v_n - v) ** 2), torch.sum(v * v),
                torch.sum(R_u * R_u), torch.sum(R_v * R_v),
                torch.sum(R_p * R_p),
                torch.sum(W * (u_n * u_n + v_n * v_n)),
                torch.sum(W * omega * omega),
                torch.sum(W * (dwx * dwx + dwy * dwy))]), dist.ReduceOp.SUM)
            norms = torch.sqrt(sums[:7])
            rel = torch.maximum(norms[0] / (norms[1] + 1e-12),
                                norms[2] / (norms[3] + 1e-12))
            row = torch.cat([rel[None], norms[4:7], 0.5 * sums[7:]])
            row, now_done, conv_iter, converged, ref_norm = control_step(
                row, idx, done, conv_iter, converged, ref_norm, tolerance,
                warmup, use_residual)
            u = torch.where(done, u, u_n)
            v = torch.where(done, v, v_n)
            p = torch.where(done, p, p_n)
            prods = tuple(torch.where(done, a, b)
                          for a, b in zip(prods, prods_n))
            done = now_done
            rows.append(row)
        return (u, v, p), done, conv_iter, converged, torch.stack(rows), \
            ref_norm

    return chunk_fn


def _blocks(mesh, batch_axis: Optional[str]):
    axes = [("x", -2)]
    if batch_axis is not None:
        axes.append((batch_axis, 0))
    return [(mesh_axis(mesh, name), dim) for name, dim in axes]


def shard_state(mesh, arrays, batch_axis: Optional[str] = None):
    """This rank's blocks of whole state arrays: its rows of
    ``mesh["x"]`` and, with ``batch_axis``, its lanes of
    ``mesh[batch_axis]`` (contiguous copies)."""
    out = []
    for a in arrays:
        for (_, rank, world), dim in _blocks(mesh, batch_axis):
            n = a.shape[dim]
            if n % world:
                raise ValueError(f"{n} rows/lanes do not divide over "
                                 f"{world} ranks")
            k = n // world
            a = a.narrow(dim, rank * k, k)
        out.append(a.contiguous())
    return tuple(out)


def gather_state(mesh, arrays, batch_axis: Optional[str] = None):
    """The whole arrays from every rank's blocks (``shard_state``'s
    inverse), on every rank."""
    out = []
    for a in arrays:
        for (group, _, world), dim in _blocks(mesh, batch_axis):
            a = a.contiguous()
            parts = [torch.empty_like(a) for _ in range(world)]
            dist.all_gather(parts, a, group=group)
            a = torch.cat(parts, dim)
        out.append(a)
    return tuple(out)


class ShardedCheckpointManager(CheckpointManager):
    """``CheckpointManager`` of a sharded solve: a save gathers the row
    blocks on every rank of ``mesh["x"]`` (a collective: every rank
    takes the same save decisions), the group's rank 0 writes the whole
    fields, and a barrier holds every rank until the file is in place.
    ``restore_or`` takes the whole state, as the JAX package restores
    before sharding."""

    def __init__(self, mesh, directory, params=None, every_chunks: int = 10,
                 keep: int = 2):
        super().__init__(directory, params, every_chunks, keep)
        self.mesh = mesh

    def save(self, state, iteration: int, carry=None) -> None:
        whole = gather_state(self.mesh, state)
        group, rank, _ = mesh_axis(self.mesh, "x")
        if rank == 0:
            super().save(whole, iteration, carry)
        dist.barrier(group=group)
