"""Multi-rank scaling measurement (sweep lanes and x-sharding).

The counterpart of ``anap3_tpu/parallel/scaling.py``: two parallel axes
get a throughput ratio against one rank running the same program.

- **sweep (weak scaling)**: ``b_per_dev`` lanes a rank, each rank's lanes
  one chunk function (the lane kernels on CUDA); the efficiency is the
  per-rank rate at ``d`` ranks over the one-rank rate.
- **x-sharding (strong scaling)**: ONE solve with its rows split over the
  ranks (``parallel/spatial.py``), reduce-scatter collectives for the
  x-direction products; the speedup of the same chunk program at ``d``
  ranks over one.

The one-rank rate runs on ``new_group([0])``, which every rank creates,
while the other ranks wait at a barrier; rank 0 then broadcasts it, so
every rank returns the same keys, the JAX package's. Gloo ranks on one
host share its cores, so their ratios say nothing of cards and callers
label them ``dryrun``; on one card (one rank) both rates time the same
work, a reading of the mechanism and not a scaling claim.
"""

from __future__ import annotations

import json
import time

import torch
import torch.distributed as dist

__all__ = ["measure_sweep_scaling", "measure_tp_scaling", "measure_scaling"]


def sg_params(n: int, Re: float, device):
    """Float32 SG parameters with sg.yaml's numerics (the probe's and the
    dry run's lanes)."""
    from ..models.params import SpectralParameters

    return SpectralParameters(
        name="spectral", Re=float(Re), nx=n, ny=n, basis_type="chebyshev",
        CFL=1.5, beta_squared=5.0, corner_treatment="smoothing",
        corner_smoothing=0.15, dtype="float32", device=str(device))


def _device(device):
    if device is None:
        return torch.device("cuda" if dist.get_backend() == "nccl"
                            else "cpu")
    return torch.device(device)


def _timed(run, calls: int, group, device) -> float:
    """Seconds of ``calls`` runs after one warm-up run, between barriers of
    ``group`` (the work of every rank in it)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier(group=group)

    run()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        run()
    sync()
    return time.perf_counter() - t0


def _one_rank_then_all(rate_on):
    """``(rate on rank 0 alone, rate on every rank)``: the one-rank rate
    runs on ``new_group([0])`` while the others wait; rank 0 shares both."""
    solo = dist.new_group([0])
    out = [None]
    if dist.get_rank() == 0:
        out[0] = rate_on(solo, 1)
    dist.barrier()
    dist.broadcast_object_list(out, src=0)
    r1 = out[0]
    # rank 0's clock for the aggregate too, so every rank returns its keys
    out = [rate_on(dist.group.WORLD, dist.get_world_size())]
    dist.broadcast_object_list(out, src=0)
    dist.destroy_process_group(solo)
    return r1, out[0]


def measure_sweep_scaling(n: int = 15, b_per_dev: int = 2, chunk: int = 50,
                          calls: int = 4, device=None) -> dict:
    """Weak-scaling sweep rate: ``b_per_dev`` lanes a rank, each rank's
    lanes one chunk function (tolerance 0), Re 100 + 25 i for lane i."""
    from ..models import spectral_sg as core
    from ..models.runner import WARMUP_ITERS
    from ..ops.sg_lane_kernels import sg_lane_runner
    from .sweep import stack_states

    device = _device(device)
    p0 = sg_params(n, 100.0, device)

    def rate_on(group, d):
        base = dist.get_rank(group) * b_per_dev
        ops_list = [core.build_spectral_ops(
            sg_params(n, 100.0 + 25.0 * (base + i), device))[0]
            for i in range(b_per_dev)]
        states = stack_states([core.initial_state(o) for o in ops_list])
        run_chunk = sg_lane_runner(ops_list, p0)(slice(None))(
            chunk, 0.0, WARMUP_ITERS, "rel_iter")
        secs = _timed(lambda: run_chunk(states, 0), calls, group, device)
        return b_per_dev * d * chunk * calls / secs

    d = dist.get_world_size()
    r1, rd = _one_rank_then_all(rate_on)
    return {
        "sweep_lanes_per_device": b_per_dev,
        "sweep_rate_1dev": round(r1, 1),
        f"sweep_rate_{d}dev": round(rd, 1),
        "sweep_aggregate_speedup": round(rd / r1, 2),
        "sweep_weak_efficiency_pct": round(100.0 * (rd / d) / r1, 1),
    }


def measure_tp_scaling(n: int = 15, chunk: int = 50, calls: int = 4,
                       device=None) -> dict:
    """Strong-scaling x-sharded solve rate: one solve over every rank
    against one rank. A grid whose rows the rank count does not divide
    raises ValueError before any collective."""
    from ..models import spectral_sg as core
    from . import spatial

    d = dist.get_world_size()
    nf = int(n) + 1
    if nf % d:
        raise ValueError(f"grid rows {nf} must divide the rank count {d}")
    device = _device(device)
    params = sg_params(n, 100.0, device)
    whole_ops, _ = spatial.build_sharded_ops(params, dtype=torch.float32)
    s0 = core.initial_state(core.build_spectral_ops(params)[0])
    whole = (s0.u, s0.v, spatial.pad_pressure(s0.p))

    def rate_on(group, size):
        _, rank, _ = spatial.mesh_axis(group)
        ops = spatial.shard_ops(whole_ops, rank, size)
        state = spatial.shard_state(group, whole)
        runner = spatial.make_sharded_chunk_runner(group, ops, chunk, 0.0,
                                                   10)
        secs = _timed(lambda: runner(state, 0, float("inf")), calls, group,
                      device)
        return chunk * calls / secs

    r1, rd = _one_rank_then_all(rate_on)
    return {
        "tp_rate_1dev": round(r1, 1),
        f"tp_rate_{d}dev": round(rd, 1),
        "tp_speedup": round(rd / r1, 2),
        "tp_strong_efficiency_pct": round(100.0 * (rd / d) / r1, 1),
    }


def measure_scaling(n: int = 15, b_per_dev: int = 2, chunk: int = 50,
                    calls: int = 4, device=None) -> dict:
    """Both axes over every rank of the initialized process group."""
    device = _device(device)
    out = {"n_devices": dist.get_world_size(), "grid_n": n,
           "device_kind": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu")}
    out.update(measure_sweep_scaling(n=n, b_per_dev=b_per_dev, chunk=chunk,
                                     calls=calls, device=device))
    out.update(measure_tp_scaling(n=n, chunk=chunk, calls=calls,
                                  device=device))
    return out


if __name__ == "__main__":
    from .distributed import initialize_distributed

    # torchrun's ranks, else this process alone
    if not initialize_distributed(device="cuda"):
        initialize_distributed(num_processes=1, process_id=0,
                               store=dist.HashStore(), device="cuda")
    try:
        print(json.dumps(measure_scaling()))
    finally:
        dist.destroy_process_group()
