"""Multi-process initialization, meshes and the cross-process sweep.

The counterpart of ``anap3_tpu/parallel/distributed.py`` on
``torch.distributed``: one process per card (NCCL) or per CPU worker
(gloo), a global ``DeviceMesh`` over every rank, and the lanes of
``parallel.sweep.run_batched_sweep`` split over its ``"sweep"`` dimension.

- ``initialize_distributed``: ``init_process_group`` from torchrun's
  variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``) or from explicit arguments; the backend follows the
  device: ``nccl`` for CUDA (after ``torch.cuda.set_device(LOCAL_RANK)``),
  ``gloo`` for the CPU. It returns False only when no multi-process run is
  configured. A failed initialization raises (the JAX package logs a
  warning and returns False).
- ``global_mesh``: a ``DeviceMesh`` over every rank.
- ``distributed_sweep_worker``: one rank of a cross-process sweep, the JAX
  worker's lanes (SG N=12, Re from linspace(100, 400, B), float32, tol
  1e-3, chunks of 100) and its summary keys.
- ``launch_local_ranks`` / ``launch_local_distributed_dryrun``: spawn the
  ranks of a run on this machine (``torch.multiprocessing``), a CPU rank
  with a minimal environment and one thread, under one timeout; a rank
  that times out is killed and reported, never waited on forever. The
  launcher hosts the rendezvous store on a free loopback port.

NCCL refuses a communicator in which two ranks share a card, so a run of W
ranks on CUDA needs W cards. Run one rank a card with::

    torchrun --nproc-per-node=<cards> -m anap3_tpu_torch.parallel.distributed

which prints ``DISTRIBUTED_SWEEP {json}`` on every rank, as the JAX
worker's ``__main__`` does.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

__all__ = ["initialize_distributed", "global_mesh", "backend_for",
           "distributed_sweep_worker", "launch_local_ranks",
           "launch_local_distributed_dryrun"]

SWEEP_TAG = "DISTRIBUTED_SWEEP "


def backend_for(device) -> str:
    """The process-group backend of a device: nccl for CUDA, gloo for the
    CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"unsupported device {str(device)!r}: cuda or cpu")


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda", store=None,
                           timeout: Optional[float] = None) -> bool:
    """Initialize the default process group of a multi-process run.

    ``coordinator`` is ``host:port`` (default ``MASTER_ADDR:MASTER_PORT``),
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK``; a CUDA rank takes card ``LOCAL_RANK`` (else its rank). ``store``
    (a ``torch.distributed.Store``) replaces the coordinator. Returns False
    when none of them configures a run; True once the group is up (also
    when it already was, with this device's backend). Raises when the
    initialization fails or an existing group has another backend."""
    backend = backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(
                f"a {dist.get_backend()} process group is initialized; "
                f"device={str(device)!r} needs {backend}")
        return True
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR") and \
            env.get("MASTER_PORT"):
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = num_processes if num_processes is not None else \
        int(env.get("WORLD_SIZE", "0") or 0)
    rank = process_id if process_id is not None else \
        int(env.get("RANK", "-1") or -1)
    if store is None and not coordinator and world <= 1:
        return False
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"a multi-process run needs its world size and a "
                         f"rank in it: world {world}, rank {rank}")
    kwargs = {"backend": backend, "world_size": world, "rank": rank}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    if store is not None:
        kwargs["store"] = store
    else:
        kwargs["init_method"] = f"tcp://{coordinator}"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    dist.init_process_group(**kwargs)
    log.info("torch.distributed initialized (%s): rank %d of %d", backend,
             rank, world)
    return True


def global_mesh(axis_names: Sequence[str] = ("sweep",),
                axis_sizes: Optional[Sequence[int]] = None, device="cuda"):
    """A ``DeviceMesh`` over every rank of the initialized group: shape
    ``axis_sizes``, or all ranks on the first axis and 1 on the others."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    shape = tuple(axis_sizes) if axis_sizes is not None else \
        (world,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=tuple(axis_names))


def distributed_sweep_worker(coordinator: Optional[str] = None,
                             num_processes: Optional[int] = None,
                             process_id: Optional[int] = None, n: int = 12,
                             lanes_per_device: int = 1,
                             tolerance: float = 1e-3,
                             max_iterations: int = 5000,
                             device="cuda") -> dict:
    """One rank of a cross-process sweep (the dry run's and tests' worker).

    Initializes the process group (a no-op when it is up), builds the
    global ``("sweep",)`` mesh and drives ``lanes_per_device`` SG lanes a
    rank, float32, through ``run_batched_sweep(mesh=...)``: every rank
    passes the whole batch and runs its own lanes (the lane kernels on
    CUDA). Returns the JAX worker's summary keys."""
    initialize_distributed(coordinator, num_processes, process_id,
                           device=device)
    from ..models import spectral_sg as core
    from ..models.params import SpectralParameters
    from ..ops.sg_lane_kernels import sg_lane_runner
    from .sweep import run_batched_sweep, stack_ops, stack_states

    world = dist.get_world_size()
    mesh = global_mesh(("sweep",), device=device)
    B = world * int(lanes_per_device)
    plist = [SpectralParameters(Re=float(Re), nx=n, ny=n, dtype="float32",
                                device=str(device))
             for Re in np.linspace(100.0, 400.0, B)]
    ops_list = [core.build_spectral_ops(p)[0] for p in plist]
    states = stack_states([core.initial_state(o) for o in ops_list])
    res = run_batched_sweep(
        None, lambda s: (s.u, s.v), stack_ops(ops_list), states,
        tolerance=tolerance, max_iterations=max_iterations, chunk=100,
        mesh=mesh, lane_runner=sg_lane_runner(ops_list, plist[0]))
    return {
        "process_id": dist.get_rank(),
        "process_count": world,
        "global_devices": world,
        "local_devices": 1,
        "lanes": B,
        "converged": int(np.sum(res.converged)),
        "iterations": [int(i) for i in res.iterations],
    }


def _rank(rank: int, world: int, port: int, device: str, timeout: float,
          fn, kwargs: dict, out_dir: str) -> None:
    """One spawned rank: join the launcher's store, run ``fn(**kwargs)``
    and write its JSON result. A CPU rank keeps one thread and only the
    environment Python and the rendezvous need; a CUDA rank keeps the
    caller's, so the toolkit and the card stay reachable."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
        keep = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR")
                if k in os.environ}
        os.environ.clear()
        os.environ.update(keep, OMP_NUM_THREADS="1")
    os.environ["LOCAL_RANK"] = str(rank)
    store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                          timeout=datetime.timedelta(seconds=timeout))
    initialize_distributed(num_processes=world, process_id=rank,
                           device=device, store=store, timeout=timeout)
    # every rank holds here until all have joined: gloo connects the ranks
    # pair by pair, and a rank whose job returns at once (no collective)
    # must not close its connections while a slower peer is still
    # connecting ("Connection closed by peer" on a loaded host)
    dist.barrier()
    try:
        result = fn(**kwargs)
    except BaseException:
        # before the group goes down, so the first failure is on record
        # when its peers fail on the closed connections
        (Path(out_dir) / f"{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"{rank}.json").write_text(json.dumps(result))


def launch_local_ranks(num_processes: int, fn, kwargs: Optional[dict] = None,
                       device="cuda", timeout: float = 180.0) -> list:
    """Run ``fn(**kwargs)`` (a module-level function) on ``num_processes``
    ranks of this machine and return each rank's JSON-able result, in rank
    order.

    The ranks are spawned processes (``torch.multiprocessing``) that join
    the group on a store this process hosts on a free loopback port (bound
    to port 0): gloo ranks with one thread on the CPU, NCCL ranks on card
    ``rank`` on CUDA. When a rank fails, the others are killed; when
    ``timeout`` seconds pass, every rank still running is killed. Either
    raises RuntimeError with each failed rank's traceback or each killed
    rank's number."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    world = int(num_processes)
    store = dist.TCPStore("127.0.0.1", 0, None, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank, args=(world, store.port, str(device), float(timeout), fn,
                         kwargs or {}, tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, min(
                    1.0, deadline - time.monotonic()))):
                if time.monotonic() >= deadline:
                    alive = [k for k, p in enumerate(ctx.processes)
                             if p.is_alive()]
                    raise RuntimeError(
                        "local ranks failed: " + "; ".join(
                            f"rank {k} was killed: still running after the "
                            f"{timeout:g} s timeout" for k in alive))
        except ProcessException as exc:
            errs = sorted(Path(tmp).glob("*.err"), key=lambda f: int(f.stem))
            raise RuntimeError("local ranks failed:\n" + ("\n".join(
                f"rank {f.stem}: {f.read_text()}" for f in errs)
                or str(exc))) from exc
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [json.loads((Path(tmp) / f"{k}.json").read_text())
                for k in range(world)]


def launch_local_distributed_dryrun(num_processes: int = 2, n: int = 12,
                                    lanes_per_device: int = 2,
                                    timeout: float = 180.0,
                                    device="cpu") -> list:
    """Spawn ``num_processes`` local ranks running the cross-process sweep
    (``distributed_sweep_worker``, gloo on the CPU, as the JAX package's
    local dry run); returns the per-rank summary dicts."""
    return launch_local_ranks(
        num_processes, distributed_sweep_worker,
        {"n": n, "lanes_per_device": lanes_per_device,
         "device": str(device)}, device=device, timeout=timeout)


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="one rank of a cross-process sweep (under torchrun, or "
                    "with --coordinator, --num-processes and --process-id)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port (default MASTER_ADDR:MASTER_PORT)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--n", type=int, default=12)
    ap.add_argument("--lanes-per-device", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(1)
    if not initialize_distributed(args.coordinator, args.num_processes,
                                  args.process_id, device=args.device):
        raise SystemExit("no multi-process run is configured: run under "
                         "torchrun or give --coordinator, --num-processes "
                         "and --process-id")
    try:
        summary = distributed_sweep_worker(
            n=args.n, lanes_per_device=args.lanes_per_device,
            device=args.device)
        print(SWEEP_TAG + json.dumps(summary), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main())
