"""Multi-rank dry run of the port: ``dryrun_multigpu(n_ranks, device)``.

The counterpart of ``__graft_entry__.py:45 dryrun_multichip``, in four
parts:

1. a ``("sweep", "x")`` mesh with ``n_tp`` the first of (4, 2, 1) that
   divides the rank count: one batched x-sharded step at N=15 (float32,
   Re=100), every lane against the port's ``core.sg_step``;
2. a converged x-sharded N=15 solve (tol 1e-3, chunks of 200; JAX's dry
   run takes 1e-4: 813 steps here against 2,761, so that four gloo ranks
   under a busy host stay well inside their timeout) over every rank
   against the unsharded one: converged, equal iterations;
3. the cross-process sweep (``distributed.launch_local_distributed_dryrun``)
   with 2 ranks: gloo processes on the CPU; NCCL processes on CUDA, which
   needs two cards (NCCL refuses two ranks on one card), else a line says
   it was not measured;
4. the scaling probe (``scaling.measure_scaling``), labelled ``dryrun`` on
   the CPU, where the ranks share the host's cores.

Parts 1, 2 and 4 run on every rank: in this process when it is already a
rank of an ``n_ranks`` world (a card's smoke run at one rank), else on
``n_ranks`` local ranks spawned through ``distributed.launch_local_ranks``.
Part 3 runs from the calling process, outside any multi-rank world.

Run on the CPU with::

    python -c "from anap3_tpu_torch.parallel.dryrun import dryrun_multigpu; dryrun_multigpu(4, 'cpu')"
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["dryrun_multigpu", "run_parts"]


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"dryrun_multigpu: {msg}")


def _close(a, b, rtol, atol) -> bool:
    a, b = (t.detach().cpu().double() for t in (a, b))
    return bool(torch.all((a - b).abs() <= atol + rtol * b.abs()))


def run_parts(device="cuda") -> dict:
    """Parts 1, 2 and 4 on this rank of an initialized process group;
    returns the summary (the same on every rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..models import spectral_sg as core
    from ..models.runner import run_fixed_point
    from . import spatial
    from .scaling import measure_scaling, sg_params

    device = torch.device(device)
    world = dist.get_world_size()
    n_tp = next(c for c in (4, 2, 1) if world % c == 0)
    n_dp = world // n_tp
    mesh = init_device_mesh(device.type, (n_dp, n_tp),
                            mesh_dim_names=("sweep", "x"))

    # part 1: one batched step, lanes on "sweep", rows on "x"
    n = 15
    params = sg_params(n, 100.0, device)
    whole_ops, grid = spatial.build_sharded_ops(params, dtype=torch.float32)
    nf = grid["shape_full"][0]
    _, x_rank, _ = spatial.mesh_axis(mesh, "x")
    ops = spatial.shard_ops(whole_ops, x_rank, n_tp)
    base_ops, _ = core.build_spectral_ops(params)
    s0 = core.initial_state(base_ops)
    lanes = tuple(t.expand(n_dp, *t.shape).contiguous()
                  for t in (s0.u, s0.v, spatial.pad_pressure(s0.p)))
    step = spatial.make_sharded_step(mesh)
    local = spatial.shard_state(mesh, lanes, batch_axis="sweep")
    u2, v2, p2 = spatial.gather_state(mesh, step(ops, *local),
                                      batch_axis="sweep")
    _check(bool(torch.isfinite(u2).all()), "the sharded step is not finite")
    ref, _ = core.sg_step(base_ops, s0)
    for b in range(n_dp):
        _check(_close(u2[b], ref.u, 5e-4, 5e-5) and
               _close(spatial.unpad_pressure(p2[b]), ref.p, 5e-4, 5e-5),
               f"lane {b} of the sharded step differs from sg_step")

    # part 2: a converged x-sharded solve against the unsharded one
    x_mesh = init_device_mesh(device.type, (world,), mesh_dim_names=("x",))
    tol, max_it = 1e-3, 20000
    ref_res = run_fixed_point(lambda s: core.sg_step(base_ops, s),
                              lambda s: (s.u, s.v), s0, tolerance=tol,
                              max_iterations=max_it, chunk=200)
    _check(ref_res.converged, "the unsharded solve did not converge")
    ops1 = spatial.shard_ops(whole_ops, spatial.mesh_axis(x_mesh)[1], world)
    res = run_fixed_point(
        None, lambda s: (s[0], s[1]),
        spatial.shard_state(x_mesh, (s0.u, s0.v, spatial.pad_pressure(s0.p))),
        tolerance=tol, max_iterations=max_it, chunk=200,
        chunk_runner=lambda chunk, tol_, metric_:
            spatial.make_sharded_chunk_runner(x_mesh, ops1, chunk, tol_, 10,
                                              convergence_metric=metric_))
    _check(res.converged, "the sharded solve did not converge")
    _check(res.iterations == ref_res.iterations,
           f"sharded {res.iterations} iterations, unsharded "
           f"{ref_res.iterations}")
    u_s = spatial.gather_state(x_mesh, res.state)[0]
    _check(_close(u_s, ref_res.state.u, 5e-4, 5e-5),
           "the sharded solve's u differs from the unsharded one")

    # part 4: the scaling probe
    scaling = measure_scaling(n=15, b_per_dev=2, chunk=50, calls=4,
                              device=device)
    return {"world": world, "mesh": [n_dp, n_tp], "grid": nf,
            "iterations": int(res.iterations), "scaling": scaling}


def _cross_process_sweep(device) -> str:
    """Part 3's line."""
    from .distributed import launch_local_distributed_dryrun

    if device.type == "cuda" and torch.cuda.device_count() < 2:
        return ("cross-process sweep: not measured (one card; NCCL takes "
                "one rank a card)")
    summaries = launch_local_distributed_dryrun(num_processes=2, n=12,
                                                device=device)
    _check(len(summaries) == 2, f"{len(summaries)} summaries")
    for s in summaries:
        _check(s["process_count"] == 2, s)
        _check(s["converged"] == s["lanes"], s)
    _check(summaries[0] == {**summaries[1], "process_id": 0},
           f"the ranks' views differ: {summaries}")
    return (f"cross-process sweep: 2 processes ({device.type}), "
            f"{summaries[0]['converged']}/{summaries[0]['lanes']} lanes "
            f"converged in {summaries[0]['iterations']} iterations, the "
            f"same view on both ranks")


def dryrun_multigpu(n_ranks: int, device="cuda",
                    timeout: float = 600.0) -> dict:
    """Run the four parts over ``n_ranks`` ranks and print one summary
    line; raises RuntimeError when a part fails."""
    from .distributed import launch_local_ranks

    device = torch.device(device)
    if dist.is_initialized() and dist.get_world_size() == n_ranks:
        summary = run_parts(device)
    else:
        if device.type == "cuda" and torch.cuda.device_count() < n_ranks:
            raise ValueError(f"{n_ranks} NCCL ranks need {n_ranks} cards; "
                             f"{torch.cuda.device_count()} are visible")
        results = launch_local_ranks(n_ranks, run_parts,
                                     {"device": str(device)}, device=device,
                                     timeout=timeout)
        _check(all(r == results[0] for r in results),
               f"the ranks' summaries differ: {results}")
        summary = results[0]
    if dist.is_initialized() and dist.get_world_size() > 1:
        sweep_line = "cross-process sweep: run from outside the world"
    else:
        sweep_line = _cross_process_sweep(device)
    sc = summary["scaling"]
    label = ("dryrun: the ranks share the host's cores" if device.type == "cpu"
             else f"{sc['device_kind']}, {n_ranks} card(s)")
    print(f"dryrun_multigpu OK: mesh=(sweep={summary['mesh'][0]}, "
          f"x={summary['mesh'][1]}), grid {summary['grid']}x"
          f"{summary['grid']}, the batched step matches sg_step; the "
          f"converged sharded solve over (x={n_ranks}) matches the unsharded "
          f"one in {summary['iterations']} iterations; {sweep_line}; scaling "
          f"({label}): sweep weak efficiency "
          f"{sc['sweep_weak_efficiency_pct']}% (aggregate speedup "
          f"{sc['sweep_aggregate_speedup']}x), x-sharded strong efficiency "
          f"{sc['tp_strong_efficiency_pct']}% (speedup {sc['tp_speedup']}x)",
          flush=True)
    summary["cross_process_sweep"] = sweep_line
    return summary
