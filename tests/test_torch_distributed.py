"""Multi-process paths of anap3_tpu_torch on torch.distributed:
parallel/distributed.py (initialization, the local launcher, the
cross-process sweep worker), the ``mesh`` of run_batched_sweep and
run_batched_fsg (parallel/sweep.py, fsg_sweep.py), parallel/scaling.py and
parallel/dryrun.py.

The ranks are gloo processes spawned by ``distributed.launch_local_ranks``
(one CPU thread each, a 180 s timeout), once per world size for the file:
2 ranks run ``torch_ranks.distributed_job``, 3 ranks
``torch_ranks.tp_indivisible_job``. The JAX side runs in this process.

- The 2-process sweep, 2 of 4 float64 SG lanes a rank: every lane's
  iterations equal to the port's unsharded ``run_batched_sweep`` and, in
  one chunk, to JAX's; fields within 1e-12 relative; chunked (lanes done in
  different chunks, the global all-done flag) bit-equal to the unsharded
  sweep; both ranks return identical summaries; 3 lanes over 2 ranks raise
  ValueError.
- ``run_batched_fsg`` over the mesh: the levels, iterations and bits of
  the run without one.
- ``measure_scaling``'s keys finite at 2 ranks; ``measure_tp_scaling`` at
  3 ranks with 16 rows raises ValueError before any collective (only rank
  0 calls it).
- ``dryrun_multigpu(4, "cpu")`` passes; a rank that outlives its timeout
  is killed and reported; ``initialize_distributed`` returns False without
  a configured run.

The ``gpu`` tests run at world size 1 over NCCL: the mesh sweep through
the lane kernels, bit-equal to the sweep without a mesh, and the backend
``initialize_distributed`` picks for CUDA.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.models.runner import METRIC_KEYS
from anap3_tpu_torch.parallel import distributed as D
from anap3_tpu_torch.parallel import sweep as TS
from anap3_tpu_torch.parallel.dryrun import dryrun_multigpu

import torch_ranks as R

torch.set_num_threads(1)

UV = (lambda s: (s.u, s.v))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    out = tmp_path_factory.mktemp("distributed2")
    info = D.launch_local_ranks(2, R.distributed_job, {"out_dir": str(out)},
                                device="cpu", timeout=180)
    return info, out


def port_sweep(chunk):
    ops = [T.build_spectral_ops(SpectralParameters(device="cpu", **s))[0]
           for s in R.SWEEP_LANES]
    states = TS.stack_states([T.initial_state(o) for o in ops])
    return TS.run_batched_sweep(T.sg_step, UV, TS.stack_ops(ops), states,
                                tolerance=1e-3, max_iterations=1500,
                                chunk=chunk)


class TestMeshSweep:
    def test_one_chunk_matches_unsharded_and_jax(self, ranks2):
        d = np.load(ranks2[1] / "sweep_one_chunk.npz")
        ref = port_sweep(1500)
        # the JAX side, imported here: the card's machine has no JAX
        import jax
        import jax.numpy as jnp
        from anap3_tpu.models import spectral_sg as J
        from anap3_tpu.models.params import SpectralParameters as JaxParams
        from anap3_tpu.parallel import sweep as JS

        jops = [J.build_spectral_ops(JaxParams(**s))[0]
                for s in R.SWEEP_LANES]
        jstates = jax.tree.map(lambda *a: jnp.stack(a),
                               *[J.initial_state(o) for o in jops])
        jres = JS.run_batched_sweep(J.sg_step, UV, JS.stack_ops(jops),
                                    jstates, tolerance=1e-3,
                                    max_iterations=1500, chunk=1500)
        np.testing.assert_array_equal(d["iterations"], ref.iterations)
        np.testing.assert_array_equal(d["iterations"], jres.iterations)
        np.testing.assert_array_equal(d["converged"], jres.converged)
        assert d["converged"].any() and not d["converged"].all()
        for k, name in enumerate("uvp"):
            assert rel(d[name], ref.states[k].numpy()) <= 1e-12
            assert rel(d[name], np.asarray(jres.states[k])) <= 1e-12

    def test_chunked_is_bit_equal_to_unsharded(self, ranks2):
        d = np.load(ranks2[1] / "sweep_chunked.npz")
        ref = port_sweep(100)
        np.testing.assert_array_equal(d["iterations"], ref.iterations)
        # lanes stop in different chunks: the batch ran to the last one
        assert len(set(d["iterations"].tolist())) > 1
        np.testing.assert_array_equal(d["converged"], ref.converged)
        np.testing.assert_array_equal(d["diverged"], ref.diverged)
        np.testing.assert_array_equal(d["history_iters"], ref.history_iters)
        for k, name in enumerate("uvp"):
            np.testing.assert_array_equal(d[name], ref.states[k].numpy())
        for key in METRIC_KEYS:
            np.testing.assert_array_equal(d[key], ref.history[key])

    def test_ranks_return_identical_results(self, ranks2):
        a, b = ranks2[0]
        for name in ("one_chunk", "chunked"):
            assert a[name] == b[name]
        assert a["fsg"] == b["fsg"] and a["scaling"] == b["scaling"]

    def test_indivisible_batch_raises(self, ranks2):
        assert "3 lanes do not divide" in ranks2[0][0]["indivisible"]

    def test_fsg_sweep_over_the_mesh(self, ranks2):
        fsg = ranks2[0][0]["fsg"]
        assert fsg["levels"] == fsg["levels_alone"]
        assert [[n for n, _ in lv] for lv in fsg["levels"]] == [[12, 24]] * 2
        assert fsg["bit_equal"]


class TestScaling:
    def test_keys_finite_at_two_ranks(self, ranks2):
        out = ranks2[0][0]["scaling"]
        assert out["n_devices"] == 2 and out["device_kind"] == "cpu"
        for key in ("sweep_rate_1dev", "sweep_rate_2dev",
                    "sweep_aggregate_speedup", "sweep_weak_efficiency_pct",
                    "tp_rate_1dev", "tp_rate_2dev", "tp_speedup",
                    "tp_strong_efficiency_pct"):
            assert np.isfinite(out[key]) and out[key] > 0, key

    def test_tp_scaling_rejects_indivisible_grid(self):
        out = D.launch_local_ranks(3, R.tp_indivisible_job, device="cpu",
                                   timeout=60)
        assert "must divide" in out[0]["error"]


class TestLauncher:
    def test_dryrun_multigpu_on_the_cpu(self, capsys):
        summary = dryrun_multigpu(4, "cpu", timeout=180)
        assert summary["mesh"] == [1, 4] and summary["grid"] == 16
        assert summary["iterations"] > 0
        assert summary["scaling"]["n_devices"] == 4
        assert "2 processes (cpu), 4/4 lanes converged" in \
            summary["cross_process_sweep"]
        assert "dryrun_multigpu OK" in capsys.readouterr().out

    def test_a_rank_past_its_timeout_is_killed(self):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 0 was killed"):
            D.launch_local_ranks(1, R.sleep_job, {"seconds": 120},
                                 device="cpu", timeout=5)
        assert time.monotonic() - t0 < 60

    def test_a_failing_rank_is_reported(self):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
            D.launch_local_ranks(2, R.fail_job, device="cpu", timeout=60)
        # rank 0, waiting at its barrier, was killed, not waited for
        assert time.monotonic() - t0 < 50

    def test_no_configured_run_is_not_initialized(self, monkeypatch):
        for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                    "LOCAL_RANK"):
            monkeypatch.delenv(key, raising=False)
        assert D.initialize_distributed(device="cpu") is False
        assert not dist.is_initialized()
        assert D.backend_for("cpu") == "gloo"
        assert D.backend_for("cuda") == "nccl"
        with pytest.raises(ValueError, match="world size"):
            D.initialize_distributed(coordinator="127.0.0.1:1",
                                     device="cpu")


@pytest.fixture
def nccl_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and the lane kernels run on the "
                    "card only")
    assert D.initialize_distributed(num_processes=1, process_id=0,
                                    store=dist.HashStore(), device="cuda")
    yield torch.device("cuda")
    dist.destroy_process_group()


@pytest.mark.gpu
class TestOnCard:
    """World size 1 over NCCL (``python -m pytest
    tests/test_torch_distributed.py -m gpu --noconftest``)."""

    def test_initialize_picks_nccl(self, nccl_world):
        assert dist.get_backend() == "nccl"
        assert D.initialize_distributed(device="cuda") is True

    def test_mesh_sweep_launches_the_lane_kernels(self, nccl_world):
        from anap3_tpu_torch.ops import sg_lane_kernels as sgl

        specs = [dict(s, nx=48, ny=48, dtype="float32", tolerance=0.0,
                      max_iterations=400) for s in R.SWEEP_LANES]
        plist = [SpectralParameters(device="cuda", **s) for s in specs]
        ops = [T.build_spectral_ops(p)[0] for p in plist]
        states = TS.stack_states([T.initial_state(o) for o in ops])
        mesh = D.global_mesh(("sweep",), device="cuda")
        runs = []
        for m in (mesh, None):
            sgl.reset_counts()
            runs.append(TS.run_batched_sweep(
                None, UV, TS.stack_ops(ops), states, 0.0, 400, chunk=200,
                mesh=m, lane_runner=sgl.sg_lane_runner(ops, plist[0])))
            # N=48: the resident lane chunk (sg_kernels.resident_geometry)
            assert sgl.LAUNCHES["sg_lanes_resident"] > 0
            assert not any(sgl.PLAIN_CALLS.values())
        np.testing.assert_array_equal(runs[0].iterations, runs[1].iterations)
        for a, b in zip(runs[0].states, runs[1].states):
            assert torch.equal(a, b)
