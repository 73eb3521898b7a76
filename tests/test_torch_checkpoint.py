"""Checkpoint/resume of anap3_tpu_torch (utils/checkpoint.py and the hooks
of models/runner.py, SGSolver.solve and FVSolver.solve), on the CPU.

- The JAX package's checkpoint tests (tests/test_aux.py, tests/test_fv.py)
  on the port: the atomic ``.npz`` round trip, ``_gc`` keeping two,
  stray files ignored, the temporary file invisible to the glob, a
  changed Re refused with ``FingerprintMismatch``, run-control changes
  (the device among them) allowed.
- The fingerprint equals the JAX package's for the same configuration, a
  JAX-written checkpoint restores into the port and a port-written one
  into JAX, bit for bit.
- A float64 SG or FV solve stopped after two chunks and resumed by a new
  solver for a third equals the uninterrupted three-chunk solve bit for
  bit, with the plain step and with the kernel wrappers' plain versions;
  a resumed residual-criterion solve converges where the uninterrupted
  one does (the checkpoint carries the criterion's normalization);
  the runner saves the state of the chunk it has read, never the
  speculated next one, and nothing after the chunk that finished the
  solve.
- The resume flow through ``main.py solver=gpu/sg solver.device=cpu``.
"""

import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import fv as TF
from anap3_tpu_torch.models import runner as TR
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import FVParameters, SpectralParameters
from anap3_tpu_torch.models.spectral import SGSolver
from anap3_tpu_torch.utils import checkpoint as ck
from anap3_tpu_torch.utils.checkpoint import (CheckpointManager,
                                              FingerprintMismatch,
                                              load_checkpoint,
                                              save_checkpoint)

torch.set_num_threads(1)


def make_params(**over):
    """tests/test_aux.py's make_params, on the CPU."""
    base = dict(name="spectral", Re=100.0, nx=12, ny=12,
                basis_type="chebyshev", CFL=1.5, corner_treatment="smoothing",
                tolerance=1e-4, max_iterations=4000, dtype="float64")
    base.update(over)
    return base


def port_state(**over):
    p = SpectralParameters(device="cpu", **make_params(**over))
    ops, _ = T.build_spectral_ops(p)
    u, v = T.enforce_bc(ops, *(torch.as_tensor(
        np.random.default_rng(0).standard_normal((13, 13))) for _ in "uv"))
    return T.SpectralState(u, v, torch.ones((11, 11), dtype=torch.float64))


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        state = port_state()
        save_checkpoint(tmp_path / "c.npz", state, 123, "fp")
        restored, it = load_checkpoint(tmp_path / "c.npz", state)
        assert it == 123
        assert type(restored) is T.SpectralState
        for a, b in zip(restored, state):
            assert torch.equal(a, b)

    def test_restores_onto_like_dtype_and_device(self, tmp_path):
        state = port_state()
        save_checkpoint(tmp_path / "c.npz", state, 5)
        like = T.SpectralState(*(t.float() for t in state))
        restored, _ = load_checkpoint(tmp_path / "c.npz", like)
        assert all(t.dtype == torch.float32 and t.device == like.u.device
                   for t in restored)
        with pytest.raises(ValueError, match="shape"):
            load_checkpoint(tmp_path / "c.npz", T.SpectralState(
                state.u, state.v, state.p[:-1]))
        with pytest.raises(ValueError, match="leaves"):
            load_checkpoint(tmp_path / "c.npz", (state.u, state.v))

    def test_layout(self, tmp_path):
        """The JAX package's layout: leaf_<i> in field order and the
        __meta__ JSON."""
        import json

        state = port_state()
        save_checkpoint(tmp_path / "c.npz", state, 7, "fp")
        with np.load(tmp_path / "c.npz") as d:
            assert sorted(d.files) == ["__meta__", "leaf_0", "leaf_1",
                                       "leaf_2"]
            meta = json.loads(bytes(d["__meta__"]).decode())
            np.testing.assert_array_equal(d["leaf_2"], state.p.numpy())
        assert meta["iteration"] == 7 and meta["n_leaves"] == 3
        assert meta["fingerprint"] == "fp"
        assert meta["treedef"] == "SpectralState(u=*, v=*, p=*)"

    def test_manager_gc_and_restore(self, tmp_path):
        state = port_state()
        mgr = CheckpointManager(tmp_path, every_chunks=1, keep=2)
        for it in (100, 200, 300):
            mgr.maybe_save(state, it)
        assert len(sorted(tmp_path.glob("ckpt_*.npz"))) == 2
        _, it = mgr.restore_or(state)
        assert it == 300

    def test_every_k_chunks(self, tmp_path):
        mgr = CheckpointManager(tmp_path, every_chunks=3)
        saved = [mgr.maybe_save(port_state(), 10 * i) for i in range(1, 7)]
        assert saved == [False, False, True, False, False, True]


class TestCheckpointSafety:
    def test_fingerprint_mismatch_refuses_resume(self, tmp_path):
        state = port_state()
        CheckpointManager(tmp_path, params=SpectralParameters(
            device="cpu", **make_params(Re=100.0)), every_chunks=1
        ).maybe_save(state, 100)
        mgr_b = CheckpointManager(tmp_path, params=SpectralParameters(
            device="cpu", **make_params(Re=400.0)), every_chunks=1)
        with pytest.raises(FingerprintMismatch):
            mgr_b.restore_or(state)

    def test_run_control_changes_allow_resume(self, tmp_path):
        """A longer budget, a tighter tolerance, other chunks and another
        device resume."""
        state = port_state()
        CheckpointManager(tmp_path, params=SpectralParameters(
            device="cuda", **make_params(max_iterations=500)),
            every_chunks=1).maybe_save(state, 100)
        mgr_b = CheckpointManager(tmp_path, params=SpectralParameters(
            device="cpu", **make_params(max_iterations=9000, tolerance=1e-6,
                                        chunk_size=50, stall_chunks=50)),
            every_chunks=1)
        _, it = mgr_b.restore_or(state)
        assert it == 100

    def test_stray_partial_files_ignored(self, tmp_path):
        state = port_state()
        mgr = CheckpointManager(tmp_path, every_chunks=1)
        mgr.maybe_save(state, 100)
        (tmp_path / "ckpt_000000200.tmp.npz").write_bytes(b"partial")
        _, it = mgr.restore_or(state)
        assert it == 100
        mgr.maybe_save(state, 300)  # _gc must not crash either

    def test_unreadable_checkpoint_starts_fresh(self, tmp_path):
        state = port_state()
        (tmp_path / "ckpt_000000100.npz").write_bytes(b"garbage")
        restored, it = CheckpointManager(tmp_path).restore_or(state)
        assert it == 0 and restored is state

    def test_temp_file_invisible_to_glob(self, tmp_path, monkeypatch):
        real_replace = ck.os.replace
        calls = {}

        def spy_replace(src, dst):
            calls["tmp"] = Path(src)
            assert not list(Path(dst).parent.glob("ckpt_*.npz"))
            return real_replace(src, dst)

        monkeypatch.setattr(ck.os, "replace", spy_replace)
        save_checkpoint(tmp_path / "ckpt_000000001.npz", port_state(), 1,
                        "fp")
        assert calls["tmp"].name.startswith(".")
        assert (tmp_path / "ckpt_000000001.npz").exists()


@pytest.fixture(scope="module")
def jck():
    from anap3_tpu.models import spectral_sg as J
    from anap3_tpu.models.params import FVParameters as JFP
    from anap3_tpu.models.params import SpectralParameters as JSP
    from anap3_tpu.utils import checkpoint as JC

    return type("JCK", (), dict(J=J, JC=JC, JSP=JSP, JFP=JFP))


class TestAgainstJax:
    @pytest.mark.parametrize("kind", ["spectral", "fv"])
    def test_fingerprint_equals_jax(self, jck, kind):
        if kind == "spectral":
            kw = make_params(Re=400.0, corner_treatment="singular")
            jp, tp = jck.JSP(**kw), SpectralParameters(device="cuda", **kw)
        else:
            kw = dict(Re=400.0, nx=16, ny=16, dtype="float64",
                      convection_scheme="TVD", limiter="MUSCL")
            jp, tp = jck.JFP(**kw), FVParameters(device="cpu", **kw)
        assert CheckpointManager("d", params=tp).fingerprint == \
            jck.JC.CheckpointManager("d", params=jp).fingerprint
        assert CheckpointManager.RUN_CONTROL_KEYS == \
            jck.JC.CheckpointManager.RUN_CONTROL_KEYS | {"device"}

    def test_solver_fingerprints_agree_on_auto_dtype_on_the_cpu(self, jck):
        """dtype "auto" resolves to float64 in both packages on the CPU
        (on a card the port resolves it to float32, and the fingerprint
        then differs, as the physics precision does)."""
        from anap3_tpu.models.spectral import SGSolver as JaxSG

        kw = make_params(dtype="auto")
        t = SGSolver(device="cpu", **kw)
        j = JaxSG(**kw)
        assert t.params.dtype == j.params.dtype == "float64"
        assert CheckpointManager("d", params=t.params).fingerprint == \
            jck.JC.CheckpointManager("d", params=j.params).fingerprint

    def test_jax_checkpoint_restores_into_the_port(self, jck, tmp_path):
        jp = jck.JSP(**make_params())
        jops, _ = jck.J.build_spectral_ops(jp)
        rng = np.random.default_rng(1)
        jstate = jck.J.SpectralState(
            *(jck.J.initial_state(jops)[i] + rng.standard_normal(s)
              for i, s in enumerate(((13, 13), (13, 13), (11, 11)))))
        jck.JC.CheckpointManager(tmp_path, params=jp, every_chunks=1
                                 ).maybe_save(jstate, 300)
        mgr = CheckpointManager(tmp_path, params=SpectralParameters(
            device="cpu", **make_params()))
        restored, it = mgr.restore_or(port_state())
        assert it == 300
        for a, b in zip(restored, jstate):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_port_checkpoint_restores_into_jax(self, jck, tmp_path):
        state = port_state()
        CheckpointManager(tmp_path, params=SpectralParameters(
            device="cpu", **make_params()), every_chunks=1
        ).maybe_save(state, 200)
        jp = jck.JSP(**make_params())
        jops, _ = jck.J.build_spectral_ops(jp)
        restored, it = jck.JC.CheckpointManager(tmp_path, params=jp
                                                ).restore_or(
            jck.J.initial_state(jops))
        assert it == 200
        for a, b in zip(restored, state):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())

    def test_jax_solve_resumes_in_the_port(self, jck, tmp_path):
        """A JAX SG solve's checkpoint, resumed by the port's solver, ends
        where the port's uninterrupted solve ends."""
        from anap3_tpu.models.spectral import SGSolver as JaxSG

        kw = make_params(tolerance=1e-30, chunk_size=100)
        JaxSG(checkpoint_dir=str(tmp_path), checkpoint_every_chunks=1,
              **dict(kw, max_iterations=200)).solve()
        port = SGSolver(device="cpu", checkpoint_dir=str(tmp_path),
                        **dict(kw, max_iterations=300))
        port.solve()
        ref = SGSolver(device="cpu", **dict(kw, max_iterations=300))
        ref.solve()
        assert port.metrics.iterations == ref.metrics.iterations == 300
        for a, b in zip(port.state, ref.state):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-12)


def _resume_pair(make, tmp_path, chunk):
    """(uninterrupted solver, resumed solver): three chunks in one solve,
    against two chunks with checkpoints and a new solver for the third."""
    ref = make(max_iterations=3 * chunk)
    ref.solve()
    first = make(max_iterations=2 * chunk, checkpoint_dir=str(tmp_path),
                 checkpoint_every_chunks=1)
    first.solve()
    resumed = make(max_iterations=3 * chunk, checkpoint_dir=str(tmp_path),
                   checkpoint_every_chunks=1)
    resumed.solve()
    return ref, resumed


class TestResume:
    @pytest.mark.parametrize("use_pallas", ["false", "true"])
    def test_sg_resume_is_bit_equal(self, tmp_path, use_pallas, caplog):
        import logging

        def make(**kw):
            return SGSolver(device="cpu", use_pallas=use_pallas,
                            **make_params(tolerance=1e-30, chunk_size=100,
                                          **kw))

        with caplog.at_level(logging.INFO):
            ref, resumed = _resume_pair(make, tmp_path, 100)
        assert any("Resumed from checkpoint" in r.message and "200" in
                   r.message for r in caplog.records)
        assert resumed.metrics.iterations == ref.metrics.iterations == 300
        for a, b in zip(resumed.state, ref.state):
            assert torch.equal(a, b)
        # the resumed solve's history starts at the resume point
        assert len(resumed.time_series.rel_iter_residual) == 100

    def test_residual_criterion_resumes_its_normalization(self, tmp_path):
        """convergence_metric=residual normalizes by the continuity norm
        at the warmup iteration. The checkpoint carries it, so a resumed
        run converges where the uninterrupted one does, bit for bit (the
        JAX package restarts it at inf: its resumed run converges at its
        first step, iteration 201 here, against 4,236)."""
        def make(**kw):
            return SGSolver(device="cpu", **make_params(
                tolerance=1e-3, chunk_size=100, convergence_metric="residual",
                **kw))

        ref = make(max_iterations=5000)
        ref.solve()
        make(max_iterations=200, checkpoint_dir=str(tmp_path),
             checkpoint_every_chunks=1).solve()
        resumed = make(max_iterations=5000, checkpoint_dir=str(tmp_path),
                       checkpoint_every_chunks=1)
        resumed.solve()
        assert ref.metrics.converged and ref.metrics.iterations > 1000
        assert resumed.metrics.iterations == ref.metrics.iterations
        assert resumed.metrics.converged
        for a, b in zip(resumed.state, ref.state):
            assert torch.equal(a, b)

    def test_carry_is_saved_and_restored(self, tmp_path):
        state = port_state()
        CheckpointManager(tmp_path, every_chunks=1).maybe_save(
            state, 100, {"ref_norm": torch.tensor(0.25)})
        mgr = CheckpointManager(tmp_path)
        mgr.restore_or(state)
        assert mgr.carry == {"ref_norm": 0.25}

    @pytest.mark.parametrize("use_pallas", ["false", "true"])
    def test_fv_resume_is_bit_equal(self, tmp_path, use_pallas):
        def make(**kw):
            return TF.FVSolver(device="cpu", use_pallas=use_pallas, **dict(
                name="fv", Re=100.0, nx=12, ny=12, convection_scheme="TVD",
                limiter="MUSCL", alpha_uv=0.4, alpha_p=0.2,
                corner_treatment="none", dtype="float64", chunk_size=30,
                tolerance=1e-30, **kw))

        ref, resumed = _resume_pair(make, tmp_path, 30)
        assert resumed.metrics.iterations == ref.metrics.iterations == 90
        for a, b in zip(resumed.state, ref.state):
            assert torch.equal(a, b)

    def test_runner_saves_the_read_chunk_not_the_speculated_one(self):
        """Every save holds the state after exactly its iteration count,
        though the next chunk was dispatched before the save (the last
        chunk of a budget saves too); the chunk that finishes the solve by
        convergence saves nothing."""
        p = SpectralParameters(device="cpu", **make_params())
        ops, _ = T.build_spectral_ops(p)
        step = lambda s: T.sg_step(ops, s)
        uv = lambda s: (s.u, s.v)

        class Spy:
            saves = []

            def maybe_save(self, state, it, carry=None):
                self.saves.append((it, T.SpectralState(
                    *(t.clone() for t in state))))

        spy = Spy()
        res = TR.run_fixed_point(step, uv, T.initial_state(ops),
                                 tolerance=1e-30, max_iterations=70,
                                 chunk=20, checkpoint_mgr=spy)
        assert res.iterations == 70
        assert [it for it, _ in spy.saves] == [20, 40, 60, 70]
        for it, saved in spy.saves:
            alone = TR.run_fixed_point(step, uv, T.initial_state(ops),
                                       tolerance=1e-30, max_iterations=it,
                                       chunk=20)
            assert all(torch.equal(a, b) for a, b in zip(saved, alone.state))

        spy.saves = []
        res = TR.run_fixed_point(step, uv, T.initial_state(ops),
                                 tolerance=2e-2, max_iterations=400,
                                 chunk=20, checkpoint_mgr=spy)
        assert res.converged and 20 < res.iterations <= 400
        assert spy.saves[-1][0] == 20 * ((res.iterations - 1) // 20)

    def test_resumed_history_not_warmup_sliced(self, jck):
        """tests/test_aux.py::TestRunnerResumeHistory on both runners:
        post-resume rows past the warmup gate are all recorded."""
        from anap3_tpu.models.runner import run_fixed_point as jrun
        import jax.numpy as jnp

        def jstep(x):
            return 0.9 * x, {k: jnp.asarray(0.5) for k in TR.METRIC_KEYS[1:]}

        class X(NamedTuple):  # the port's runner takes tuples of tensors
            x: torch.Tensor

        def tstep(s):
            return X(0.9 * s.x), {k: torch.tensor(0.5, dtype=torch.float64)
                                  for k in TR.METRIC_KEYS[1:]}

        kw = dict(tolerance=1e-30, max_iterations=140, chunk=20,
                  start_iteration=100)
        jres = jrun(jstep, lambda s: (s, s), jnp.ones((4, 4)), **kw)
        tres = TR.run_fixed_point(tstep, lambda s: (s.x, s.x),
                                  X(torch.ones((4, 4), dtype=torch.float64)),
                                  **kw)
        assert tres.iterations == jres.iterations == 140
        assert len(tres.history["rel_iter"]) == len(
            jres.history["rel_iter"]) == 40
        np.testing.assert_array_equal(tres.history_iters,
                                      np.arange(100, 140))


def test_main_cli_resumes_the_port(repo_root, tmp_path):
    """SKILL.md's checkpoint/resume flow on the port: a budget-capped run
    leaves checkpoints; a second run with a larger budget resumes."""
    def run(budget):
        cmd = [sys.executable, str(repo_root / "main.py"), "solver=gpu/sg",
               "N=12", "Re=100", "solver.device=cpu", "tolerance=1e-6",
               f"max_iterations={budget}", "solver.chunk_size=100",
               f"solver.checkpoint_dir={tmp_path / 'ck'}",
               "solver.checkpoint_every_chunks=1", "plots=false",
               f"mlflow.tracking_uri={tmp_path / 'mlruns'}"]
        proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True,
                              text=True, timeout=300)
        out = proc.stdout + proc.stderr
        assert proc.returncode == 0, out[-3000:]
        return out

    run(200)
    assert sorted(p.name for p in (tmp_path / "ck").glob("ckpt_*.npz")) == [
        "ckpt_000000100.npz", "ckpt_000000200.npz"]
    out = run(400)
    assert "Resumed from checkpoint" in out and "at iteration 200" in out
    assert "Done: 400 iter" in out


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chunk kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
class TestOnCard:
    """A resumed chunk-kernel solve equals the uninterrupted one bit for
    bit (run there with ``python -m pytest tests/test_torch_checkpoint.py
    -m gpu --noconftest``)."""

    # N=48: the resident chunk (sg_kernels.resident_geometry); N=64, past
    # it: the multi-launch chunk
    @pytest.mark.parametrize("n,kernel", [(48, "sg_resident"),
                                          (64, "sg_stage")])
    def test_sg_kernel_resume_is_bit_equal(self, cuda, tmp_path, n, kernel):
        from anap3_tpu_torch.ops import sg_kernels as sgk

        def make(**kw):
            return SGSolver(device="cuda", **make_params(
                nx=n, ny=n, dtype="float32", tolerance=0.0,
                convergence_metric="rel_iter", chunk_size=200, **kw))

        sgk.reset_counts()
        ref, resumed = _resume_pair(make, tmp_path, 200)
        assert sgk.LAUNCHES[kernel] > 0 and not any(
            sgk.PLAIN_CALLS.values())
        assert resumed.metrics.iterations == ref.metrics.iterations == 600
        for a, b in zip(resumed.state, ref.state):
            assert torch.equal(a, b)

    def test_fv_kernel_resume_is_bit_equal(self, cuda, tmp_path):
        from anap3_tpu_torch.ops import fv_kernels as fvk

        def make(**kw):
            return TF.FVSolver(device="cuda", **dict(
                name="fv", Re=100.0, nx=32, ny=32, convection_scheme="TVD",
                limiter="MUSCL", alpha_uv=0.4, alpha_p=0.2,
                corner_treatment="none", dtype="float32", chunk_size=50,
                tolerance=0.0, **kw))

        fvk.reset_counts()
        ref, resumed = _resume_pair(make, tmp_path, 50)
        assert fvk.LAUNCHES["fv_bicgstab"] > 0 and not any(
            fvk.PLAIN_CALLS.values())
        assert resumed.metrics.iterations == ref.metrics.iterations == 150
        for a, b in zip(resumed.state, ref.state):
            assert torch.equal(a, b)
