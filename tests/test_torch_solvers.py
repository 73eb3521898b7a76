"""anap3_tpu_torch's SGSolver / FSGSolver against anap3_tpu's, on the CPU.

Both packages run the same float64 configuration; iterations and
``converged`` must be equal and the final fields agree within 1e-10
absolute. The CLI test drives the port through ``main.py solver=gpu/sg``
with ``solver.device=cpu``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from anap3_tpu.models.spectral import FSGSolver as JaxFSG
from anap3_tpu.models.spectral import SGSolver as JaxSG
from anap3_tpu_torch.models.spectral import (FSGSolver, SGSolver,
                                             make_fused_paths)
from anap3_tpu_torch.ops import sg_kernels as sgk

torch.set_num_threads(1)

BASE = dict(Re=100.0, dtype="float64", basis_type="chebyshev", CFL=1.5,
            convergence_metric="rel_iter")


def assert_same_solve(port, ref, atol=1e-10):
    assert port.metrics.iterations == ref.metrics.iterations
    assert port.metrics.converged == ref.metrics.converged
    for name in ("u", "v", "p"):
        np.testing.assert_allclose(getattr(port.fields, name),
                                   getattr(ref.fields, name), rtol=0,
                                   atol=atol, err_msg=name)
    assert port.metrics.psi_min == pytest.approx(ref.metrics.psi_min,
                                                 rel=1e-8)


class TestSG:
    @pytest.mark.parametrize("corner,tol,max_it", [
        ("smoothing", 1e-3, 2000),
        ("smoothing", 1e-6, 300),
        ("singular", 1e-3, 2000),
    ])
    def test_matches_jax(self, corner, tol, max_it):
        kw = dict(BASE, nx=12, ny=12, tolerance=tol, max_iterations=max_it,
                  chunk_size=100, corner_treatment=corner)
        ref = JaxSG(**kw)
        ref.solve()
        port = SGSolver(device="cpu", **kw)
        port.solve()
        assert port.device == torch.device("cpu")
        assert_same_solve(port, ref)
        assert port.metrics.final_energy == pytest.approx(
            ref.metrics.final_energy, rel=1e-10)

    def test_fused_wrappers_on_cpu_match_the_plain_step(self):
        """use_pallas=true runs the kernel wrappers; on CPU tensors they take
        their plain versions, with the same iterations and fields."""
        kw = dict(BASE, nx=12, ny=12, tolerance=1e-3, max_iterations=2000,
                  chunk_size=100, device="cpu")
        plain = SGSolver(use_pallas="false", **kw)
        plain.solve()
        sgk.reset_counts()
        fused = SGSolver(use_pallas="true", **kw)
        fused.solve()
        assert sgk.PLAIN_CALLS["sg_chunk"] > 0
        assert not any(sgk.LAUNCHES.values())
        assert_same_solve(fused, plain, atol=0.0)

    def test_make_fused_paths_is_one_pair_for_every_n(self):
        for n in (12, 20, 30):
            solver = SGSolver(device="cpu", **dict(BASE, nx=n, ny=n))
            step, factory = make_fused_paths(solver.ops)
            state, metrics = step(solver.state)
            assert set(metrics) == {"u_eq", "v_eq", "continuity", "energy",
                                    "enstrophy", "palinstrophy"}
            out = factory(3, 1e-30, "rel_iter")(solver.state, 0, np.inf)
            assert out[4].shape == (3, 7) and out[4].dtype == torch.float64

    def test_unported_options_raise(self):
        kw = dict(BASE, nx=12, ny=12, device="cpu")
        with pytest.raises(NotImplementedError, match="checkpoint"):
            SGSolver(checkpoint_dir="/nonexistent", **kw)
        with pytest.raises(NotImplementedError, match="x1"):
            SGSolver(matmul_algorithm="x1", use_pallas="true", **kw).solve()
        with pytest.raises(NotImplementedError, match="Newton"):
            SGSolver(newton_polish=True, **kw).solve()


class TestFSG:
    def test_matches_jax(self):
        kw = dict(BASE, nx=24, ny=24, tolerance=1e-4, max_iterations=3000,
                  chunk_size=500, n_levels=2, coarse_tolerance_factor=1.0,
                  multigrid="fsg")
        ref = JaxFSG(**kw)
        ref.solve()
        port = FSGSolver(device="cpu", **kw)
        port.solve()
        assert [lv["n"] for lv in port.levels] == ref._level_orders() == [12, 24]
        assert port.metrics.converged
        assert_same_solve(port, ref)
        for key in ("energy", "continuity_residual"):  # synthesized history
            assert getattr(port.time_series, key) == pytest.approx(
                getattr(ref.time_series, key), rel=1e-8)

    def test_divergence_leaves_a_fine_shaped_nan_state(self):
        kw = dict(BASE, nx=24, ny=24, tolerance=1e-4, max_iterations=200,
                  chunk_size=100, n_levels=2, coarse_tolerance_factor=1.0,
                  CFL=50.0, device="cpu")
        port = FSGSolver(**kw)
        port.solve()
        assert not port.metrics.converged
        assert port.levels[0]["n"] == 12 and len(port.levels) == 1
        assert port.state.u.shape == (25, 25)
        assert torch.isnan(port.state.u).all()


def test_main_cli_drives_the_port(repo_root, tmp_path):
    cmd = [sys.executable, str(repo_root / "main.py"), "solver=gpu/sg",
           "N=12", "Re=100", "solver.device=cpu", "tolerance=1e-3",
           "max_iterations=300", "plots=false",
           f"mlflow.tracking_uri={tmp_path / 'mlruns'}"]
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "Done:" in out
    assert "anap3_tpu_torch" in out  # the port's modules logged the run
