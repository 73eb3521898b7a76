"""The plain references against the port's plain path on the CPU at
small sizes: the same operators from the configuration; states the port
converges in float64 read as converged, by amounts that fall with the
tolerance; and the same validation numbers from the same state."""

import json

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import spectral_sg as core
from anap3_tpu_torch.models.fv import FVSolver
from anap3_tpu_torch.models.params import FVParameters, SpectralParameters
from anap3_tpu_torch.models.spectral import FSGSolver
from ldc_bench import drive, spec
from ldc_bench.reference import fv as ref_fv
from ldc_bench.reference import spectral as ref_sg
from ldc_bench.reference import validation as ref_val

ROOT = spec.ROOT


def params(name, **kw):
    cfg = json.loads((ROOT / f"ldc_bench/configs/{name}.json").read_text())
    return dict(cfg["params"], **kw)


@pytest.mark.parametrize("n", [12, 24, 48])
def test_operators_match_the_port(n):
    p = params("fsg-re1000", nx=n, ny=n, dtype="float64", device="cpu",
               lid_velocity=1.0 + 2 ** -20, corner_smoothing=0.07)
    ops, grid = core.build_spectral_ops(SpectralParameters(**p))
    cav = ref_sg.Cavity(n, p)
    assert np.allclose(cav.x, grid["x_nodes"], rtol=0, atol=1e-15)
    scale = np.abs(grid["Dx"]).max()
    assert np.abs(cav.Dx - grid["Dx"]).max() <= 1e-13 * scale
    assert np.abs(cav.Ix - grid["Ix"]).max() <= 1e-12
    assert np.abs(cav.bc_u - ops.bc_u.numpy()).max() <= 1e-15
    rng = np.random.default_rng(n)
    u, v = rng.standard_normal((2, n + 1, n + 1))
    pr = rng.standard_normal((n - 1, n - 1))
    mine = cav.rhs(u, v, pr)
    theirs = core.residuals(ops, *(torch.as_tensor(a) for a in (u, v, pr)))
    for a, b in zip(mine, theirs):
        assert np.abs(a - b.numpy()).max() <= 1e-10 * np.abs(a).max()


def solved(cls, prm_cls, p):
    s = cls(params=prm_cls(**p))
    s.solve()
    return s


@pytest.fixture(scope="module")
def fsg_states():
    out = {}
    for tol in (1e-4, 1e-6):
        p = params("fsg-re1000", nx=24, ny=24, Re=100.0, dtype="float64",
                   device="cpu", tolerance=tol, max_iterations=50000,
                   chunk_size=1000)
        out[tol] = (p, solved(FSGSolver, SpectralParameters, p))
    return out


def test_spectral_judgement_falls_with_the_tolerance(fsg_states):
    got = {}
    for tol, (p, s) in fsg_states.items():
        u, v, pr = (t.numpy() for t in s.state)
        got[tol] = ref_sg.judge(p, 24, u, v, pr)
        assert got[tol]["uv_step"] <= 1.5 * tol
        assert got[tol]["wall"] == 0.0
    assert got[1e-6]["uv_step"] < got[1e-4]["uv_step"] / 50
    assert got[1e-6]["p_step"] < got[1e-4]["p_step"] / 5


def test_spectral_validation_is_worked_out_again(fsg_states):
    p, s = fsg_states[1e-6]
    reported = s.compute_validation_errors(base_dir=ROOT, save_plots=False)
    u, v, _ = (t.numpy() for t in s.state)
    worked = ref_val.l2_errors(ROOT, p, ref_val.spectral_evaluator(
        24, p, u, v))
    assert set(worked) == set(reported) == {"u_L2_error", "v_L2_error"}
    assert ref_val.gap(reported, worked) <= 1e-12
    # the bfloat16 answer: far beyond rounding on every number
    st = [drive.bf16(a) for a in (u, v, s.state.p.numpy())]
    bf = ref_sg.judge(p, 24, *st)
    assert bf["uv_step"] > 100 * ref_sg.judge(p, 24, u, v,
                                              s.state.p.numpy())["uv_step"]
    assert bf["wall"] > 1e-4


@pytest.fixture(scope="module")
def fv_states():
    out = {}
    for tol in (1e-4, 1e-7):
        p = params("fv-simple", nx=16, ny=16, dtype="float64", device="cpu",
                   tolerance=tol, max_iterations=20000, chunk_size=200)
        out[tol] = (p, solved(FVSolver, FVParameters, p))
    return out


def test_fv_judgement_falls_with_the_tolerance(fv_states):
    got = {}
    for tol, (p, s) in fv_states.items():
        got[tol] = ref_fv.judge(p, *(t.numpy() for t in s.state))
    assert got[1e-7]["mom"] < got[1e-4]["mom"] / 300
    assert got[1e-7]["mom"] < 1e-6


def test_fv_validation_is_worked_out_again(fv_states):
    p, s = fv_states[1e-7]
    reported = s.compute_validation_errors(base_dir=ROOT, save_plots=False)
    state = [t.numpy() for t in s.state]
    worked = ref_val.l2_errors(ROOT, p, ref_val.fv_evaluator(
        p, state[0], state[1]))
    assert ref_val.gap(reported, worked) <= 1e-12
    bf = ref_fv.judge(p, *(drive.bf16(a) for a in state))
    assert bf["mom"] > 100 * ref_fv.judge(p, *state)["mom"]


def test_fv_reference_refuses_other_numerics():
    p = params("fv-simple", convection_scheme="Upwind")
    z = np.zeros((4, 4))
    with pytest.raises(ValueError):
        ref_fv.judge(p, z, z, z, z[:, :3], z[:3, :])
