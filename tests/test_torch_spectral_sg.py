"""anap3_tpu_torch's plain-torch spectral core against anap3_tpu's JAX core.

Inputs are made from a numpy seed and handed to both packages; the JAX side
runs on the CPU in float64 (tests/conftest.py). Tolerances:

- operators: <= 1e-14 absolute (both packages cast the same float64 numpy
  construction);
- states and the six metrics after 5 steps: <= 1e-12 relative to the
  field's max (the two runs differ only in matmul summation order).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anap3_tpu.models import spectral_sg as J
from anap3_tpu.models.params import SpectralParameters as JaxParameters
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import (SpectralParameters, resolve_device,
                                           resolve_dtype)

torch.set_num_threads(1)

_FIELDS = ("Dx", "DyT", "Dxx", "DyyT", "Ix", "IyT", "Gx", "GyT", "bc_u",
           "bc_v", "W2d", "sing_u", "sing_v", "sing_dudx", "sing_dudy",
           "sing_dvdx", "sing_dvdy", "sing_w", "sing_dwx", "sing_dwy")
_SCALARS = ("nu", "beta_sq", "CFL", "lid_velocity", "inv_dx_min",
            "inv_dy_min")


def both_ops(n, corner, Re=1000.0):
    kw = dict(Re=Re, nx=n, ny=n, dtype="float64", corner_treatment=corner,
              basis_type="chebyshev", CFL=1.5)
    jops, _ = J.build_spectral_ops(JaxParameters(**kw))
    tops, _ = T.build_spectral_ops(SpectralParameters(device="cpu", **kw))
    return jops, tops


def random_state(n, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)
    nf = n + 1
    return (scale * rng.standard_normal((nf, nf)),
            scale * rng.standard_normal((nf, nf)),
            scale * rng.standard_normal((nf - 2, nf - 2)))


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


class TestOperators:
    @pytest.mark.parametrize("n", [16, 24])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_build_spectral_ops_matches_jax(self, n, corner):
        jops, tops = both_ops(n, corner)
        for name in _FIELDS:
            a, b = getattr(jops, name), getattr(tops, name)
            if a is None:
                assert b is None, name
                continue
            assert b.dtype == torch.float64 and b.is_contiguous(), name
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-14, err_msg=name)
        for name in _SCALARS:
            assert getattr(tops, name) == pytest.approx(
                float(getattr(jops, name)), rel=0, abs=1e-14)
        np.testing.assert_array_equal(tops.interior.numpy(),
                                      np.asarray(jops.interior))

    def test_ops_from_jax_round_trip(self):
        jops, tops = both_ops(16, "singular")
        conv = T.ops_from_jax(jops, "cpu", torch.float64)
        for name in _FIELDS:
            assert torch.equal(getattr(conv, name), getattr(tops, name)), name
        assert conv.nu == tops.nu and conv.singular

    def test_initial_state_matches_jax(self):
        for corner in ("smoothing", "singular"):
            jops, tops = both_ops(16, corner)
            js = J.initial_state(jops)
            ts = T.state_to_numpy(T.initial_state(tops))
            for a, b in zip(ts, js):
                np.testing.assert_array_equal(a, np.asarray(b))


class TestStep:
    @pytest.mark.parametrize("Re", [100.0, 1000.0])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    @pytest.mark.parametrize("with_tau", [False, True])
    def test_sg_step_matches_jax(self, Re, corner, with_tau):
        n = 16
        jops, tops = both_ops(n, corner, Re=Re)
        u, v, p = random_state(n, seed=int(Re) + with_tau)
        interior = tops.interior.numpy()  # random interior, exact walls
        u = np.where(interior, u, tops.bc_u.numpy())
        v = np.where(interior, v, tops.bc_v.numpy())
        js = J.SpectralState(*(jnp.asarray(a) for a in (u, v, p)))
        ts = T.state_from_numpy((u, v, p), "cpu", torch.float64)
        jtau = ttau = None
        if with_tau:
            tau = random_state(n, seed=7, scale=0.01)
            jtau = tuple(jnp.asarray(a) for a in tau)
            ttau = tuple(torch.as_tensor(a) for a in tau)
        for _ in range(5):
            js, jm = J.sg_step(jops, js, jtau)
            ts, tm = T.sg_step(tops, ts, ttau)
        for a, b in zip(T.state_to_numpy(ts), js):
            assert rel(a, b) <= 1e-12
        assert set(tm) == set(jm)
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-12), k

    def test_diagnostics_match_jax(self):
        jops, tops = both_ops(16, "singular")
        u, v, p = random_state(16, seed=3)
        tu, tv = torch.as_tensor(u), torch.as_tensor(v)
        assert rel(T.vorticity(tops, tu, tv).numpy(),
                   J.vorticity(jops, jnp.asarray(u), jnp.asarray(v))) <= 1e-12
        assert rel(T.vorticity(tops, tu, tv, total=False).numpy(),
                   J.vorticity(jops, jnp.asarray(u), jnp.asarray(v),
                               total=False)) <= 1e-12
        for a, b in zip(T.conserved_quantities(tops, tu, tv),
                        J.conserved_quantities(jops, jnp.asarray(u),
                                               jnp.asarray(v))):
            assert float(a) == pytest.approx(float(b), rel=1e-12)
        assert float(T.adaptive_dt(tops, tu, tv)) == pytest.approx(
            float(J.adaptive_dt(jops, jnp.asarray(u), jnp.asarray(v))),
            rel=1e-14)
        np.testing.assert_allclose(
            T.extrapolate_inner_to_full(torch.as_tensor(p)).numpy(),
            np.asarray(J.extrapolate_inner_to_full(jnp.asarray(p))),
            rtol=0, atol=1e-15)

    def test_rk4_step_is_sg_step_without_quadratures(self):
        _, tops = both_ops(12, "smoothing")
        st = T.state_from_numpy(random_state(12, seed=5), "cpu", torch.float64)
        new, (R_u, R_v, R_p) = T.rk4_step(tops, st)
        ref, m = T.sg_step(tops, st)
        for a, b in zip(new, ref):
            assert torch.equal(a, b)
        assert torch.equal(torch.linalg.norm(R_p), m["continuity"])


class TestDevicePolicy:
    def test_auto_dtype_follows_device(self):
        assert resolve_dtype("auto", "cpu") == "float64"
        assert resolve_dtype("auto", "cuda") == "float32"
        assert resolve_dtype("float32", "cpu") == "float32"

    def test_cuda_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is present: there is no absence to test")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
        assert resolve_device("cpu") == torch.device("cpu")

    def test_parameters_default_to_cuda(self):
        assert SpectralParameters().device == "cuda"


def test_port_imports_no_jax(repo_root):
    """The port's solver and kernel modules load without pulling in jax."""
    code = ("import sys; import anap3_tpu_torch.models.spectral, "
            "anap3_tpu_torch.ops.sg_kernels, anap3_tpu_torch.models; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo_root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
