"""anap3_tpu_torch's Schur BiCGSTAB kernel (ops/nk_kernels.py,
csrc/nk_schur.cu) and the graphed Newton matvec (models/steady._Matvec).

On the CPU, float64, at N = 12-20:

- ``_Matvec`` (static x / y buffers, ``inv_dt`` a 0-d tensor, reused
  across PTC steps and dt changes) gives the bits of the eager
  ``matvec_fused`` with a Python float ``inv_dt``, both lids; its
  ``precond_apply`` those of ``precond.apply``.
- ``schur_solve`` on a CPU tensor is the plain loop (counted in
  PLAIN_CALLS, bit-equal to ``schur_bicgstab`` on ``schur_apply``) and
  matches ``jax.scipy.sparse.linalg.bicgstab`` on the JAX package's Schur
  operator within 1e-12 while cut by its budget.
- Operators of the kernel's form can make the operator any matrix M
  (S(P) = M P): the breakdown codes -10 and -11 of the plain loop appear
  through ``schur_solve``, as through ``models/fv.bicgstab``.
- The kernel's folded operators (``SchurOps``: Lx, Ly, Rx, Ry, Cx, Ey,
  computed once in numpy float64), applied in the kernel's 4-level order
  by ``folded_apply``, give ``schur_apply`` within 1e-14 relative at N =
  12-128, both lids, dt 0.05 / 1 / 3e3, and the masked loop on them stays
  within FOLD_B8_TOL of ``schur_plain`` at budget 8 (at N=256, where
  budget 8 amplifies any change of sum order beyond that, within
  FOLD_SPREAD times the distance of the loop on ``reassociated_apply``,
  the unfolded products associated the other way); ``matrix_ops``
  operators fold exactly, and the padded table holds the folds and zeros.
- The ctypes bindings match the C entries of ``csrc/nk_host.cu``, the
  pointer and operator tables the header's enums; the launch counters.

On a CUDA card (marker ``gpu``; run there with ``python -m pytest
tests/test_torch_nk.py -m gpu --noconftest``): the kernel against the plain
loop at ni = 11, 19, 95, 127 (operator bands resident in shared memory)
and 255 (streamed; budgets 8 and 16 only), dt 0.05 / 1 / 3e3, both lids,
with the plain
loop on the CPU as the yardstick of rounding (budgets 8 and 16: equal k
and within 1e-12 relative or 10x the CPU loop's distance; budget 40: k
within 2, converged solves within the 1e-8 test on their true residuals,
unconverged ones' residuals against the plain loop's over perturbed
right-hand sides: see TestOnCard), the breakdown codes and the exit on
||s||, the replayed graph against the eager matvec (bit for bit), and that
a CUDA matvec launches the kernel and never the plain loop.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import fv as TF
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models import steady as TS
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.ops import nk_kernels as nk

torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def host(t):
    return t.detach().cpu().numpy()


LIDS = {"smoothing": dict(Re=250.0, corner_treatment="smoothing"),
        "singular": dict(Re=1000.0, corner_treatment="singular")}


def problem(n, lid, device="cpu"):
    p = SpectralParameters(nx=n, ny=n, dtype="float64", device=device,
                           **LIDS[lid])
    ops, grid = T.build_spectral_ops(p)
    prob = TS._SteadyProblem(ops)
    return prob, TS._StokesPreconditioner(prob, grid)


def point(prob, seed):
    """A seeded state near rest, as a host vector."""
    x0 = host(prob.state_to_x(T.initial_state(prob.ops)))
    return x0 + np.random.default_rng(seed).standard_normal(prob.n_tot) * 0.01


def schur_rhs(prob, pre, inv_dt, seed=5):
    """The Schur right-hand side of one preconditioner application to a
    seeded vector, and inv_hlam."""
    inv_hlam = pre.inv_hlam(inv_dt)
    r = prob.to_device(np.random.default_rng(seed).standard_normal(prob.n_tot))
    r_u, r_v, r_p = prob.unflatten(r)
    S = pre.schur
    rhs = r_p - pre.beta_sq * nk.div(S, nk.hsolve(S, r_u, inv_hlam),
                                     nk.hsolve(S, r_v, inv_hlam))
    return rhs.contiguous(), inv_hlam


def folded_apply(S, pp, inv_dt, inv_hlam):
    """S(pp) on the folded operators in the kernel's order of product
    levels (csrc/nk_schur.cu: level 1 to 4)."""
    wx, wy = S.Lx @ pp, S.Ly @ pp
    zx, zy = (wx @ S.Rx) * inv_hlam, (wy @ S.Ry) * inv_hlam
    ax, ay = S.Cx @ zx, S.Vx @ zy
    d = torch.cat([ax, ay], 1) @ torch.cat([S.VyT, S.Ey], 0)
    return inv_dt * pp - S.beta_sq * d


def reassociated_apply(S, pp, inv_dt, inv_hlam):
    """``schur_apply`` with each two-sided product associated the other
    way (A (P B) for (A P) B): the same operators, another rounding."""
    def hsolve(f):
        return (S.Vx @ ((S.Vxi @ (f @ S.Vyi.T)) * inv_hlam)) @ S.Vy.T

    gx, gy = S.Gxr @ (pp @ S.IyTr), S.Ixr @ (pp @ S.GyTr)
    return inv_dt * pp - S.beta_sq * nk.div(S, hsolve(gx), hsolve(gy))


def matrix_ops(M, device="cpu"):
    """Operators of the kernel's form with S(P) = M P (inv_dt 0, beta^2
    -1): the x branch is M then identities, the y branch zero."""
    M = torch.as_tensor(M, dtype=torch.float64, device=device)
    n = M.shape[0]
    eye = torch.eye(n, dtype=torch.float64, device=device)
    zero = torch.zeros_like(eye)
    S = nk.SchurOps(Gxr=M, IyTr=eye, Ixr=zero, GyTr=zero, Vxi=eye, Vyi=eye,
                    Vx=eye, Vy=eye, Dxi=eye, DyTi=zero, beta_sq=-1.0)
    return S, torch.ones_like(eye)


# the systems of tests/test_torch_steady.py::test_breakdown_codes_match_fv
BREAKDOWNS = [
    (-10, [[0.0, 2.0, 2.0], [1.0, 1.0, 2.0], [1.0, -1.0, -2.0]],
     [0.0, -1.0, 0.0]),
    (-11, [[1.0, -2.0], [1.0, 0.0]], [1.0, 0.0]),
]


# S = 2 I: s = 0 after the first half-step, so the loop takes its exit on
# ||s|| at k = 1 with x = b / 2
EXIT = (1, [[2.0, 0.0], [0.0, 2.0]], [1.0, -3.0])


def breakdown_system(A, b, device="cpu"):
    """(S, inv_hlam, rhs): b in the right-hand side's first column, zeros
    in the others (S acts column by column and the dot products add exact
    zeros, so the solve is the vector solve)."""
    S, inv_hlam = matrix_ops(A, device)
    rhs = torch.zeros_like(inv_hlam)
    rhs[:, 0] = torch.as_tensor(b, dtype=torch.float64, device=device)
    return S, inv_hlam, rhs


@pytest.fixture
def counts():
    nk.reset_counts()
    yield
    nk.reset_counts()


# ------------------------------------------------------------- on the CPU


class TestMatvecPlumbing:
    @pytest.mark.parametrize("n", [12, 20])
    @pytest.mark.parametrize("lid", sorted(LIDS))
    def test_buffers_give_the_eager_bits(self, n, lid):
        """Two PTC steps (x and dt changed in place), two vectors each:
        every result bit-equal to the eager matvec with a float inv_dt."""
        prob, pre = problem(n, lid)
        mv = TS._Matvec(prob, pre)
        assert not mv.graphed
        rng = np.random.default_rng(11)
        for step, dt in enumerate((0.05, 3.0)):
            x = point(prob, seed=step)
            mv.set_step(x, 1.0 / dt)
            assert mv.inv_dt.dim() == 0 and float(mv.inv_dt) == 1.0 / dt
            inv_hlam = pre.inv_hlam(1.0 / dt)
            assert torch.equal(mv.inv_hlam, inv_hlam)
            for _ in range(2):
                y = rng.standard_normal(prob.n_tot)
                want = host(TS.matvec_fused(prob, pre, prob.to_device(x),
                                            prob.to_device(y), 1.0 / dt,
                                            inv_hlam))
                got = mv(y)
                np.testing.assert_array_equal(got, want)
            want = host(pre.apply(prob.to_device(y), 1.0 / dt, inv_hlam))
            np.testing.assert_array_equal(mv.precond_apply(y), want)

    def test_results_are_copies(self):
        prob, pre = problem(12, "smoothing")
        mv = TS._Matvec(prob, pre)
        mv.set_step(point(prob, 0), 20.0)
        y = np.random.default_rng(1).standard_normal(prob.n_tot)
        first = mv(y)
        kept = first.copy()
        mv(2.0 * y)
        np.testing.assert_array_equal(first, kept)

    def test_ptc_solve_drives_the_buffers(self, monkeypatch):
        """ptc_solve's GMRES vectors all go through one _Matvec."""
        made = []
        real = TS._Matvec

        class Spy(real):
            def __init__(self, *a):
                super().__init__(*a)
                self.calls = 0
                made.append(self)

            def __call__(self, y):
                self.calls += 1
                return super().__call__(y)

        monkeypatch.setattr(TS, "_Matvec", Spy)
        prob, pre = problem(12, "smoothing")
        stats = {}
        x0 = host(prob.state_to_x(T.initial_state(prob.ops)))
        TS.ptc_solve(prob, pre, x0, tol_rms=1e-8, max_steps=3,
                     gmres_vectors=20, dt0=0.05, dt_max=3e3, stats=stats)
        assert len(made) == 1
        assert made[0].calls == sum(stats["gmres_vectors"]) > 0


class TestPlainDispatch:
    @pytest.mark.parametrize("maxiter", [8, 40])
    def test_cpu_takes_the_plain_loop(self, counts, maxiter):
        prob, pre = problem(12, "singular")
        rhs, inv_hlam = schur_rhs(prob, pre, 1.0 / 0.05)
        dp, k = nk.schur_solve(pre.schur, rhs, 1.0 / 0.05, inv_hlam, 1e-8,
                               maxiter)
        assert nk.PLAIN_CALLS["nk_schur"] == 1
        assert nk.LAUNCHES["nk_schur"] == 0
        x_ref, k_ref = nk.schur_bicgstab(
            lambda pp: nk.schur_apply(pre.schur, pp, 1.0 / 0.05, inv_hlam),
            rhs, 1e-8, maxiter)
        assert torch.equal(dp, x_ref) and int(k) == int(k_ref)
        assert dp.shape == rhs.shape and k.dtype == torch.int32

    def test_other_devices_raise(self):
        S, inv_hlam, rhs = breakdown_system(*BREAKDOWNS[1][1:])
        with pytest.raises(ValueError, match="not on meta"):
            nk.schur_solve(S, rhs.to("meta"), 0.0, inv_hlam, 1e-8, 4)
        with pytest.raises(ValueError, match="runs on cuda"):
            nk.schur_kernel(S, rhs, 0.0, inv_hlam, 1e-8, 4)

    @pytest.mark.parametrize("code,A,b", BREAKDOWNS)
    def test_breakdown_codes_in_the_kernels_form(self, code, A, b):
        """The operators of the kernel's form reproduce the breakdowns of
        models/fv.bicgstab on M (the vector systems of
        test_torch_steady.py)."""
        S, inv_hlam, rhs = breakdown_system(A, b)
        x, k = nk.schur_solve(S, rhs, 0.0, inv_hlam, 1e-8, 10)
        A_t = torch.tensor(A, dtype=torch.float64)
        b_t = torch.tensor(b, dtype=torch.float64)
        x_f, k_f = TF.bicgstab(lambda v: A_t @ v, b_t, torch.zeros_like(b_t),
                               tol=1e-8, maxiter=10)
        assert int(k) == k_f == code
        assert torch.equal(x[:, 0], x_f)
        assert not bool(x[:, 1:].any())

    def test_s_exit_in_the_kernels_form(self):
        """The exit on ||s||^2 < tol^2 ||b||^2 with its x and r updates:
        one iteration, x = b / 2, as models/fv.bicgstab takes it."""
        S, inv_hlam, rhs = breakdown_system(*EXIT[1:])
        x, k = nk.schur_solve(S, rhs, 0.0, inv_hlam, 1e-8, 10)
        b_t = torch.tensor(EXIT[2], dtype=torch.float64)
        x_f, k_f = TF.bicgstab(lambda v: 2.0 * v, b_t, torch.zeros_like(b_t),
                               tol=1e-8, maxiter=10)
        assert int(k) == k_f == EXIT[0]
        assert torch.equal(x, rhs / 2) and torch.equal(x[:, 0], x_f)

    def test_matrix_ops_apply_M(self):
        """S(P) is exactly M P: held bit for bit against the product of the
        same library (torch), not numpy's, whose sum order may differ."""
        M = np.random.default_rng(3).standard_normal((5, 5))
        S, inv_hlam = matrix_ops(M)
        P = torch.as_tensor(np.random.default_rng(4).standard_normal((5, 5)))
        np.testing.assert_array_equal(
            host(nk.schur_apply(S, P, 0.0, inv_hlam)),
            host(torch.as_tensor(M) @ P))


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from anap3_tpu.models import spectral_sg as J
    from anap3_tpu.models import steady as JS
    from anap3_tpu.models.params import SpectralParameters as JP

    return SimpleNamespace(jax=jax, jnp=jnp, J=J, JS=JS, JP=JP)


@pytest.mark.parametrize("n", [12, 16])
@pytest.mark.parametrize("lid", sorted(LIDS))
def test_schur_solve_matches_jax_within_its_budget(jx, n, lid):
    """nk.schur_solve against jax.scipy.sparse.linalg.bicgstab on the JAX
    preconditioner's Schur operator, cut by a budget of 8 before the
    products' rounding is amplified (the bound of
    test_torch_steady.py::test_schur_bicgstab_matches_jax)."""
    jops, jgrid = jx.J.build_spectral_ops(
        jx.JP(nx=n, ny=n, dtype="float64", **LIDS[lid]), dtype=jx.jnp.float64)
    jprob = jx.JS._SteadyProblem(jops)
    jpre = jx.JS._StokesPreconditioner(jprob, jgrid)
    prob, pre = problem(n, lid)
    inv_dt = 1.0 / 0.5
    rhs, inv_hlam = schur_rhs(prob, pre, inv_dt)
    j_inv = jpre.inv_hlam(jx.jnp.float64(inv_dt))

    def s_j(pp):
        gx, gy = jpre._grad(pp)
        return inv_dt * pp - jpre.beta_sq * jpre._div(
            jpre._hsolve(gx, j_inv), jpre._hsolve(gy, j_inv))

    x_j, _ = jx.jax.scipy.sparse.linalg.bicgstab(
        s_j, jx.jnp.asarray(host(rhs)), tol=1e-14, maxiter=8)
    x_t, k_t = nk.schur_solve(pre.schur, rhs, inv_dt, inv_hlam, 1e-14, 8)
    assert int(k_t) == 8
    assert rel(host(x_t), np.asarray(x_j)) < 1e-12


_CPU = {}


def cpu_problem(n, lid):
    if (n, lid) not in _CPU:
        _CPU[(n, lid)] = problem(n, lid)
    return _CPU[(n, lid)]


# the masked loop on the folded operators against schur_plain at budget 8:
# the fold's rounding (<= 3.8e-15 an S-apply) amplified by the iterations;
# worst reading 7.4e-13 over the 24 systems (13x margin; the host BLAS's
# sum order moves it: 2.7e-12 with level 4 summed as two products)
FOLD_B8_TOL = 1e-11
# at N=256 budget 8 amplifies any change of sum order beyond that (the sharp
# lid at dt 0.05: 2.1e-7 for the re-association, 1.4e-6 for the host BLAS
# in 4 threads instead of 1), so there the fold is held to FOLD_SPREAD times
# the re-association's distance; the fold's over the re-association's is
# 0.07-2.96 at N = 12-256 (3.4x margin)
FOLD_SPREAD = 10.0


class TestFold:
    @pytest.mark.parametrize("dt", [0.05, 1.0, 3e3])
    @pytest.mark.parametrize("n", [12, 20, 96, 128])
    @pytest.mark.parametrize("lid", sorted(LIDS))
    def test_folded_apply_matches_schur_apply(self, lid, n, dt):
        """One S-apply on the Schur right-hand side: the fold moves it by
        rounding only (readings <= 3.8e-15)."""
        prob, pre = cpu_problem(n, lid)
        rhs, inv_hlam = schur_rhs(prob, pre, 1.0 / dt)
        got = folded_apply(pre.schur, rhs, 1.0 / dt, inv_hlam)
        want = nk.schur_apply(pre.schur, rhs, 1.0 / dt, inv_hlam)
        assert rel(host(got), host(want)) <= 1e-14

    @pytest.mark.parametrize("dt", [0.05, 1.0, 3e3])
    @pytest.mark.parametrize("n", [12, 20, 96, 128])
    @pytest.mark.parametrize("lid", sorted(LIDS))
    def test_folded_loop_matches_the_plain_loop(self, lid, n, dt):
        prob, pre = cpu_problem(n, lid)
        rhs, inv_hlam = schur_rhs(prob, pre, 1.0 / dt)
        x_f, k_f = nk.schur_bicgstab(
            lambda pp: folded_apply(pre.schur, pp, 1.0 / dt, inv_hlam), rhs,
            1e-8, 8)
        x_p, k_p = nk.schur_plain(pre.schur, rhs, 1.0 / dt, inv_hlam, 1e-8,
                                  8)
        assert int(k_f) == int(k_p) == 8
        assert rel(host(x_f), host(x_p)) <= FOLD_B8_TOL

    @pytest.mark.parametrize("dt", [0.05, 1.0, 3e3])
    @pytest.mark.parametrize("lid", sorted(LIDS))
    def test_folded_loop_matches_the_plain_loop_at_n256(self, lid, dt):
        """The order the kernel streams its operator bands at: the fold's
        distance from the plain loop at budget 8 within FOLD_SPREAD times
        that of the loop on ``reassociated_apply`` (or FOLD_B8_TOL)."""
        prob, pre = cpu_problem(256, lid)
        rhs, inv_hlam = schur_rhs(prob, pre, 1.0 / dt)
        loops = [nk.schur_bicgstab(
            lambda pp, f=f: f(pre.schur, pp, 1.0 / dt, inv_hlam), rhs, 1e-8,
            8) for f in (folded_apply, reassociated_apply)]
        x_p, k_p = nk.schur_plain(pre.schur, rhs, 1.0 / dt, inv_hlam, 1e-8,
                                  8)
        (x_f, k_f), (x_r, k_r) = loops
        assert int(k_f) == int(k_r) == int(k_p) == 8
        err, spread = rel(host(x_f), host(x_p)), rel(host(x_r), host(x_p))
        assert err <= max(FOLD_B8_TOL, FOLD_SPREAD * spread), (err, spread)

    @pytest.mark.parametrize("n", [2, 5, 17])
    def test_matrix_ops_fold_exactly(self, n):
        """S(P) = M P: Lx is M, the identities and zeros pass through, bit
        for bit, and the folded apply is the product Lx P alone."""
        M = np.random.default_rng(n).standard_normal((n, n))
        S, inv_hlam = matrix_ops(M)
        eye = np.eye(n)
        want = {"Lx": M, "Ly": 0 * eye, "Rx": eye, "Ry": 0 * eye,
                "Cx": eye, "Vx": eye, "VyT": eye, "Ey": 0 * eye}
        for name, mat in want.items():
            np.testing.assert_array_equal(host(getattr(S, name)), mat)
        P = torch.as_tensor(np.random.default_rng(n + 1).standard_normal(
            (n, n)))
        np.testing.assert_array_equal(
            host(folded_apply(S, P, 0.0, inv_hlam)), host(S.Lx @ P))

    @pytest.mark.parametrize("n", [12, 20])
    def test_the_table_holds_the_folds(self, n):
        """The kernel's table: the numpy float64 folds in _FOLDED order,
        each name its (ni x ni) view, zero beyond ni up to whole tiles."""
        _, pre = cpu_problem(n, "singular")
        S = pre.schur
        ni, n_p = n - 1, -(-(n - 1) // 16) * 16
        h = {k: host(getattr(S, k)) for k in (
            "Gxr", "IyTr", "Ixr", "GyTr", "Vxi", "Vyi", "Vx", "Vy", "Dxi",
            "DyTi")}
        want = {"Lx": h["Vxi"] @ h["Gxr"], "Ly": h["Vxi"] @ h["Ixr"],
                "Rx": h["IyTr"] @ h["Vyi"].T, "Ry": h["GyTr"] @ h["Vyi"].T,
                "Cx": h["Dxi"] @ h["Vx"], "Vx": h["Vx"], "VyT": h["Vy"].T,
                "Ey": h["Vy"].T @ h["DyTi"]}
        assert S.folded.shape == (8, n_p, n_p)
        assert S.folded.dtype == torch.float64
        table = host(S.folded)
        for i, name in enumerate(nk._FOLDED):
            np.testing.assert_array_equal(table[i, :ni, :ni], want[name])
            np.testing.assert_array_equal(host(getattr(S, name)),
                                          want[name])
        assert not table[:, ni:, :].any() and not table[:, :, ni:].any()


def test_bindings_match_the_c_entries():
    """Every C entry of csrc/nk_host.cu has a ctypes binding with its
    number of arguments (the card cannot be asked here)."""
    from anap3_tpu_torch.ops import _build

    class Fake:
        def __getattr__(self, name):
            fn = SimpleNamespace(argtypes=None, restype=None)
            setattr(self, name, fn)
            return fn

    lib = Fake()
    _build._BIND["nk"](lib)
    host_cu = Path(_build.__file__).parents[1] / "csrc" / "nk_host.cu"
    text = host_cu.read_text().split('extern "C" {', 1)[1]
    entries = re.findall(r"^[\w ]+?\**\s*(\w+)\(([^)]*)\)\s*\{", text, re.M)
    assert {name for name, _ in entries} == {"nk_schur_run",
                                             "nk_schur_geometry",
                                             "nk_error_string"}
    for name, args in entries:
        assert len(getattr(lib, name).argtypes) == len(args.split(",")), name
    assert [p.name for p in _build.sources("nk")] == [
        "nk_host.cu", "nk_schur.cu", "nk_common.cuh"]


def test_pointer_table_matches_the_header():
    header = (Path(nk.__file__).parents[1] / "csrc" /
              "nk_common.cuh").read_text()
    body = header.split("enum Ptr {", 1)[1].split("};", 1)[0]
    names = re.findall(r"\bP_(\w+)", body)
    assert names[-1] == "COUNT"
    assert [n.lower() for n in names[:-1]] == [
        n.lower() for n in nk._PTR_NAMES]


def test_operator_table_matches_the_header():
    header = (Path(nk.__file__).parents[1] / "csrc" /
              "nk_common.cuh").read_text()
    body = header.split("enum Op {", 1)[1].split("};", 1)[0]
    names = re.findall(r"\bO_(\w+)", body)
    assert names[-1] == "COUNT"
    assert [n.lower() for n in names[:-1]] == [
        n.lower() for n in nk._FOLDED]


def test_counters(counts):
    nk.LAUNCHES["nk_schur"] = 2
    nk.count_replay({"nk_schur": 3})
    assert nk.LAUNCHES["nk_schur"] == 5
    nk.CAPTURED["nk_schur"] = 1
    nk.PLAIN_CALLS["nk_schur"] = 1
    nk.reset_counts()
    assert nk.LAUNCHES == nk.CAPTURED == nk.PLAIN_CALLS == {"nk_schur": 0}


def test_bound_counts():
    assert nk.schur_flops(127, 1) == 28 * 2.0 * 127 ** 3 + 40.0 * 127 ** 2
    assert nk.schur_bytes(127) == 8.0 * 13 * 127 * 127
    assert nk.schur_folded_flops(127, 1) == (16 * 2.0 * 127 ** 3
                                             + 40.0 * 127 ** 2)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Schur kernel has no CPU mode")
    return torch.device("cuda")


_CARD = {}


def card_problem(n, lid):
    if (n, lid) not in _CARD:
        _CARD[(n, lid)] = problem(n, lid, "cuda")
    return _CARD[(n, lid)]


def cpu_ops(S):
    """The Schur operators of ``S`` on the CPU."""
    return nk.SchurOps(beta_sq=S.beta_sq, **{
        name: getattr(S, name).cpu() for name in (
            "Gxr", "IyTr", "Ixr", "GyTr", "Vxi", "Vyi", "Vx", "Vy", "Dxi",
            "DyTi")})


def card_system(n, lid, dt, cuda):
    prob, pre = card_problem(n, lid)
    inv_dt = torch.full((), 1.0 / dt, dtype=torch.float64, device=cuda)
    rhs, inv_hlam = schur_rhs(prob, pre, inv_dt)
    return pre.schur, rhs, inv_dt, inv_hlam


def residual(S, x, rhs, inv_dt, inv_hlam):
    """The true relative residual ||S x - rhs|| / ||rhs||."""
    return rel(host(nk.schur_apply(S, x, inv_dt, inv_hlam)), host(rhs))


@pytest.mark.gpu
class TestOnCard:
    # The yardstick of rounding is the plain loop on the CPU: it differs
    # from the card's plain loop only in the sum order of its products, as
    # the kernel does. Budgets 8 and 16: no solve stops early, and the
    # kernel is within 1e-12 of the card's plain loop, or within 10x the
    # CPU loop's distance from it where the iterations amplify the
    # rounding beyond 1e-12 (chip_smoke.py NK_B8_TOL, NK_SPREAD). Budget
    # 40: a solve that converges is held to the 1e-8 test on its true
    # residual (1.5e-8: the recursive residual drifts from it by rounding),
    # the kernel's and the plain loop's, not to the other solution (two
    # solutions within the test differ by up to cond(S) times it); a solve
    # that runs out its budget is held by test_unconverged_residuals
    # N=256 streams its operator bands: budgets 8 and 16
    @pytest.mark.parametrize("n,budget", [
        (n, b) for n in (12, 20, 96, 128) for b in (8, 16, 40)]
        + [(256, 8), (256, 16)])
    @pytest.mark.parametrize("dt", [0.05, 1.0, 3e3])
    @pytest.mark.parametrize("lid", sorted(LIDS))
    def test_kernel_matches_the_plain_loop(self, cuda, counts, lid, dt, n,
                                           budget):
        S, rhs, inv_dt, inv_hlam = card_system(n, lid, dt, cuda)
        x_k, k_k = nk.schur_kernel(S, rhs, inv_dt, inv_hlam, 1e-8, budget)
        x_p, k_p = nk.schur_plain(S, rhs, inv_dt, inv_hlam, 1e-8, budget)
        x_c, _ = nk.schur_plain(cpu_ops(S), rhs.cpu(), inv_dt.cpu(),
                                inv_hlam.cpu(), 1e-8, budget)
        torch.cuda.synchronize()
        assert nk.LAUNCHES["nk_schur"] == 1
        k_k, k_p = int(k_k), int(k_p)
        err, spread = rel(host(x_k), host(x_p)), rel(host(x_c), host(x_p))
        if budget < 40:
            assert k_k == k_p == budget
            assert err <= max(1e-12, 10 * spread), (err, spread)
            return
        assert abs(k_k - k_p) <= 2, (k_k, k_p)
        if k_k < budget:
            assert residual(S, x_k, rhs, inv_dt, inv_hlam) <= 1.5e-8
        if k_p < budget:
            assert k_k < budget, (k_k, k_p)
            assert residual(S, x_p, rhs, inv_dt, inv_hlam) <= 1.5e-8

    @pytest.mark.parametrize("n,resident", [(12, True), (20, True),
                                            (96, True), (128, True),
                                            (256, False)])
    def test_geometry(self, cuda, n, resident):
        """The operator bands stay in shared memory through N=128 (one
        item a block), and are streamed at N=256."""
        got, grid = nk.schur_geometry(n - 1)
        tiles = (-(-(n - 1) // 16)) ** 2
        assert got == resident
        assert grid == 2 * tiles if resident else 0 < grid <= 2 * tiles

    def test_unconverged_residuals(self, cuda):
        """Budget 40 on the systems the plain loop does not solve within
        it: the residual is a chaotic function of the rounding, so each
        system is solved with 8 seeded perturbations of its right-hand side
        (1e-15 relative) beside it. Over all those solves the geometric
        mean of the kernel's residual over the plain loop's on the same
        right-hand side is within 1.5, and on each system the kernel's
        median residual within 10x the plain loop's (chip_smoke.py
        NK_UNCONV_GM, NK_UNCONV_MED)."""
        logs, systems = [], 0
        for lid in sorted(LIDS):
            for n in (12, 20, 96, 128):
                for dt in (0.05, 1.0, 3e3):
                    S, rhs, inv_dt, inv_hlam = card_system(n, lid, dt, cuda)
                    if int(nk.schur_plain(S, rhs, inv_dt, inv_hlam, 1e-8,
                                          40)[1]) < 40:
                        continue
                    systems += 1
                    rk, rp = [], []
                    for seed in range(9):
                        g = torch.as_tensor(np.random.default_rng(
                            seed).standard_normal(tuple(rhs.shape)),
                            device=cuda)
                        b = rhs * (1.0 + 1e-15 * g) if seed else rhs
                        for out, solve in ((rk, nk.schur_kernel),
                                           (rp, nk.schur_plain)):
                            x, _ = solve(S, b, inv_dt, inv_hlam, 1e-8, 40)
                            out.append(residual(S, x, b, inv_dt, inv_hlam))
                    logs += [np.log(a / c) for a, c in zip(rk, rp)]
                    assert np.median(rk) <= 10 * np.median(rp), (
                        lid, n, dt, rk, rp)
        assert systems > 0
        assert np.exp(np.mean(logs)) <= 1.5, np.exp(np.mean(logs))

    def test_s_exit(self, cuda):
        S, inv_hlam, rhs = breakdown_system(*EXIT[1:], cuda)
        x, k = nk.schur_kernel(S, rhs, 0.0, inv_hlam, 1e-8, 10)
        x_p, k_p = nk.schur_plain(S, rhs, 0.0, inv_hlam, 1e-8, 10)
        assert int(k) == int(k_p) == EXIT[0]
        assert torch.equal(x, x_p) and torch.equal(x, rhs / 2)

    @pytest.mark.parametrize("code,A,b", BREAKDOWNS)
    def test_breakdown_codes(self, cuda, code, A, b):
        S, inv_hlam, rhs = breakdown_system(A, b, cuda)
        x, k = nk.schur_kernel(S, rhs, 0.0, inv_hlam, 1e-8, 10)
        x_p, k_p = nk.schur_plain(S, rhs, 0.0, inv_hlam, 1e-8, 10)
        assert int(k) == int(k_p) == code
        torch.testing.assert_close(x, x_p, rtol=0, atol=1e-15)

    def test_zero_rhs_and_zero_budget(self, cuda):
        prob, pre = card_problem(12, "smoothing")
        rhs, inv_hlam = schur_rhs(prob, pre, 20.0)
        x, k = nk.schur_kernel(pre.schur, torch.zeros_like(rhs), 20.0,
                               inv_hlam, 1e-8, 40)
        assert int(k) == 0 and not bool(x.any())
        x, k = nk.schur_kernel(pre.schur, rhs, 20.0, inv_hlam, 1e-8, 0)
        assert int(k) == 0 and not bool(x.any())

    @pytest.mark.parametrize("lid", sorted(LIDS))
    def test_graph_replays_the_eager_matvec(self, cuda, counts, lid):
        """Two PTC steps of one graph: each replay bit-equal to the eager
        matvec on the same buffers, one Schur launch a replay and no plain
        loop."""
        prob, pre = card_problem(48, lid)
        mv = TS._Matvec(prob, pre)
        assert mv.graphed
        rng = np.random.default_rng(2)
        for step, dt in enumerate((0.05, 3.0)):
            mv.set_step(point(prob, step), 1.0 / dt)
            for _ in range(2):
                y = rng.standard_normal(prob.n_tot)
                got = mv(y)
                want = host(mv._fused())
                np.testing.assert_array_equal(got, want)
        assert mv.launches == {"nk_schur": 1}
        # 4 replays, the warm-up and the 4 eager references
        assert nk.LAUNCHES["nk_schur"] == 9
        assert nk.PLAIN_CALLS["nk_schur"] == 0

    def test_fused_matvec_launches_the_kernel_not_the_plain_loop(
            self, cuda, counts, monkeypatch):
        def refuse(*a, **kw):
            raise AssertionError("the plain Schur loop ran on the card")

        monkeypatch.setattr(nk, "schur_bicgstab", refuse)
        monkeypatch.setattr(nk, "schur_plain", refuse)
        prob, pre = card_problem(20, "singular")
        x0 = host(prob.state_to_x(T.initial_state(prob.ops)))
        stats = {}
        TS.ptc_solve(prob, pre, x0, tol_rms=1e-8, max_steps=2,
                     gmres_vectors=20, dt0=0.05, dt_max=3e3, stats=stats)
        vectors = sum(stats["gmres_vectors"])
        steps = len(stats["gmres_vectors"])
        # a replay a vector, the warm-up, and P^{-1} once a step
        assert nk.LAUNCHES["nk_schur"] == vectors + 1 + steps
        assert nk.PLAIN_CALLS["nk_schur"] == 0
