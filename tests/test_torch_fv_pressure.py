"""The FV pressure launch of anap3_tpu_torch: ``csrc/fv_pressure.cu`` (one
cooperative launch for Rhie-Chow, the separable pressure solve with its
refinement, the gauge, the corrections, the metrics and control) and its
plain versions ``ops/fv_kernels.plain_pressure_stage`` and
``plain_pressure_launch`` (the stage, then ``plain_control``).

On the CPU (every run):

- ``plain_pressure_stage`` after ``plain_assemble`` and ``plain_bicgstab``
  is ``fv_iterate_plain`` bit for bit in float64, at 3x3, 12x16, 17x23 and
  33x20 (ny x nx), with n_refine 0 and 1;
- ``plain_pressure_launch`` after ``plain_momentum``, iterated, is
  ``chunk_body`` bit for bit (state, rows, flags and ref_norm) under both
  criteria, running through, converging mid-chunk and frozen by a done
  flag carried in from an earlier chunk; and, iterated from seeded float64
  states at 12x16 and 17x23, the JAX package's Pallas chunk runner
  (``make_pallas_fv_chunk_runner``) and lane runner
  (``anap3_tpu/ops/pallas_fv_lanes.py:make_fv_lane_runner``, two lanes) in
  interpret mode, rebound to float64 as below: states and rows within
  1e-10 relative (the FV bound; measured ~1e-14), NaN rows and flags
  equal, with a tolerance met mid-chunk;
- the same stage against the JAX package's Pallas FV step
  (``anap3_tpu/ops/pallas_fv.py:make_pallas_fv_step``) in interpret mode,
  as ``tests/test_torch_fv_kernels.py::TestAgainstPallas`` runs it, but in
  float64: the step names float32 for its statics, its products and its
  padded state, so the test rebinds the module's ``np.float32`` and
  ``jnp.float32`` to float64 (and ``_pad_state``'s default) for the call
  and restores them after it. State and metrics within 1e-12 relative (both
  sides sum in different orders: measured <= 1e-15), with n_refine 0 and 1
  and the perturbed-eigenvalue refinement case, where the refinement moves
  the state by far more than the bound;
- the pressure launch's grid rule ``pressure_grid`` for every N = 3-512 and
  B = 1-8: every (tile, lane) item taken once, at most ``MAX_ITEMS`` a
  block, ValueError above that; the constants the rule shares with the
  CUDA source.

On a CUDA card (marker ``gpu``; without a card these skip, saying so): the
kernel against ``plain_pressure_stage`` on the kernel's own momentum
solution, in float32 (<= 1e-4 relative) and float64 (<= 1e-10), with
n_refine 0 and 1, at the shapes above plus 128x128 and 257x130; the
launch's control against ``plain_control`` on the kernel's own stage
(rows, flags, conv_iter and ref_norm under both criteria, a NaN state
included); each lane of a B = 3 and B = 8 launch bit-equal to a one-lane
launch; the co-resident blocks of 4 (float32) and 3 (float64) blocks an
SM; and a launch the card cannot take refused with an error.
Run them there with
``python -m pytest tests/test_torch_fv_pressure.py -m gpu --noconftest``.
"""

import dataclasses
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import fv as TF
from anap3_tpu_torch.models import runner as TR
from anap3_tpu_torch.models.params import FVParameters
from anap3_tpu_torch.ops import fv_kernels as fvk

torch.set_num_threads(1)

K = 16
PALLAS_RTOL = 1e-12
F32_TOL = 1e-4
F64_TOL = 1e-10
SHAPES = [(3, 3), (12, 16), (17, 23), (33, 20)]  # (ny, nx)
CSRC = Path(fvk.__file__).resolve().parent.parent / "csrc"


def base(**over):
    """The numerics of conf/solver/fv.yaml at a test size, float64."""
    kw = dict(name="fv", Re=100.0, nx=16, ny=16, convection_scheme="TVD",
              limiter="MUSCL", alpha_uv=0.4, alpha_p=0.2,
              linear_solver_tol=1e-9, tolerance=1e-4, max_iterations=3000,
              corner_treatment="none", dtype="float64", chunk_size=200)
    kw.update(over)
    return kw


def seeded(ny, nx, seed):
    """(u, v, p, mx, my) as numpy float64, 0.05 standard normal."""
    rng = np.random.default_rng(seed)
    return [0.05 * rng.standard_normal(s) for s in ((ny, nx),) * 3
            + ((ny, nx - 1), (ny - 1, nx))]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def rel_t(a, b):
    return rel(a.detach().cpu().double().numpy(),
               b.detach().cpu().double().numpy())


def perturbed(inv_lam, size=0.5, seed=0):
    """Eigenvalue inverses of the pressure solve scaled by 1 + size * u, u
    uniform in [-1, 1] (the zero mode stays zero)."""
    rng = np.random.default_rng(seed)
    return inv_lam * (1 + size * rng.uniform(-1, 1, inv_lam.shape))


def stage(S, state, K=K):
    """The plain iteration as the kernels run it: assembly, the BiCGSTAB
    solve, then ``plain_pressure_stage``. Returns the new state (unpadded)
    and the metrics."""
    u, v, p, mx, my = fvk.pad_state(state)
    c = fvk.plain_assemble(S, u, v, p, mx, my)
    us, vs = fvk.plain_bicgstab(c, u, v, K)
    new, metrics = fvk.plain_pressure_stage(S, c, us, vs, p)
    return fvk.unpad_state(*new), metrics


class TestPlainStage:
    @pytest.mark.parametrize("ny,nx", SHAPES)
    @pytest.mark.parametrize("n_refine", [0, 1])
    def test_stage_composes_the_iteration(self, ny, nx, n_refine):
        p = FVParameters(device="cpu", **base(nx=nx, ny=ny))
        ops = dataclasses.replace(TF.build_fv_ops(p)[0], n_refine=n_refine)
        S = fvk.statics(p, ops)
        assert S["n_refine"] == n_refine
        st = TF.fv_state_from_numpy(seeded(ny, nx, ny * nx), "cpu",
                                    torch.float64)
        new, metrics = stage(S, st)
        ref, ref_metrics = fvk.fv_iterate_plain(S, st, K)
        assert all(torch.equal(a, b) for a, b in zip(new, ref))
        assert torch.equal(metrics, ref_metrics)
        assert all(a.shape == b.shape for a, b in zip(new, st))


@pytest.fixture
def pallas64(monkeypatch):
    """``step(jp, jops, arrays) -> (state, metrics)`` of the JAX package's
    Pallas FV step in interpret mode, in float64 (the module's float32
    names rebound for the test; the JAX import stays in the fixture because
    the card's machine has no JAX)."""
    import jax.numpy as jnp
    from anap3_tpu.models import fv as JF
    from anap3_tpu.ops import pallas_fv as PF

    class Float64Names:
        def __init__(self, module):
            self._module = module

        def __getattr__(self, name):
            return getattr(self._module,
                           "float64" if name == "float32" else name)

    monkeypatch.setattr(PF, "np", Float64Names(np))
    monkeypatch.setattr(PF, "jnp", Float64Names(jnp))
    monkeypatch.setattr(PF._pad_state, "__defaults__", (jnp.float64,))

    def step(jp, jops, arrs):
        run = PF.make_pallas_fv_step(jp, jops, bicgstab_iters=K,
                                     interpret=True)
        state, metrics = run(JF.FVState(*(jnp.asarray(a) for a in arrs)))
        assert state.u.dtype == jnp.float64
        return state, metrics

    return step


def jax_ops(ny, nx, n_refine, perturb):
    import jax.numpy as jnp
    from anap3_tpu.models import fv as JF
    from anap3_tpu.models.params import FVParameters as JaxParameters

    jp = JaxParameters(**base(nx=nx, ny=ny))
    jops, _ = JF.build_fv_ops(jp)
    if perturb:
        P = jops.poisson
        inv = perturbed(np.asarray(P.inv_lam))
        jops = jops._replace(poisson=dataclasses.replace(
            P, inv_lam=jnp.asarray(inv, P.inv_lam.dtype)))
    return jp, jops._replace(n_refine=n_refine)


class TestAgainstPallas:
    @pytest.mark.parametrize("ny,nx", SHAPES)
    @pytest.mark.parametrize("n_refine", [0, 1])
    def test_stage_matches_pallas_step_in_float64(self, pallas64, ny, nx,
                                                  n_refine):
        jp, jops = jax_ops(ny, nx, n_refine, perturb=False)
        tops = TF.fv_ops_from_jax(jops, "cpu", torch.float64)
        assert tops.n_refine == n_refine
        arrs = seeded(ny, nx, ny * nx)
        js, jm = pallas64(jp, jops, arrs)
        new, metrics = stage(fvk.statics(jp, tops),
                             TF.fv_state_from_numpy(arrs, "cpu",
                                                    torch.float64))
        for a, b, name in zip(new, js, TF.FVState._fields):
            assert tuple(a.shape) == tuple(b.shape), name
            assert rel(a.numpy(), b) <= PALLAS_RTOL, name
        for i, k in enumerate(fvk.METRIC_NAMES):
            assert rel(metrics[i].numpy(), jm[k]) <= PALLAS_RTOL, k

    def test_refinement_on_a_perturbed_solve_matches_pallas(self, pallas64):
        """One refinement step after a pressure solve whose eigenvalue
        inverses are scaled by 1 + 0.5 u: the refinement moves the state by
        far more than the bound, so a wrong residual or a wrong
        accumulating product fails it."""
        ny, nx = 12, 16
        jp, jops = jax_ops(ny, nx, 1, perturb=True)
        tops = TF.fv_ops_from_jax(jops, "cpu", torch.float64)
        arrs = seeded(ny, nx, 7)
        js, jm = pallas64(jp, jops, arrs)
        S = fvk.statics(jp, tops)
        st = TF.fv_state_from_numpy(arrs, "cpu", torch.float64)
        new, metrics = stage(S, st)
        unrefined, _ = stage(dict(S, n_refine=0), st)
        for a, b, c, name in zip(new, js, unrefined, TF.FVState._fields):
            assert rel(a.numpy(), b) <= PALLAS_RTOL, name
            assert rel(c.numpy(), b) > 1e6 * PALLAS_RTOL, name
        for i, k in enumerate(fvk.METRIC_NAMES):
            assert rel(metrics[i].numpy(), jm[k]) <= PALLAS_RTOL, k


def launches(S, state, start_iter, ref_norm, chunk, tol, warmup,
             use_residual=False, carry=None):
    """``chunk`` iterations as the two launches run them: ``plain_momentum``,
    then ``plain_pressure_launch`` with control. Returns what
    ``chunk_body`` returns."""
    cur = fvk.pad_state(state)
    if carry is None:
        carry = (torch.tensor(False), torch.tensor(-1, dtype=torch.int32),
                 torch.tensor(False))
    ref_norm = torch.as_tensor(ref_norm, dtype=state.u.dtype)
    rows = []
    for i in range(chunk):
        c, us, vs = fvk.plain_momentum(S, *cur, K)
        cur, row, carry, ref_norm = fvk.plain_pressure_launch(
            S, c, us, vs, cur, (start_iter + i, carry, ref_norm, tol, warmup,
                                use_residual))
        rows.append(row)
    return (fvk.unpad_state(*cur),) + tuple(carry) + (torch.stack(rows),
                                                       ref_norm)


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0, a), torch.where(nan, 0, b))


def crossing(rel, warmup):
    """A tolerance that rel_iter (one per row) meets first at row i, with a
    gap of 1% or more from every earlier row after the warmup (so that
    rounding cannot move the crossing), and that i."""
    rel = np.asarray(rel, np.float64)
    for i in range(warmup + 1, len(rel)):
        above = float(np.min(rel[warmup:i]))
        if above > 1.01 * rel[i]:
            return float(np.sqrt(above * rel[i])), i
    raise AssertionError(f"no crossing in {rel}")


class TestPlainLaunch:
    """The pressure launch's plain version with control, iterated after the
    momentum launch's, is the plain chunk."""

    def setup(self, ny=12, nx=16):
        p = FVParameters(device="cpu", **base(nx=nx, ny=ny))
        ops = TF.build_fv_ops(p)[0]
        S = fvk.statics(p, ops)
        st = TF.fv_state_from_numpy(seeded(ny, nx, 3), "cpu", torch.float64)
        return S, st

    @pytest.mark.parametrize("use_residual", [False, True])
    @pytest.mark.parametrize("case", ["through", "mid-chunk", "done"])
    def test_iterated_launch_is_the_chunk(self, use_residual, case):
        S, st = self.setup()
        chunk, warmup, start = 10, 2, 0
        carry, tol = None, 1e-30
        probe = launches(S, st, start, np.inf, chunk, tol, warmup,
                         use_residual)
        col = 3 if use_residual else 0  # the continuity norm, rel_iter
        crit = probe[4][:, col].numpy()
        if use_residual:
            crit = crit / crit[warmup]
        if case == "mid-chunk":
            tol, at = crossing(crit, warmup)
        elif case == "done":  # converged at iteration 5 of an earlier chunk
            start = 30
            carry = (torch.tensor(True), torch.tensor(5, dtype=torch.int32),
                     torch.tensor(True))
        ref = 0.25
        a = launches(S, st, start, ref, chunk, tol, warmup, use_residual,
                     carry)
        b = fvk.chunk_body(S, st, start, ref, chunk, tol, warmup, K,
                           use_residual, carry)
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
        assert same_bits(a[4], b[4]) and tuple(a[4].shape) == (chunk, 7)
        assert [int(a[i]) for i in (1, 2, 3)] == [int(b[i]) for i in (1, 2, 3)]
        assert same_bits(a[5], b[5])
        rows = a[4].numpy()
        if case == "through":
            assert [int(a[i]) for i in (1, 2, 3)] == [0, -1, 0]
            assert np.isfinite(rows).all()
        elif case == "mid-chunk":
            assert [int(a[i]) for i in (1, 2, 3)] == [1, at + 1, 1]
            assert np.isfinite(rows[:at + 1]).all()
            assert np.isnan(rows[at + 1:]).all()
        else:  # frozen: the start state, NaN rows, the flags kept
            assert [int(a[i]) for i in (1, 2, 3)] == [1, 5, 1]
            assert all(torch.equal(x, y) for x, y in zip(a[0], st))
            assert np.isnan(rows).all()
        if use_residual and case != "done":
            # pinned at the warmup iteration's continuity norm
            assert float(a[5]) == rows[warmup, 3]
        else:
            assert float(a[5]) == ref


@pytest.fixture
def pallas64_runners(monkeypatch):
    """The JAX package's Pallas FV chunk runner and lane runner in
    interpret mode, in float64 (both modules' float32 names rebound for the
    test, as ``pallas64`` does for the step)."""
    import jax.numpy as jnp
    from anap3_tpu.ops import pallas_fv as PF
    from anap3_tpu.ops import pallas_fv_lanes as PFL

    class Float64Names:
        def __init__(self, module):
            self._module = module

        def __getattr__(self, name):
            return getattr(self._module,
                           "float64" if name == "float32" else name)

    for mod in (PF, PFL):
        monkeypatch.setattr(mod, "np", Float64Names(np))
        monkeypatch.setattr(mod, "jnp", Float64Names(jnp))
    monkeypatch.setattr(PF._pad_state, "__defaults__", (jnp.float64,))
    return SimpleNamespace(jnp=jnp, chunk=PF.make_pallas_fv_chunk_runner,
                           lanes=PFL.make_fv_lane_runner)


# (Re, alpha_uv, alpha_p) of the lanes held against the JAX lane runner
JAX_LANES = [(100.0, 0.4, 0.2), (400.0, 0.6, 0.3)]


class TestLaunchAgainstPallas:
    CHUNK, WARMUP = 8, 2

    def lane(self, ny, nx, Re, alpha_uv, alpha_p, seed):
        """(JAX params, JAX ops, port statics, numpy state)."""
        from anap3_tpu.models import fv as JF
        from anap3_tpu.models.params import FVParameters as JaxParameters

        jp = JaxParameters(**base(nx=nx, ny=ny, Re=Re, alpha_uv=alpha_uv,
                                  alpha_p=alpha_p))
        jops = JF.build_fv_ops(jp)[0]
        tops = TF.fv_ops_from_jax(jops, "cpu", torch.float64)
        return jp, jops, fvk.statics(jp, tops), seeded(ny, nx, seed)

    def plain(self, S, arrs, tol):
        return launches(S, TF.fv_state_from_numpy(arrs, "cpu",
                                                  torch.float64),
                        0, np.inf, self.CHUNK, tol, self.WARMUP)

    def check_lane(self, out, state, done, conv_iter, converged, rows):
        assert (int(out[1]), int(out[2]), int(out[3])) == (
            int(done), int(conv_iter), int(converged))
        for a, b, name in zip(out[0], state, TF.FVState._fields):
            assert tuple(a.shape) == tuple(np.shape(b)), name
            assert rel(a.numpy(), b) <= F64_TOL, name
        r, jr = out[4].numpy(), np.asarray(rows)
        np.testing.assert_array_equal(np.isnan(r), np.isnan(jr))
        for c in range(7):
            ok = ~np.isnan(jr[:, c])
            assert rel(r[ok, c], jr[ok, c]) <= F64_TOL, c

    @pytest.mark.parametrize("ny,nx", [(12, 16), (17, 23)])
    def test_launch_matches_pallas_chunk_in_float64(self, pallas64_runners,
                                                    ny, nx):
        from anap3_tpu.models import fv as JF

        jnp = pallas64_runners.jnp
        jp, jops, S, arrs = self.lane(ny, nx, *JAX_LANES[0], seed=ny * nx)
        probe = self.plain(S, arrs, 1e-30)
        tol, at = crossing(probe[4][:, 0].numpy(), self.WARMUP)
        out = self.plain(S, arrs, tol)
        assert (int(out[1]), int(out[2])) == (1, at + 1)
        run = pallas64_runners.chunk(jp, jops, self.CHUNK, tol, self.WARMUP,
                                     bicgstab_iters=K, interpret=True)
        js, jd, jci, jcv, jrows, _ = run(
            JF.FVState(*(jnp.asarray(a) for a in arrs)), jnp.int32(0),
            jnp.asarray(np.inf))
        assert js.u.dtype == jnp.float64 and jrows.dtype == jnp.float64
        self.check_lane(out, js, jd, jci, jcv, jrows)

    @pytest.mark.parametrize("ny,nx", [(12, 16), (17, 23)])
    def test_launch_matches_pallas_lanes_in_float64(self, pallas64_runners,
                                                    ny, nx):
        from anap3_tpu.models import fv as JF

        jnp = pallas64_runners.jnp
        lanes = [self.lane(ny, nx, *lane, seed=ny * nx + b)
                 for b, lane in enumerate(JAX_LANES)]
        probe = self.plain(lanes[0][2], lanes[0][3], 1e-30)
        tol, at = crossing(probe[4][:, 0].numpy(), self.WARMUP)
        outs = [self.plain(S, arrs, tol) for _, _, S, arrs in lanes]
        assert (int(outs[0][1]), int(outs[0][2])) == (1, at + 1)
        run = pallas64_runners.lanes([q[0] for q in lanes],
                                     [q[1] for q in lanes], self.CHUNK, tol,
                                     self.WARMUP, bicgstab_iters=K,
                                     interpret=True)
        js, jd, jci, jcv, jrows = run(JF.FVState(*(
            jnp.asarray(np.stack([q[3][i] for q in lanes]))
            for i in range(5))), 0)
        assert jrows.dtype == jnp.float64
        for b, out in enumerate(outs):
            self.check_lane(out, [np.asarray(t)[b] for t in js], jd[b],
                            jci[b], jcv[b], np.asarray(jrows)[:, b])


# co-resident blocks: 132 SMs x 2, 3, 4 blocks, and a small card that makes
# the larger grids refuse
CORESIDENT = (264, 396, 528, 16)


def block_items(ny, nx, lanes, blocks, b):
    """The (lane, tile) items block b of a blocks-block pressure launch
    takes, in its order (csrc/fv_pressure.cu:pressure_kernel's `each`)."""
    nb = fvk._tiles(ny) * fvk._tiles(nx)
    return [(it // nb, it % nb) for it in range(b, nb * lanes, blocks)]


class TestGrid:
    @pytest.mark.parametrize("lanes", range(1, 9))
    def test_rule_for_every_n(self, lanes):
        covered = set()  # (tiles, co-resident) whose items were walked
        for n in range(3, 513):
            nb = fvk._tiles(n) ** 2
            items = nb * lanes
            for most in CORESIDENT:
                if -(-items // min(items, most)) > fvk.MAX_ITEMS:
                    with pytest.raises(ValueError, match="more than"):
                        fvk.pressure_grid(n, n, lanes, most)
                    continue
                blocks = fvk.pressure_grid(n, n, lanes, most)
                assert blocks == min(items, most)
                if (nb, most) in covered:
                    continue
                covered.add((nb, most))
                taken = [block_items(n, n, lanes, blocks, b)
                         for b in range(blocks)]
                assert max(len(t) for t in taken) <= fvk.MAX_ITEMS
                assert min(len(t) for t in taken) >= 1
                flat = [it for t in taken for it in t]
                assert len(flat) == items
                assert set(flat) == {(b, t) for b in range(lanes)
                                     for t in range(nb)}

    def test_rectangular_grids_and_refusals(self):
        assert fvk.pressure_grid(257, 130, 8, 396) == 396  # 1224 items
        assert block_items(257, 130, 1, 153, 152) == [(0, 152)]
        assert block_items(12, 16, 3, 2, 1) == [(1, 0)]
        with pytest.raises(ValueError, match="more than 64 a block"):
            fvk.pressure_grid(512, 512, 2, 16)
        for bad in ((0, 16, 1, 396), (16, 16, 0, 396), (16, 16, 1, 0)):
            with pytest.raises(ValueError, match="no pressure launch"):
                fvk.pressure_grid(*bad)


class TestSource:
    def test_constants_match_the_cuda_source(self):
        src = (CSRC / "fv_pressure.cu").read_text()
        consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
        assert int(consts["MAX_ITEMS"]) == fvk.MAX_ITEMS
        assert int(consts["KS"]) % int(consts["KPAD"]) == 0
        f32, f64 = re.search(r"constexpr int MIN_BLOCKS = sizeof\(T\) == 4 "
                             r"\? (\d+) : (\d+);", src).groups()
        assert int(f32) >= 3 and int(f64) >= 3
        assert "__launch_bounds__(NT, MIN_BLOCKS<T>)" in src
        assert "cudaLaunchAttributeCooperative" in src
        assert "cp.async" in src

    def test_launch_counts_follow_the_kernel_names(self):
        common = (CSRC / "fv_common.cuh").read_text()
        enum = re.search(r"enum Count \{([^}]*)\}", common).group(1)
        names = [e.strip() for e in enum.split(",")]
        assert names == ["C_BICG", "C_PRESSURE", "C_COUNT"]
        assert fvk.KERNELS == ("fv_bicgstab", "fv_pressure")
        for gone in ("fv_dense.cu", "fv_stencil.cu", "fv_control.cu"):
            assert not (CSRC / gone).exists(), gone
        # the iteration's launches, each counted once, and nothing else
        # launched by the host loop
        host = (CSRC / "fv_host.cu").read_text()
        body = host[host.index("int iterate("):host.index("int step_run(")]
        assert re.findall(r"launch_(\w+)<T>", body) == ["bicg", "pressure"]
        assert re.findall(r"counts\[(\w+)\]", host) == ["C_BICG",
                                                          "C_PRESSURE"]


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pressure kernel has no CPU mode")
    return torch.device("cuda")


def cuda_setup(ny, nx, dtype, n_refine=None, Re=100.0):
    p = FVParameters(**base(nx=nx, ny=ny, Re=Re, device="cuda",
                            dtype="float64" if dtype == torch.float64
                            else "float32"))
    ops = TF.build_fv_ops(p)[0]
    if n_refine is not None:
        ops = dataclasses.replace(ops, n_refine=n_refine)
    return p, ops


def tol_of(dtype):
    return F64_TOL if dtype == torch.float64 else F32_TOL


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("ny,nx", SHAPES + [(128, 128), (257, 130)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("n_refine", [0, 1])
    def test_kernel_matches_plain_stage(self, cuda, ny, nx, dtype,
                                        n_refine):
        """One step from a seeded state; the plain stage starts from the
        kernel's own momentum solution u*, v* and the plain assembly, so
        the bound holds the pressure stage: rhs_p, p' after the gauge, the
        new state and the six metrics that control reduces from the
        stage's partials."""
        p, ops = cuda_setup(ny, nx, dtype, n_refine)
        S = fvk.statics(p, ops)
        st = TF.fv_state_from_numpy(seeded(ny, nx, ny * nx), "cuda", dtype)
        ws = fvk.bench_workspace(S, ops, st, K)
        torch.cuda.synchronize()
        u, v, pr, mx, my = fvk.pad_state(st)
        c = fvk.plain_assemble(S, u, v, pr, mx, my)
        us, vs = ws["x"][0], ws["x"][1]
        new, metrics = fvk.plain_pressure_stage(S, c, us, vs, pr)
        rhs = fvk.plain_rhie_chow(S, c, us, vs, pr)[3]
        pp = fvk.plain_pressure(S, rhs)
        tol = tol_of(dtype)
        assert rel_t(ws["rhsp"], rhs) <= tol
        assert rel_t(ws["pp"] - ws["pp"][0, 0], pp) <= tol
        for a, b, name in zip((ws[k] for k in TF.FVState._fields),
                              fvk.unpad_state(*new), TF.FVState._fields):
            assert rel_t(a, b) <= tol, name
        for i, k in enumerate(fvk.METRIC_NAMES):
            assert rel_t(ws["metrics"][i], metrics[i]) <= tol, k

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("use_residual", [False, True])
    @pytest.mark.parametrize("tol", [1e30, 1e-30])
    def test_control_matches_plain_control(self, cuda, dtype, use_residual,
                                           tol):
        """One iteration of three lanes at the warmup iteration (the
        residual criterion pins its normalization there): lane 0 fresh,
        lane 1 done in an earlier chunk, lane 2 from a state with a NaN.
        The launch's rows, flags, conv_iter, ref_norm and state against
        ``plain_pressure_launch`` on the kernel's own momentum solution:
        with tol 1e30 lane 0 converges, with 1e-30 it runs on; lane 1
        keeps its flags, NaN rows and state; lane 2 diverges."""
        from anap3_tpu_torch.ops import fv_lane_kernels as fvl
        from anap3_tpu_torch.parallel.sweep import stack_states

        ny, nx, warmup = 12, 16, 10
        setups = [cuda_setup(ny, nx, dtype, Re=re)
                  for re in (100.0, 400.0, 1000.0)]
        states = [TF.fv_state_from_numpy(seeded(ny, nx, b), "cuda", dtype)
                  for b in range(3)]
        u = states[2].u.clone()
        u[4, 6] = float("nan")
        states[2] = TF.FVState(u, *states[2][1:])
        S_list = [fvk.statics(p, o) for p, o in setups]
        ops = setups[0][1]
        carry = TR.fresh_carry(3, dtype, ops.device)
        carry.flags[1] = torch.tensor([1, 5, 1], dtype=torch.int32)
        carry.ref_norm[:] = 0.25
        ws = fvl.run_lanes(S_list, ops, fvl.lane_statics(S_list),
                           stack_states(states), warmup, carry, 1, tol,
                           warmup, K, use_residual)
        torch.cuda.synchronize()
        tol_err = tol_of(dtype)
        for b, (S, st) in enumerate(zip(S_list, states)):
            f = carry.flags[b]
            cur = fvk.pad_state(st)
            c = fvk.plain_assemble(S, *cur)
            state, row, flags, ref = fvk.plain_pressure_launch(
                S, c, ws["x"][b, 0], ws["x"][b, 1], cur,
                (warmup, (f[0] > 0, f[1], f[2] > 0), carry.ref_norm[b], tol,
                 warmup, use_residual))
            got = [int(x) for x in ws["flags"][b]]
            assert got == [int(x) for x in flags], (b, got)
            lane0 = [1, warmup + 1, 1] if tol > 1 else [0, -1, 0]
            assert got == (lane0, [1, 5, 1], [1, warmup + 1, 0])[b], b
            r = ws["rows"][0, b]
            assert torch.equal(torch.isnan(r), torch.isnan(row)), b
            assert torch.isnan(row).all() == (b > 0), b
            if b == 0:
                assert rel_t(r, row) <= tol_err
            # pinned to the row's continuity norm (NaN on lanes 1 and 2)
            # under the residual criterion, kept under rel_iter
            rn = ws["ref_norm"][b]
            if use_residual:
                assert bool(torch.isnan(rn)) == bool(torch.isnan(ref)) == (
                    b > 0), b
                if b == 0:
                    assert rel_t(rn, ref) <= tol_err
            else:
                assert float(rn) == float(ref) == 0.25
            for a, x, name in zip((ws[k][b] for k in TF.FVState._fields),
                                  fvk.unpad_state(*state), TF.FVState._fields):
                if b == 1:  # frozen
                    assert torch.equal(a, x), name
                elif b == 0:
                    assert rel_t(a, x) <= tol_err, name
                else:
                    assert torch.isnan(a).any(), name

    @pytest.mark.parametrize("ny,nx", [(128, 128), (257, 130)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("lanes", [3, 8])
    def test_each_lane_is_its_one_lane_launch(self, cuda, ny, nx, dtype,
                                              lanes):
        """One lane-chunk iteration of B lanes (Re 100, 400, 1000, ...)
        against each lane alone: rhs_p, p' and the new state bit for bit
        against one step, and the row, flags and state against a
        one-iteration chunk (a block takes several items where B x tiles
        exceeds the co-resident blocks)."""
        from anap3_tpu_torch.ops import fv_lane_kernels as fvl
        from anap3_tpu_torch.parallel.sweep import stack_states

        setups = [cuda_setup(ny, nx, dtype, Re=(100.0, 400.0, 1000.0)[b % 3])
                  for b in range(lanes)]
        states = [TF.fv_state_from_numpy(seeded(ny, nx, b), "cuda", dtype)
                  for b in range(lanes)]
        S_list = [fvk.statics(p, o) for p, o in setups]
        ops = setups[0][1]
        ws = fvl.run_lanes(S_list, ops, fvl.lane_statics(S_list),
                           stack_states(states), 0,
                           TR.fresh_carry(lanes, ops.dtype, ops.device), 1,
                           1e-30, 10, K, False)
        for b, ((p, o), st) in enumerate(zip(setups, states)):
            one = fvk.bench_workspace(S_list[b], o, st, K)
            for name in ("rhsp", "pp") + TF.FVState._fields:
                assert torch.equal(ws[name][b], one[name]), (b, name)
            out = fvk.make_fv_chunk_runner(p, o, 1, 1e-30, 10, K)(
                st, 0, np.inf)
            assert same_bits(ws["rows"][:, b], out[4]), b
            assert [int(x) for x in ws["flags"][b]] == [
                int(out[i]) for i in (1, 2, 3)]
            for name, t in zip(TF.FVState._fields, out[0]):
                assert torch.equal(ws[name][b], t), (b, name)

    def test_coresident_blocks(self, cuda):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        # __launch_bounds__(NT, 4) in float32, (NT, 3) in float64
        assert fvk.coresident(torch.float32) >= 4 * sms
        assert fvk.coresident(torch.float64) >= 3 * sms

    def test_a_launch_the_card_cannot_take_raises(self, cuda):
        p, ops = cuda_setup(12, 16, torch.float32)
        S = fvk.statics(p, ops)
        ws = fvk.bench_workspace(S, ops, TF.initial_state(ops), K)
        most = fvk.coresident(ops.dtype)
        lanes = fvk.MAX_ITEMS * most // fvk._tiles(512) ** 2 + 1
        with pytest.raises(ValueError, match="more than"):
            fvk.pressure_grid(512, 512, lanes, most)
        fvk.pressure_grid(512, 512, lanes - 1, most)
        # the launcher refuses before it reads a buffer: a 512x512 grid of
        # that many lanes on this small workspace raises, and runs nothing
        fvk.reset_counts()
        big = SimpleNamespace(dtype=ops.dtype, ny=512, nx=512)
        for name in fvk.KERNELS:
            for folded in (True, False):
                with pytest.raises(RuntimeError, match="fv_bench_run"):
                    fvk.bench_kernel(S, big, ws, name, K, 1, lanes=lanes,
                                     folded=folded)
        assert not any(fvk.LAUNCHES.values())
