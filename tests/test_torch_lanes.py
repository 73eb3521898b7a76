"""The sweep-lane kernel wrappers of anap3_tpu_torch (ops/sg_lane_kernels.py,
ops/fv_lane_kernels.py).

On the CPU (every run): the wrappers' plain versions (``lanes_plain``)
against the Pallas TPU lane kernels themselves, run as their own tests run
them (``interpret=True``, float32, x6 = full-f32 products):
``make_aligned_lane_runner`` at N=32 (smoothed and singular lanes),
``make_lane_chunk_runner`` at N=20 and ``make_fv_lane_runner`` at 16x16.
Tolerance 1e-4 relative per field or column (both sides float32, summed
in different orders; FV states 1e-5 absolute, as tests/test_torch_fv_
kernels.py). The aligned kernel samples its quadratures and holds its
residual norms between samples; those columns are compared on sampled rows.
Then the wrappers' contract: lane b of ``lanes_plain`` is the one-lane
chunk on lane b's data, bit for bit; the carried flags freeze a done lane;
dispatch and checks.

On a CUDA card (marker ``gpu``): the lane kernels against ``lanes_plain``
on the same device tensors (<= 1e-11 SG / 1e-10 FV relative in float64,
<= 1e-4 in float32, flags equal), every lane against a one-lane kernel
chunk of its own bit for bit, a lane driven to NaN isolated from the
others, and batches that mix corner modes or take the FV residual criterion
run through the lane kernels with no plain call. Run them there with
``python -m pytest tests/test_torch_lanes.py -m gpu --noconftest``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import fv as TFV
from anap3_tpu_torch.models import runner as TR
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import FVParameters, SpectralParameters
from anap3_tpu_torch.ops import fv_kernels as fvk
from anap3_tpu_torch.ops import fv_lane_kernels as fvl
from anap3_tpu_torch.ops import sg_kernels as sgk
from anap3_tpu_torch.ops import sg_lane_kernels as sgl
from anap3_tpu_torch.models.spectral import SGSolver
from anap3_tpu_torch.parallel import batched as TB
from anap3_tpu_torch.parallel import sweep as TS
from anap3_tpu_torch.parallel.sweep import stack_states

torch.set_num_threads(1)

F32_TOL = 1e-4
F32_ABS = 1e-5
SG_F64_TOL = 1e-11
FV_F64_TOL = 1e-10


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here: the card's machine has no JAX."""
    import jax
    import jax.numpy as jnp
    from anap3_tpu.models import fv as JF
    from anap3_tpu.models import spectral_sg as J
    from anap3_tpu.models.params import FVParameters as JFP
    from anap3_tpu.models.params import SpectralParameters as JSP
    from anap3_tpu.ops.pallas_aligned import aligned_supported
    from anap3_tpu.ops.pallas_fv_lanes import make_fv_lane_runner
    from anap3_tpu.ops.pallas_lanes import make_lane_chunk_runner
    from anap3_tpu.ops.pallas_lanes_aligned import make_aligned_lane_runner

    def sg_lanes(n, lanes, corner="smoothing"):
        """(JAX ops, port f32 ops, JAX states, port states) for lanes of
        (Re, corner_smoothing[, CFL])."""
        jops = [J.build_spectral_ops(JSP(
            Re=lane[0], nx=n, ny=n, dtype="float32", basis_type="chebyshev",
            CFL=lane[2] if len(lane) > 2 else 1.5, corner_treatment=corner,
            corner_smoothing=lane[1]), dtype=jnp.float32)[0]
            for lane in lanes]
        tops = [T.ops_from_jax(o, "cpu", torch.float32) for o in jops]
        jst = jax.tree.map(lambda *a: jnp.stack(a),
                           *[J.initial_state(o) for o in jops])
        tst = T.SpectralState(*(torch.as_tensor(np.array(a))
                                for a in jst))
        return jops, tops, jst, tst

    def fv_lanes(ny, nx, lanes):
        """Lanes of (Re, alpha_uv, alpha_p) at conf/solver/fv.yaml's
        numerics: (JAX params, JAX ops, port ops, JAX states, port
        states)."""
        jps = [JFP(name="fv", Re=Re, nx=nx, ny=ny, convection_scheme="TVD",
                   limiter="MUSCL", alpha_uv=a, alpha_p=ap,
                   linear_solver_tol=1e-9, corner_treatment="none",
                   dtype="float32") for Re, a, ap in lanes]
        jops = [JF.build_fv_ops(p)[0] for p in jps]
        tops = [TFV.fv_ops_from_jax(o, "cpu", torch.float32) for o in jops]
        rest = [np.zeros((len(lanes),) + s, np.float32) for s in (
            (ny, nx), (ny, nx), (ny, nx), (ny, nx - 1), (ny - 1, nx))]
        jst = JF.FVState(*(jnp.asarray(a) for a in rest))
        tst = TFV.FVState(*(torch.as_tensor(a) for a in rest))
        return jps, jops, tops, jst, tst

    return SimpleNamespace(jnp=jnp, sg_lanes=sg_lanes, fv_lanes=fv_lanes,
                           aligned=make_aligned_lane_runner,
                           tiled=make_lane_chunk_runner,
                           fv=make_fv_lane_runner,
                           aligned_supported=aligned_supported)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def rel_cols(a, b):
    """Largest per-column error relative to the column's max, over rows
    and lanes: a and b are (rows, B, K)."""
    a = np.asarray(a, np.float64).reshape(-1, np.shape(a)[-1])
    b = np.asarray(b, np.float64).reshape(-1, np.shape(b)[-1])
    return max(float(np.max(np.abs(a[:, c] - b[:, c])))
               / max(float(np.max(np.abs(b[:, c]))), 1e-30)
               for c in range(b.shape[1]))


def same_bits(a, b) -> bool:
    """Equal bit for bit, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0, a), torch.where(nan, 0, b))


def assert_flags(tout, jout):
    """Port (states, carry, rows) against JAX (states, done, conv_iter,
    ever_conv, rows), lane by lane."""
    f = tout[1].flags.numpy()
    np.testing.assert_array_equal(f[:, 0] > 0, np.asarray(jout[1]))
    np.testing.assert_array_equal(f[:, 1], np.asarray(jout[2]))
    np.testing.assert_array_equal(f[:, 2] > 0, np.asarray(jout[3]))


class TestAgainstPallasLanes:
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_aligned_lanes(self, jx, corner):
        """N=32, B=2, 20 steps, quadratures every 16th step."""
        lanes = [(400.0, 0.15), (1000.0, 0.10)]
        jops, tops, jst, tst = jx.sg_lanes(32, lanes, corner)
        chunk, m = 20, 16
        jout = jx.aligned(jops, chunk, 1e-30, 10, interpret=True,
                          algorithm="x6", metrics_every=m)(jst, 0)
        assert sgl.lane_metrics_every(32) == m
        tout = sgl.make_lane_chunk_runner(tops, chunk, 1e-30)(tst, 0)
        assert_flags(tout, jout)
        for a, b in zip(tout[0], jout[0]):
            for k in range(2):
                assert rel(a[k].numpy(), np.asarray(b[k])) <= F32_TOL
        trows, jrows = tout[2].numpy(), np.asarray(jout[4])
        assert trows.shape == jrows.shape == (chunk, 2, 7)
        assert rel_cols(trows[:, :, :1], jrows[:, :, :1]) <= F32_TOL
        sampled = [i for i in range(chunk) if i == 0 or i % m == 0]
        assert rel_cols(trows[sampled], jrows[sampled]) <= F32_TOL

    def test_tiled_lanes(self, jx):
        """N=20 (outside the aligned set: quadratures every step), B=2."""
        jops, tops, jst, tst = jx.sg_lanes(20, [(100.0, 0.15),
                                                (400.0, 0.05)])
        chunk = 8
        jout = jx.tiled(jops, chunk, 1e-30, 10, interpret=True,
                        algorithm="x6")(jst, 0)
        assert sgl.lane_metrics_every(20) == 1
        tout = sgl.make_lane_chunk_runner(tops, chunk, 1e-30)(tst, 0)
        assert_flags(tout, jout)
        for a, b in zip(tout[0], jout[0]):
            assert rel(a.numpy(), np.asarray(b)) <= F32_TOL
        assert rel_cols(tout[2].numpy(), np.asarray(jout[4])) <= F32_TOL

    def test_a_lane_converging_mid_chunk(self, jx):
        """Lane 0 meets the tolerance mid-chunk, lane 1 (Re=1000 at a fifth
        of the CFL: its iterate change stays about twice lane 0's) does
        not: flags, conv_iter and NaN rows as the aligned lane kernel's."""
        jops, tops, jst, tst = jx.sg_lanes(32, [(100.0, 0.15, 1.5),
                                                (1000.0, 0.15, 0.3)])
        probe = np.asarray(jx.aligned(jops, 20, 1e-30, 10, interpret=True,
                                      algorithm="x6", metrics_every=16)(
            jst, 0)[4])
        tol = float(probe[10:, 1, 0].min()) * 0.99
        assert float(probe[10:16, 0, 0].min()) < tol
        jout = jx.aligned(jops, 20, tol, 10, interpret=True, algorithm="x6",
                          metrics_every=16)(jst, 0)
        tout = sgl.make_lane_chunk_runner(tops, 20, tol)(tst, 0)
        assert bool(jout[3][0]) and not bool(jout[1][1])
        assert_flags(tout, jout)
        np.testing.assert_array_equal(np.isnan(tout[2].numpy()),
                                      np.isnan(np.asarray(jout[4])))
        for a, b in zip(tout[0], jout[0]):
            assert rel(a.numpy(), np.asarray(b)) <= F32_TOL

    def test_fv_lanes(self, jx):
        """16x16, B=2 with Re, alpha_uv and alpha_p varying, K=8 BiCGSTAB
        iterations, 12 iterations from rest."""
        lanes = [(100.0, 0.4, 0.2), (400.0, 0.6, 0.3)]
        jps, jops, tops, jst, tst = jx.fv_lanes(16, 16, lanes)
        chunk, K = 12, 8
        jout = jx.fv(jps, jops, chunk, 1e-30, 10, bicgstab_iters=K,
                     interpret=True)(jst, 0)
        tout = fvl.make_fv_lane_runner(jps, tops, chunk, 1e-30,
                                       bicgstab_iters=K)(tst, 0)
        assert_flags(tout, jout)
        for a, b in zip(tout[0], jout[0]):
            assert float(np.max(np.abs(a.numpy() - np.asarray(b)))) \
                <= F32_ABS
        trows, jrows = tout[2].numpy(), np.asarray(jout[4])
        assert rel_cols(trows[:, :, :1], jrows[:, :, :1]) <= F32_TOL
        assert rel_cols(trows, jrows) <= F32_TOL

    def test_fv_lane_converging_mid_chunk(self, jx):
        jps, jops, tops, jst, tst = jx.fv_lanes(
            16, 16, [(100.0, 0.4, 0.2), (400.0, 0.6, 0.3)])
        run = lambda tol: jx.fv(jps, jops, 24, tol, 10, bicgstab_iters=8,
                                interpret=True)(jst, 0)
        probe = np.asarray(run(1e-30)[4])
        tol = float(probe[10:18, 0, 0].min()) * 1.001
        jout = run(tol)
        tout = fvl.make_fv_lane_runner(jps, tops, 24, tol,
                                       bicgstab_iters=8)(tst, 0)
        assert bool(jout[3][0])
        assert_flags(tout, jout)
        np.testing.assert_array_equal(np.isnan(tout[2].numpy()),
                                      np.isnan(np.asarray(jout[4])))

    @pytest.mark.parametrize("n", [24, 32, 40, 96, 100, 320, 328])
    @pytest.mark.parametrize("singular", [False, True])
    def test_cadence_follows_the_jax_dispatch(self, jx, n, singular):
        aligned = jx.aligned_supported(n, singular=singular)
        assert sgl.aligned_supported(n) == aligned
        assert sgl.lane_metrics_every(n) == (16 if aligned else 1)


# ------------------------------------------------------------ wrappers


def f64_sg_ops(lanes, n=12, corner="smoothing"):
    """Port float64 CPU ops for lanes of (Re, corner_smoothing, CFL,
    beta_squared)."""
    return [T.build_spectral_ops(SpectralParameters(
        Re=Re, nx=n, ny=n, device="cpu", dtype="float64",
        corner_treatment=corner, corner_smoothing=cs, CFL=cfl,
        beta_squared=beta))[0] for Re, cs, cfl, beta in lanes]


SG_LANES = [(100.0, 0.15, 1.5, 5.0), (400.0, 0.10, 1.2, 4.0),
            (1000.0, 0.05, 1.0, 6.0)]


def fv_setup(lanes, n=10, device="cpu", dtype="float64", **over):
    ps = [FVParameters(Re=Re, nx=n, ny=n, alpha_uv=a, alpha_p=ap,
                       lid_velocity=U, dtype=dtype, device=device, **over)
          for Re, a, ap, U in lanes]
    return ps, [TFV.build_fv_ops(p)[0] for p in ps]


FV_LANES = [(100.0, 0.4, 0.2, 1.0), (400.0, 0.6, 0.3, 1.0),
            (1000.0, 0.5, 0.25, 1.5)]


class TestLaneWrappers:
    def test_sg_lane_b_is_the_one_lane_chunk(self):
        ops = f64_sg_ops(SG_LANES)
        st = stack_states([T.initial_state(o) for o in ops])
        sgl.reset_counts()
        out = sgl.make_lane_chunk_runner(ops, 30, 1e-30)(st, 0)
        assert sgl.PLAIN_CALLS == {"sg_lanes": 1}
        assert sgl.LAUNCHES == {k: 0 for k in sgl.KERNELS}
        for b, o in enumerate(ops):
            one = sgk.chunk_plain(o, T.initial_state(o), 0, np.inf, 30,
                                  1e-30, 10, False, 1)
            for a, c in zip(out[0], one[0]):
                assert torch.equal(a[b], c)
            assert same_bits(out[2][:, b], one[4])
            assert out[1].flags[b].tolist() == [int(one[1]), int(one[2]),
                                                int(one[3])]

    def test_fv_lane_b_is_the_one_lane_chunk(self):
        ps, ops = fv_setup(FV_LANES)
        st = stack_states([TFV.initial_state(o) for o in ops])
        fvl.reset_counts()
        out = fvl.make_fv_lane_runner(ps, ops, 12, 1e-30,
                                      bicgstab_iters=8)(st, 0)
        assert fvl.PLAIN_CALLS == {"fv_lanes": 1}
        for b, (p, o) in enumerate(zip(ps, ops)):
            one = fvk.chunk_plain(fvk.statics(p, o), TFV.initial_state(o), 0,
                                  np.inf, 12, 1e-30, 10, 8)
            for a, c in zip(out[0], one[0]):
                assert torch.equal(a[b], c)
            assert same_bits(out[2][:, b], one[4])

    def test_the_carry_keeps_a_done_lane_frozen(self):
        """Lane 0 converges in the first chunk; in the next chunk it keeps
        its state, flags and NaN rows while lane 1 runs on as its one-lane
        chunk from its own state."""
        ops = f64_sg_ops([(100.0, 0.15, 1.5, 5.0), (1000.0, 0.15, 0.3, 5.0)])
        st = stack_states([T.initial_state(o) for o in ops])
        probe = sgl.make_lane_chunk_runner(ops, 30, 1e-30)(st, 0)[2].numpy()
        tol = float(probe[10:30, 1, 0].min()) * 0.99
        assert float(probe[10:25, 0, 0].min()) < tol
        run = sgl.make_lane_chunk_runner(ops, 30, tol)
        first = run(st, 0)
        f = first[1].flags.tolist()
        assert f[0][0] == 1 and f[0][2] == 1 and 11 <= f[0][1] <= 25
        assert f[1] == [0, -1, 0]
        second = run(first[0], 30, first[1])
        assert second[1].flags[0].tolist() == f[0]
        assert torch.isnan(second[2][:, 0]).all()
        for a, b in zip(second[0], first[0]):
            assert torch.equal(a[0], b[0])
        one = sgk.chunk_plain(ops[1], T.SpectralState(*(t[1] for t in
                                                        first[0])),
                              30, np.inf, 30, tol, 10, False, 1)
        for a, c in zip(second[0], one[0]):
            assert torch.equal(a[1], c)
        assert same_bits(second[2][:, 1], one[4])

    def test_residual_normalization_is_per_lane(self):
        ops = f64_sg_ops(SG_LANES[:2])
        st = stack_states([T.initial_state(o) for o in ops])
        out = sgl.make_lane_chunk_runner(ops, 20, 1e-30, 10, "residual")(
            st, 0)
        for b, o in enumerate(ops):
            one = sgk.chunk_plain(o, T.initial_state(o), 0, np.inf, 20,
                                  1e-30, 10, True, 1)
            assert float(out[1].ref_norm[b]) == float(one[5])
        assert float(out[1].ref_norm[0]) != float(out[1].ref_norm[1])

    def test_mixed_corner_modes_run_as_groups(self):
        """Singular and smoothed lanes in one batch: each corner mode is a
        lane group through the lane runner, and every lane is the one-lane
        chunk on its data, bit for bit, in its place."""
        ops = [f64_sg_ops(SG_LANES[:1])[0],
               f64_sg_ops(SG_LANES[1:2], corner="singular")[0],
               f64_sg_ops(SG_LANES[2:3])[0]]
        st = stack_states([T.initial_state(o) for o in ops])
        factory = sgl.maybe_lane_runner(ops, SimpleNamespace(
            use_pallas="true"))
        out = factory(20, 1e-30, 10, "residual")(st, 0)
        assert out[2].shape == (20, 3, 7)
        for b, o in enumerate(ops):
            one = sgk.chunk_plain(o, T.initial_state(o), 0, np.inf, 20,
                                  1e-30, 10, True, 1)
            for a, c in zip(out[0], one[0]):
                assert torch.equal(a[b], c)
            assert same_bits(out[2][:, b], one[4])
            assert float(out[1].ref_norm[b]) == float(one[5])
            assert out[1].flags[b].tolist() == [int(one[1]), int(one[2]),
                                                int(one[3])]

    def test_fv_residual_normalization_is_per_lane(self):
        """The FV lane runner's residual criterion: each lane's
        normalization and flags are its one-lane plain chunk's under the
        residual state machine; lane 1's continuity norm falls below 0.7 of
        its warmup value mid-chunk, lane 0's does not."""
        ps, ops = fv_setup(FV_LANES[:2])
        st = stack_states([TFV.initial_state(o) for o in ops])
        out = fvl.make_fv_lane_runner(ps, ops, 16, 0.7, 10, 8,
                                      "residual")(st, 0)
        f = out[1].flags.tolist()
        assert f[0] == [0, -1, 0] and f[1][0] == f[1][2] == 1
        assert 11 < f[1][1] < 16
        for b, (p, o) in enumerate(zip(ps, ops)):
            one = fvk.chunk_body(fvk.statics(p, o), TFV.initial_state(o), 0,
                                 np.inf, 16, 0.7, 10, 8, True)
            assert float(out[1].ref_norm[b]) == float(one[5])
            assert out[1].flags[b].tolist() == [int(one[1]), int(one[2]),
                                                int(one[3])]
            assert same_bits(out[2][:, b], one[4])
        assert float(out[1].ref_norm[0]) != float(out[1].ref_norm[1])

    def test_sg_dispatch_follows_use_pallas(self):
        """false and auto on the CPU take the plain path, true the lane
        runner; a batch that mixes corner modes runs one lane group per
        mode, and differing operators raise."""
        ops = f64_sg_ops(SG_LANES[:2])
        p = SimpleNamespace(use_pallas="false")
        assert sgl.maybe_lane_runner(ops, p) is None
        p.use_pallas = "auto"  # the plain batched path on the CPU
        assert sgl.maybe_lane_runner(ops, p) is None
        p.use_pallas = "true"
        factory = sgl.maybe_lane_runner(ops, p)
        st = stack_states([T.initial_state(o) for o in ops])
        sgl.reset_counts()
        factory(10, 1e-30, 10, "rel_iter")(st, 0)
        assert sgl.PLAIN_CALLS["sg_lanes"] == 1
        mixed = ops[:1] + f64_sg_ops(SG_LANES[1:2], corner="singular")
        with pytest.raises(ValueError, match="one corner mode"):
            sgl.validate_lanes(mixed)
        sgl.reset_counts()
        sgl.maybe_lane_runner(mixed, p)(10, 1e-30, 10, "rel_iter")(
            stack_states([T.initial_state(o) for o in mixed]), 0)
        assert sgl.PLAIN_CALLS["sg_lanes"] == 2  # one call per group
        with pytest.raises(ValueError, match="shared operators"):
            sgl.maybe_lane_runner(ops[:1] + f64_sg_ops(SG_LANES[:1], n=16),
                                  p)
        assert not sgl.aligned_lanes_supported(ops)  # N=12
        assert sgl.aligned_lanes_supported(f64_sg_ops(SG_LANES[:2], n=32))

    def test_fv_dispatch_follows_use_pallas(self):
        ps, ops = fv_setup(FV_LANES[:2], use_pallas="true")
        assert fvl.fv_lanes_supported(ps, ops)
        factory = fvl.maybe_fv_lane_runner(ps, ops)
        assert callable(factory(4, 1e-3, 10, "residual"))
        with pytest.raises(ValueError, match="mapped criterion"):
            factory(4, 1e-3, 10, "energy")
        for p in ps:
            p.use_pallas = "auto"
        assert fvl.maybe_fv_lane_runner(ps, ops) is None  # CPU: plain path
        ps2, ops2 = fv_setup(FV_LANES[:2], fv_inner_iters=8)
        with pytest.raises(ValueError, match="fv_inner_iters"):
            fvl.validate_lanes([ps[0], ps2[1]], [ops[0], ops2[1]])
        ps3, ops3 = fv_setup(FV_LANES[:1], n=12)
        with pytest.raises(ValueError, match="grid"):
            fvl.validate_lanes([ps[0], ps3[0]], [ops[0], ops3[0]])
        ps4, ops4 = fv_setup(FV_LANES[:2], limiter="MUSCL-sharp")
        assert not fvl.fv_lanes_supported(ps4, ops4)

    @pytest.mark.parametrize("family", ["sg", "fv"])
    def test_bindings_match_the_c_entries(self, family):
        """Every C entry of a family's host file has a ctypes binding with
        its number of arguments (the card cannot be asked here)."""
        import re
        from pathlib import Path

        from anap3_tpu_torch.ops import _build

        class Fake:
            def __getattr__(self, name):
                fn = SimpleNamespace(argtypes=None, restype=None)
                setattr(self, name, fn)
                return fn

        lib = Fake()
        _build._BIND[family](lib)
        host = Path(_build.__file__).parents[1] / "csrc" / f"{family}_host.cu"
        text = host.read_text().split('extern "C" {', 1)[1]
        entries = re.findall(r"^[\w ]+?\**\s*(\w+)\(([^)]*)\)\s*\{",
                             text, re.M)
        assert len(entries) >= 4
        for name, args in entries:
            assert len(getattr(lib, name).argtypes) == len(args.split(",")), \
                name

    def test_checks_shapes_and_criteria(self):
        ops = f64_sg_ops(SG_LANES[:2])
        run = sgl.make_lane_chunk_runner(ops, 4, 1e-3)
        st = stack_states([T.initial_state(o) for o in ops])
        with pytest.raises(ValueError, match="shape"):
            run(T.SpectralState(st.u[:1], st.v, st.p), 0)
        with pytest.raises(TypeError, match="dtype"):
            run(T.SpectralState(st.u.float(), st.v, st.p), 0)
        with pytest.raises(ValueError, match="mapped criterion"):
            sgl.make_lane_chunk_runner(ops, 4, 1e-3,
                                       convergence_metric="energy")
        with pytest.raises(ValueError, match="at least one lane"):
            sgl.validate_lanes([])


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lane kernels have no CPU mode")
    return torch.device("cuda")


def tol_of(dtype, f64_tol):
    return f64_tol if dtype == torch.float64 else F32_TOL


def rel_t(a, b):
    return rel(a.detach().cpu().double().numpy(),
               b.detach().cpu().double().numpy())


def card_sg_ops(lanes, n, dtype, corner="smoothing"):
    return [T.build_spectral_ops(SpectralParameters(
        Re=Re, nx=n, ny=n, device="cuda", corner_treatment=corner,
        corner_smoothing=cs, CFL=cfl, beta_squared=beta,
        dtype="float64" if dtype == torch.float64 else "float32"))[0]
        for Re, cs, cfl, beta in lanes]


def sg_one_lane(ops, state, start, chunk, tol, m_every):
    return sgk.make_sg_chunk_runner(ops, chunk, tol, 10, "rel_iter",
                                    m_every)(state, start, np.inf)


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("n", [20, 40])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_sg_lanes_match_plain_and_one_lane(self, cuda, n, dtype, corner):
        ops = card_sg_ops(SG_LANES, n, dtype, corner)
        st = stack_states([T.initial_state(o) for o in ops])
        run = sgl.make_lane_chunk_runner(ops, 40, 1e-30)
        out_k = run(st, 0)
        torch.cuda.synchronize()
        m = sgl.lane_metrics_every(n)
        out_p = sgl.lanes_plain(ops, st, 0, TR.fresh_carry(3, dtype, cuda),
                                40, 1e-30, 10, False, m)
        for a, b in zip(out_k[0], out_p[0]):
            assert rel_t(a, b) <= tol_of(dtype, SG_F64_TOL)
        assert rel_cols(out_k[2].cpu(), out_p[2].cpu()) <= \
            tol_of(dtype, SG_F64_TOL)
        assert torch.equal(out_k[1].flags, out_p[1].flags)
        for b, o in enumerate(ops):
            one = sg_one_lane(o, T.SpectralState(*(t[b] for t in st)), 0,
                              40, 1e-30, m)
            for a, c in zip(out_k[0], one[0]):
                assert torch.equal(a[b], c)
            assert same_bits(out_k[2][:, b], one[4])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_sg_nan_lane_is_isolated(self, cuda, dtype):
        """A lane with a huge CFL goes non-finite: it is flagged diverged
        and frozen, and the other lanes keep their one-lane bits."""
        lanes = SG_LANES[:2] + [(400.0, 0.15, 1e4, 5.0)]
        ops = card_sg_ops(lanes, 40, dtype)
        st = stack_states([T.initial_state(o) for o in ops])
        out = sgl.make_lane_chunk_runner(ops, 48, 1e-30)(st, 0)
        flags = out[1].flags.tolist()
        assert flags[2][0] == 1 and flags[2][2] == 0 and flags[2][1] > 0
        assert torch.isnan(out[2][flags[2][1]:, 2]).all()
        for b in range(2):
            assert flags[b] == [0, -1, 0]
            one = sg_one_lane(ops[b], T.SpectralState(*(t[b] for t in st)),
                              0, 48, 1e-30, 16)
            for a, c in zip(out[0], one[0]):
                assert torch.equal(a[b], c)

    def test_sg_mid_chunk_convergence_matches_plain(self, cuda):
        ops = card_sg_ops(SG_LANES[:2], 20, torch.float64)
        st = stack_states([T.initial_state(o) for o in ops])
        carry = TR.fresh_carry(2, torch.float64, cuda)
        probe = sgl.lanes_plain(ops, st, 0, carry, 30, 1e-30, 10, False,
                                1)[2].cpu().numpy()
        tol = float(probe[12:20, 0, 0].min()) * (1 + 1e-6)
        out_k = sgl.make_lane_chunk_runner(ops, 30, tol)(st, 0)
        out_p = sgl.lanes_plain(ops, st, 0, carry, 30, tol, 10, False, 1)
        assert out_p[1].flags[0, 0] == 1
        assert torch.equal(out_k[1].flags, out_p[1].flags)
        np.testing.assert_array_equal(torch.isnan(out_k[2]).cpu().numpy(),
                                      torch.isnan(out_p[2]).cpu().numpy())
        for a, b in zip(out_k[0], out_p[0]):
            assert rel_t(a, b) <= SG_F64_TOL

    def test_sg_launch_counters(self, cuda):
        ops = card_sg_ops(SG_LANES, 40, torch.float32)
        st = stack_states([T.initial_state(o) for o in ops])
        sgl.reset_counts()
        sgk.reset_counts()
        sgl.make_lane_chunk_runner(ops, 20, 1e-30)(st, 0)
        # N=40 is an order of the resident geometry: one launch a chunk
        assert sgl.LAUNCHES == {"sg_lanes_tiled": 0, "sg_lanes_aligned": 0,
                                "sg_lanes_resident": 1}
        assert sgk.LAUNCHES == {k: 0 for k in sgk.KERNELS}
        # past it (N=64) 5 launches a step for all lanes (4 stages and one
        # tail: the tail kernel on the sampled steps i = 0 and idx = 16,
        # control on the others), and dt once
        ops = card_sg_ops(SG_LANES, 64, torch.float32)
        assert sgk.resident_geometry(ops[0].nf, ops[0].dtype, 8) is None
        st = stack_states([T.initial_state(o) for o in ops])
        sgl.reset_counts()
        sgl.make_lane_chunk_runner(ops, 20, 1e-30)(st, 0)
        assert sgl.LAUNCHES == {"sg_lanes_tiled": 0, "sg_lanes_aligned": 101,
                                "sg_lanes_resident": 0}
        assert sgk.LAUNCHES == {k: 0 for k in sgk.KERNELS}
        assert sgl.PLAIN_CALLS == {"sg_lanes": 0}

    @pytest.mark.parametrize("ny,nx", [(12, 16), (20, 20)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("scheme", ["TVD", "Upwind"])
    def test_fv_lanes_match_plain_and_one_lane(self, cuda, ny, nx, dtype,
                                               scheme):
        ps = [FVParameters(Re=Re, nx=nx, ny=ny, alpha_uv=a, alpha_p=ap,
                           lid_velocity=U, convection_scheme=scheme,
                           dtype="float64" if dtype == torch.float64
                           else "float32", device="cuda")
              for Re, a, ap, U in FV_LANES]
        ops = [TFV.build_fv_ops(p)[0] for p in ps]
        st = stack_states([TFV.initial_state(o) for o in ops])
        run = fvl.make_fv_lane_runner(ps, ops, 24, 1e-30)
        out_k = run(st, 0)
        torch.cuda.synchronize()
        S_list = [fvk.statics(p, o) for p, o in zip(ps, ops)]
        out_p = fvl.lanes_plain(S_list, st, 0,
                                TR.fresh_carry(3, dtype, cuda), 24, 1e-30,
                                10, 16)
        for a, b in zip(out_k[0], out_p[0]):
            assert rel_t(a, b) <= tol_of(dtype, FV_F64_TOL)
        assert rel_cols(out_k[2].cpu(), out_p[2].cpu()) <= \
            tol_of(dtype, FV_F64_TOL)
        assert torch.equal(out_k[1].flags, out_p[1].flags)
        for b, (p, o) in enumerate(zip(ps, ops)):
            one = fvk.make_fv_chunk_runner(p, o, 24, 1e-30, 10, 16)(
                TFV.FVState(*(t[b] for t in st)), 0, np.inf)
            for a, c in zip(out_k[0], one[0]):
                assert torch.equal(a[b], c)
            assert same_bits(out_k[2][:, b], one[4])

    def test_fv_nan_lane_is_isolated(self, cuda):
        ps = [FVParameters(Re=Re, nx=20, ny=20, alpha_uv=a, alpha_p=ap,
                           lid_velocity=U, dtype="float32", device="cuda")
              for Re, a, ap, U in FV_LANES]
        ops = [TFV.build_fv_ops(p)[0] for p in ps]
        states = [TFV.initial_state(o) for o in ops]
        u = states[1].u.clone()
        u[5, 7] = float("nan")
        states[1] = TFV.FVState(u, *states[1][1:])
        st = stack_states(states)
        out = fvl.make_fv_lane_runner(ps, ops, 16, 1e-30)(st, 0)
        flags = out[1].flags.tolist()
        assert flags[1] == [1, 1, 0]
        assert torch.isnan(out[2][:, 1]).all()
        for b in (0, 2):
            assert flags[b] == [0, -1, 0]
            one = fvk.make_fv_chunk_runner(ps[b], ops[b], 16, 1e-30, 10, 16)(
                states[b], 0, np.inf)
            for a, c in zip(out[0], one[0]):
                assert torch.equal(a[b], c)

    @staticmethod
    def _reset_counts():
        for m in (sgk, sgl, fvk, fvl, TS):
            m.reset_counts()

    @staticmethod
    def _plain_calls():
        return {k: v for m in (sgk, sgl, fvk, fvl, TS)
                for k, v in m.PLAIN_CALLS.items() if v}

    @pytest.mark.parametrize("n,kernel", [(32, "sg_lanes_resident"),
                                          (64, "sg_lanes_aligned")])
    def test_mixed_corner_batch_launches_lane_kernels(self, cuda, n, kernel):
        """Smoothed and singular lanes in one run_batched group: one lane
        group per corner mode through the lane kernels (the resident chunk
        at N=32, the multi-launch one past its geometry), no plain call,
        and every lane is its own SGSolver run, bit for bit."""
        ps = [SpectralParameters(
            Re=Re, nx=n, ny=n, device="cuda", dtype="float32",
            corner_treatment=corner, corner_smoothing=0.15, tolerance=1e-30,
            max_iterations=300, chunk_size=100,
            convergence_metric="rel_iter")
            for Re, corner in ((100.0, "smoothing"), (400.0, "singular"),
                               (1000.0, "smoothing"))]
        solvers = [SGSolver(params=p) for p in ps]
        self._reset_counts()
        results = TB.run_batched(solvers)
        torch.cuda.synchronize()
        assert sgl.LAUNCHES[kernel] > 0
        assert self._plain_calls() == {}
        for p, s, r in zip(ps, solvers, results):
            one = SGSolver(params=p)
            one.solve()
            assert r.iterations == one.metrics.iterations == 300
            for a, b in zip(s.state, one.state):
                assert torch.equal(a, b)

    def test_fv_residual_batch_launches_lane_kernels(self, cuda):
        """FV lanes under the residual criterion, through run_batched: the
        FV lane kernels with each lane's own normalization, no plain call,
        both lanes converged mid-chunk, and each lane its own B=1 residual
        solve: count and bits."""
        ps = [FVParameters(Re=Re, nx=16, ny=16, dtype="float64",
                           device="cuda", tolerance=0.05, max_iterations=300,
                           chunk_size=100, lid_velocity=U,
                           convergence_metric="residual")
              for Re, U in ((100.0, 1.0), (400.0, 1.5))]
        solvers = [TFV.FVSolver(params=p) for p in ps]
        self._reset_counts()
        results = TB.run_batched(solvers)
        torch.cuda.synchronize()
        assert fvl.LAUNCHES["fv_lanes"] > 0
        assert self._plain_calls() == {}
        for p, s, r in zip(ps, solvers, results):
            assert r.converged and 10 < r.iterations < 300
            one = TFV.FVSolver(params=p)
            one.solve()
            assert one.metrics.converged
            assert r.iterations == one.metrics.iterations
            for a, b in zip(s.state, one.state):
                assert torch.equal(a, b)
