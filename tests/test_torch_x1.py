"""``matmul_algorithm=x1`` of the port: one bf16 pass a product.

On the CPU (every run): the plain x1 chunk of ``ops/sg_kernels.py``
(``chunk_plain(..., hi=x1_operators(ops))``) against the JAX package's x1
mode, ``anap3_tpu/ops/pallas_aligned.py:make_aligned_chunk_runner(...,
interpret=True, algorithm="x1", metrics_every=16)``, float32, at N = 32
and 40, smoothed and singular lids, Re 100 and 1000. Both round the same
float32 values to bf16 and form exact products, so they differ in the
float32 sum order alone; the bound is 1e-5 relative per field (readings
<= 4.1e-7 for one step). A sum-order difference can move a sum across a bf16 rounding
boundary, and that rounding, one element by 2^-8, grows over the steps
after it (a seeded random state drifts to ~1e-3 over 16 steps, as far as
two plain x1 chunks from starts one float32 ulp apart do). So the
16-step trajectory from a seeded state is held step by step (each port
step from the JAX state of the step before; readings <= 1.2e-6), and the
whole 16-step chunk from rest (every solve's start; readings <= 7.1e-6),
both at 1e-5. Rows
are compared where both sides sampled (the JAX kernel holds its residual
norms between samples under rel_iter; the port's are exact every step).

Also: x1 differs from the exact chunk at the bf16 level (~1e-3), and the
dispatch of ``models/spectral.py`` routes x1 as
``anap3_tpu/models/spectral.py:139-200`` does; the x1 stage kernel's bf16
operands as the host makes them (the operator table, bf16_round of
``x1_operators`` in the kernel's layout; the plain state copy) and its
geometry at every x1 order (within the card's shared memory).

On a CUDA card (marker ``gpu``): the x1 kernel chunk against the plain x1
and its launches, like with like. Inside a step each stage state comes
out of the kernel's sums, which round as its tensor cores do (16-wide k
blocks, the accumulator rounded toward zero), and a value that lies at a
bf16 rounding boundary rounds on the other side of it than in the plain
float32 sums: one element 2^-8 apart, which the Chebyshev operators carry
into whole lines. So each stage of the kernel's one-step chunk is held
from its own inputs (``sg_kernels.x1_step_stages``, bit-equal to the
chunk's step) against the plain stage that sums as the tensor cores do
(``x1_operators(ops, tc=True)``), the chunk's rows against the plain
ones of the same stage states, and one tail launch against
``x1_conserved_quantities``, all at 1e-5; the bench entry's x1 stage
against ``stage_x1_plain`` (1e-5); and the bf16 state copies the kernels
write, bit for bit ``x1_state_copy`` of the float32 state beside them,
after a capped chunk and after one whose lane began done. Run them there
with ``python -m pytest tests/test_torch_x1.py -m gpu --noconftest``.
"""

import logging
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import spectral as TSP
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.models.runner import rel_change
from anap3_tpu_torch.ops import sg_kernels as sgk

torch.set_num_threads(1)

TOL = 1e-5
CASES = [(n, corner, re) for n in (32, 40)
         for corner in ("smoothing", "singular") for re in (100.0, 1000.0)]
INF = float("inf")


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here: the card's machine has no JAX."""
    import jax.numpy as jnp
    from anap3_tpu.models import spectral_sg as J
    from anap3_tpu.models.params import SpectralParameters as JaxParameters
    from anap3_tpu.ops.pallas_aligned import make_aligned_chunk_runner

    cache = {}

    def case(n, corner, re):
        if (n, corner, re) not in cache:
            p = JaxParameters(Re=re, nx=n, ny=n, dtype="float32",
                              basis_type="chebyshev", CFL=1.5,
                              corner_treatment=corner)
            jops, grid = J.build_spectral_ops(p, dtype=jnp.float32)
            tops = T.ops_from_jax(jops, "cpu", torch.float32)
            cache[(n, corner, re)] = (jops, tops, sgk.x1_operators(tops),
                                      np.asarray(grid["x_nodes"]))
        return cache[(n, corner, re)]

    runners = {}

    def run(jops, key, chunk, state, start):
        if (key, chunk) not in runners:
            runners[(key, chunk)] = make_aligned_chunk_runner(
                jops, chunk, 1e-30, 10, interpret=True, algorithm="x1",
                metrics_every=16)
        jst = J.SpectralState(*(jnp.asarray(t.numpy()) for t in state))
        out = runners[(key, chunk)](jst, jnp.int32(start), jnp.float32(INF))
        st = T.SpectralState(*(torch.as_tensor(np.array(a))
                               for a in out[0]))
        return st, out

    return SimpleNamespace(case=case, run=run)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def seeded_state(ops, nodes, seed, smooth):
    """A float32 state from numpy: white noise (amplitude 0.05), or three
    sine modes a direction with random amplitudes (0.1), with the BCs."""
    rng = np.random.default_rng(seed)
    nf = ops.nf
    if smooth:
        x = (nodes - nodes[0]) / (nodes[-1] - nodes[0])
        s = [np.sin(a * np.pi * x) for a in (1, 2, 3)]

        def field():
            return 0.1 * sum(rng.standard_normal() * np.outer(a, b)
                             for a in s for b in s)
        u, v, p = field(), field(), field()[1:-1, 1:-1]
    else:
        u, v, p = (0.05 * rng.standard_normal(s) for s in (
            (nf, nf), (nf, nf), (nf - 2, nf - 2)))
    st = T.state_from_numpy((u, v, p), "cpu", torch.float32)
    uu, vv = T.enforce_bc(ops, st.u, st.v)
    return T.SpectralState(uu, vv, st.p)


def flags(out):
    return [int(out[i]) for i in (1, 2, 3)]


class TestAgainstJaxX1:
    @pytest.mark.parametrize("n,corner,re", CASES)
    def test_one_step(self, jx, n, corner, re):
        """One x1 step from a seeded white-noise state: u, v, p and every
        column of the row within 1e-5 (readings <= 4.1e-7)."""
        jops, ops, hi, nodes = jx.case(n, corner, re)
        st = seeded_state(ops, nodes, n + int(re), smooth=False)
        js, jout = jx.run(jops, (n, corner, re), 1, st, 0)
        tout = sgk.chunk_plain(ops, st, 0, INF, 1, 1e-30, 10, False, 16,
                               hi=hi)
        assert flags(tout) == flags(jout)
        for a, b in zip(tout[0], js):
            assert rel(a, b) <= TOL
        assert rel(tout[4][0].numpy(), np.asarray(jout[4])[0]) <= TOL

    @pytest.mark.parametrize("n,corner,re", CASES)
    def test_sixteen_steps_step_by_step(self, jx, n, corner, re):
        """The 16-step x1 trajectory from a seeded smooth state: every
        port step from JAX's state before it, 1e-5 per field and row,
        flags equal (readings <= 1.2e-6)."""
        jops, ops, hi, nodes = jx.case(n, corner, re)
        st = seeded_state(ops, nodes, 7 * n + int(re), smooth=True)
        for k in range(16):
            js, jout = jx.run(jops, (n, corner, re), 1, st, k)
            tout = sgk.chunk_plain(ops, st, k, INF, 1, 1e-30, 10, False, 16,
                                   hi=hi)
            assert flags(tout) == flags(jout), k
            for a, b in zip(tout[0], js):
                assert rel(a, b) <= TOL, k
            assert rel(tout[4][0].numpy(), np.asarray(jout[4])[0]) <= TOL
            st = js

    @pytest.mark.parametrize("n,corner,re", CASES)
    def test_sixteen_step_chunk_from_rest(self, jx, n, corner, re):
        """The whole 16-step x1 chunk from rest: u, v, p, the rel and
        quadrature columns of every row and the sampled first row within
        1e-5, flags equal (readings <= 7.1e-6)."""
        jops, ops, hi, _ = jx.case(n, corner, re)
        st = T.initial_state(ops)
        js, jout = jx.run(jops, (n, corner, re), 16, st, 0)
        tout = sgk.chunk_plain(ops, st, 0, INF, 16, 1e-30, 10, False, 16,
                               hi=hi)
        assert flags(tout) == flags(jout)
        for a, b in zip(tout[0], js):
            assert rel(a, b) <= TOL
        trows, jrows = tout[4].numpy(), np.asarray(jout[4])
        for c in (0, 4, 5, 6):
            assert rel(trows[:, c], jrows[:, c]) <= TOL, c
        assert rel(trows[0], jrows[0]) <= TOL

    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_x1_is_not_the_exact_chunk(self, jx, corner):
        """The x1 chunk lies 1e-5 from JAX's x1 and ~1e-3 from the exact
        (FMA) chunk: the bf16 products are engaged."""
        jops, ops, hi, nodes = jx.case(32, corner, 100.0)
        st = seeded_state(ops, nodes, 3, smooth=True)
        x1 = sgk.chunk_plain(ops, st, 0, INF, 1, 1e-30, 10, False, 16, hi=hi)
        exact = sgk.chunk_plain(ops, st, 0, INF, 1, 1e-30, 10, False, 16)
        js, _ = jx.run(jops, (32, corner, 100.0), 1, st, 0)
        far = max(rel(a, b) for a, b in zip(exact[0], x1[0]))
        near = max(rel(a, b) for a, b in zip(js, x1[0]))
        assert far > 1e-4 and near <= TOL and far > 100 * near


# ------------------------------------------------------------ dispatch


def f32_ops(n, corner="smoothing", dtype=torch.float32):
    p = SpectralParameters(Re=100.0, nx=n, ny=n, device="cpu",
                           dtype="float32" if dtype == torch.float32
                           else "float64", basis_type="chebyshev", CFL=1.5,
                           corner_treatment=corner)
    return T.build_spectral_ops(p, dtype=dtype)[0]


@pytest.fixture
def recorded(monkeypatch):
    """The keyword arguments make_fused_paths hands the chunk runner."""
    calls = []

    def record(*args, **kw):
        calls.append(kw)
        return lambda *a: None
    monkeypatch.setattr(TSP, "make_sg_chunk_runner", record)
    return calls


class TestDispatch:
    @pytest.mark.parametrize("n,corner", [(32, "smoothing"), (40, "singular"),
                                          (96, "smoothing")])
    def test_aligned_orders_take_x1(self, recorded, n, corner, caplog):
        ops = f32_ops(n, corner)
        with caplog.at_level(logging.WARNING):
            step, factory = TSP.make_fused_paths(ops, "x1")
            factory(16, 1e-3, "rel_iter")
        assert recorded[-1]["x1"] is True
        assert "covers only the aligned tier" not in caplog.text
        # the step keeps the exact products (JAX keeps x3 there)
        st = T.initial_state(ops)
        a, _ = step(st)
        b, _ = T.sg_step(ops, st)
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    @pytest.mark.parametrize("n,corner,text", [
        (20, "smoothing", "(N % 8 == 0, 32 <= N <= 320); N=20 runs x3"),
        (36, "singular", "singular N=36 runs x3"),
        (24, "smoothing", "N=24 runs x3")])
    def test_other_orders_warn_and_run_exact(self, recorded, n, corner, text,
                                             caplog):
        ops = f32_ops(n, corner)
        with caplog.at_level(logging.WARNING):
            _, factory = TSP.make_fused_paths(ops, "x1")
            factory(16, 1e-3, "rel_iter")
        assert recorded[-1]["x1"] is False
        assert "matmul_algorithm=x1 covers only the aligned tier" in caplog.text
        assert text in caplog.text

    def test_x1_supported_is_the_aligned_tier(self):
        from anap3_tpu.ops.pallas_aligned import aligned_supported

        for n in range(2, 400):
            for sing in (False, True):
                assert sgk.x1_supported(n) == aligned_supported(n, sing)

    @pytest.mark.parametrize("alg", ["auto", "x3", "x6"])
    def test_other_algorithms_never_take_x1(self, recorded, alg):
        _, factory = TSP.make_fused_paths(f32_ops(32), alg)
        factory(16, 1e-3, "rel_iter")
        assert recorded[-1]["x1"] is False

    def test_float64_raises(self):
        ops = f32_ops(32, dtype=torch.float64)
        with pytest.raises(ValueError, match="x1 runs in float32"):
            sgk.make_sg_chunk_runner(ops, 4, 1e-3, x1=True)
        with pytest.raises(ValueError, match="x1 runs in float32"):
            sgk.x1_operators(ops)
        with pytest.raises(ValueError, match="x1 runs in float32"):
            TSP.SGSolver(device="cpu", nx=32, ny=32, dtype="float64",
                         matmul_algorithm="x1", use_pallas="true").solve()

    def test_vmg_stages_and_sweeps_stay_exact(self, recorded):
        from anap3_tpu_torch.models.spectral_vmg import VMGSolver

        solver = VMGSolver(device="cpu", nx=32, ny=32, dtype="float64",
                           matmul_algorithm="x1", use_pallas="true")
        solver._check_options(x1_runs=False)  # the V-cycles and sweeps
        _, factory = solver._paths(solver.ops, exact=True)
        factory(16, 1e-3, "rel_iter")
        assert recorded[-1]["x1"] is False

    def test_solver_runs_the_x1_chunk(self):
        """SGSolver with use_pallas on the CPU runs the plain x1 chunk:
        its state after 48 steps is the plain x1 chunk's, bit for bit."""
        kw = dict(device="cpu", nx=32, ny=32, dtype="float32", Re=100.0,
                  basis_type="chebyshev", CFL=1.5, tolerance=1e-30,
                  max_iterations=48, chunk_size=16, matmul_algorithm="x1",
                  use_pallas="true", convergence_metric="rel_iter")
        solver = TSP.SGSolver(**kw)
        sgk.reset_counts()
        solver.solve()
        assert sgk.PLAIN_CALLS["sg_chunk"] == 3
        assert solver.metrics.iterations == 48
        ops = solver.ops
        want = sgk.chunk_plain(ops, T.initial_state(ops), 0, INF, 48, 1e-30,
                               10, False, 16, hi=sgk.x1_operators(ops))[0]
        for a, b in zip(solver.state, want):
            assert torch.equal(a, b)


class TestX1Operands:
    """The bf16 operands of the x1 stage kernel, made on the host: the
    operator table (once a run) and the plain version of the state copy
    that the kernels write."""

    @pytest.mark.parametrize("n", [32, 40])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_operator_table(self, n, corner):
        """Every band of x1_operator_table is bf16_round of x1_operators'
        field (DyT, DyyT, IyT, GyT transposed), zero from the contraction's
        end up to whole 16-wide k steps, the bands back to back."""
        p = SpectralParameters(Re=1000.0, nx=n, ny=n, device="cpu",
                               dtype="float32", basis_type="chebyshev",
                               CFL=1.5, corner_treatment=corner)
        ops = T.build_spectral_ops(p)[0]
        hi = sgk.x1_operators(ops)
        table = sgk.x1_operator_table(ops)
        nf, ni = ops.nf, ops.nf - 2
        k2, k1 = -(-(nf - 1) // 16) * 16, -(-ni // 16) * 16
        assert table.dtype == torch.bfloat16 and table.dim() == 1
        assert table.numel() == 4 * nf * (k1 + k2)
        views = sgk._x1_table_views(table, nf)
        at = 0
        for name in ("Dx", "Dxx", "DyT", "DyyT", "Gx", "Ix", "IyT", "GyT"):
            want = getattr(hi, name)
            if name in ("DyT", "DyyT", "IyT", "GyT"):
                want = want.T
            band = views[name]
            k = want.shape[1]
            assert band.shape == (nf, k2 if name in ("Dx", "Dxx", "DyT",
                                                     "DyyT") else k1)
            assert band.data_ptr() == table.data_ptr() + 2 * at
            assert torch.equal(band[:, :k].float(), sgk.bf16_round(want))
            assert torch.equal(band[:, k:].float(),
                               torch.zeros_like(band[:, k:].float()))
            at += band.numel()
        assert at == table.numel()

    def test_operator_table_matches_the_header(self):
        """The table's band order is csrc/sg_common.cuh's X1Op."""
        header = (Path(sgk.__file__).parents[1] / "csrc" /
                  "sg_common.cuh").read_text()
        body = header.split("enum X1Op {", 1)[1].split("};", 1)[0]
        names = re.findall(r"\bX_(\w+)", body)
        assert names[-1] == "COUNT"
        by_enum = {"DX": "Dx", "DXX": "Dxx", "DY": "DyT", "DYY": "DyyT",
                   "GX": "Gx", "IX": "Ix", "IY": "IyT", "GY": "GyT"}
        assert [by_enum[n] for n in names[:-1]] == [
            name for name, _ in sgk._X1_TABLE]

    @pytest.mark.parametrize("n", [32, 40])
    def test_state_copy_is_the_rounded_state(self, n):
        """x1_state_copy: u and v rounded to bf16 on [0, N)^2, p on the
        inner grid, zeros elsewhere (the border row and column N enter
        the products unrounded), in (S, S) and (Sp, Sp) arrays."""
        p = SpectralParameters(Re=100.0, nx=n, ny=n, device="cpu",
                               dtype="float32", basis_type="chebyshev")
        ops = T.build_spectral_ops(p)[0]
        rng = np.random.default_rng(n)
        nf = ops.nf
        st = T.state_from_numpy(tuple(rng.standard_normal(s) for s in (
            (nf, nf), (nf, nf), (nf - 2, nf - 2))), "cpu", torch.float32)
        xs = sgk.x1_state_copy(st)
        assert xs.dtype == torch.bfloat16
        assert xs.numel() == sgk._x1_state_elems(nf)
        u, v, pp = (t.float() for t in sgk._x1_state_views(xs, nf))
        N = nf - 1
        for got, want, m in ((u, st.u, N), (v, st.v, N), (pp, st.p, N - 1)):
            assert torch.equal(got[:m, :m], sgk.bf16_round(want[:m, :m]))
            rest = got.clone()
            rest[:m, :m] = 0
            assert not rest.any()

    @pytest.mark.parametrize("n", [n for n in range(32, 321, 8)])
    def test_geometry_fits(self, n):
        """The x1 stage's geometry at every x1_supported order: its shared
        memory (the copy groups in 4, 3 or 2 regions, the most that fit)
        within MAX_SMEM, the exact stage's tile and cluster."""
        assert sgk.x1_supported(n)
        nf = n + 1
        g = sgk.stage_geometry(nf, torch.float32, x1=True)
        ex = sgk.stage_geometry(nf, torch.float32)
        assert (g.tn, g.cluster, g.rows) == (ex.tn, ex.cluster, ex.rows)
        assert g.ks == nf and 2 <= g.depth <= 4
        assert g.smem == sgk._stage_x1_smem_bytes(nf, g.tn, g.ksplit,
                                                  g.depth) <= sgk.MAX_SMEM
        if g.depth < 4:  # the most regions that fit
            assert sgk._stage_x1_smem_bytes(nf, g.tn, g.ksplit,
                                            g.depth + 1) > sgk.MAX_SMEM


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the x1 kernels have no CPU mode")
    return torch.device("cuda")


def card_case(n, corner, seed):
    p = SpectralParameters(Re=1000.0, nx=n, ny=n, device="cuda",
                           dtype="float32", basis_type="chebyshev", CFL=1.5,
                           corner_treatment=corner)
    ops = T.build_spectral_ops(p)[0]
    rng = np.random.default_rng(seed)
    nf = ops.nf
    st = T.state_from_numpy(tuple(0.05 * rng.standard_normal(s) for s in (
        (nf, nf), (nf, nf), (nf - 2, nf - 2))), ops.device, ops.dtype)
    u, v = T.enforce_bc(ops, st.u, st.v)
    return ops, T.SpectralState(u, v, st.p)


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("n", [32, 96, 128])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_one_step_chunk_matches_plain(self, cuda, n, corner):
        ops, st = card_case(n, corner, n)
        out_k = sgk.make_sg_chunk_runner(ops, 1, 1e-30, 10, "rel_iter", 16,
                                         x1=True)(st, 0, INF)
        out_p = sgk.chunk_plain(ops, st, 0, INF, 1, 1e-30, 10, False, 16,
                                hi=sgk.x1_operators(ops))
        assert flags(out_k) == flags(out_p)
        ins, outs, adts = sgk.x1_step_stages(ops, st)
        for a, b in zip(outs[-1], out_k[0]):
            assert torch.equal(a, b)  # the chunk's step is these stages
        tc = sgk.x1_operators(ops, tc=True)
        for x, out, adt in zip(ins, outs, adts):
            ref, res = sgk.stage_x1_plain(ops, tc, *x, *st, adt)
            for a, b in zip(out, ref):
                assert rel(a.cpu(), b.cpu()) <= TOL
        # rows: rel from the stage states, the norms of the last stage's
        # residuals, the quadratures of the step's state
        rows = out_k[4][0].double().cpu()
        want = [torch.maximum(rel_change(outs[-1].u, st.u),
                              rel_change(outs[-1].v, st.v))]
        want += [torch.linalg.norm(r) for r in res]
        want += list(sgk.x1_conserved_quantities(
            ops, sgk.x1_operators(ops), outs[-1].u, outs[-1].v))
        for c in range(7):
            assert rel(rows[c], want[c].double().cpu()) <= TOL, c

    @pytest.mark.parametrize("n", [32, 96, 128])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_tail_launch_matches_plain(self, cuda, n, corner):
        ops, st = card_case(n, corner, n + 1)
        ws = sgk.chunk_workspace(ops, st, 1, INF)
        ws["x1b"] = sgk.x1_border_table(ops)
        sgk.bench_kernel(ops, ws, "tail", 1, x1=True)
        got = ws["scal"][0, 3:6].double().cpu()
        want = torch.stack(sgk.x1_conserved_quantities(
            ops, sgk.x1_operators(ops), st.u, st.v)).double().cpu()
        exact = torch.stack(T.conserved_quantities(ops, st.u, st.v)
                            ).double().cpu()
        near = max(rel(got[i], want[i]) for i in range(3))
        far = max(rel(want[i], exact[i]) for i in range(3))
        assert near <= TOL and far > 100 * near

    def test_launch_counters(self, cuda):
        ops, _ = card_case(32, "smoothing", 0)
        sgk.reset_counts()
        sgk.make_sg_chunk_runner(ops, 20, 1e-30, 10, "rel_iter", 16,
                                 x1=True)(T.initial_state(ops), 0, INF)
        # the x1 stage four times a step, the x1 tail on the 2 sampled
        # steps, control on the 18 others, dt once
        assert sgk.LAUNCHES == {"sg_stage": 0, "sg_diag": 1,
                                "sg_control": 18, "sg_stage_x1": 80,
                                "sg_diag_x1": 2}
        assert sgk.PLAIN_CALLS["sg_chunk"] == 0

    @pytest.mark.parametrize("n", [32, 128])
    @pytest.mark.parametrize("done", [False, True])
    def test_state_copies_follow_the_state(self, cuda, n, done):
        """After a capped chunk (7 steps), and after one whose lane began
        done (the stages keep the base), every bf16 state copy the kernels
        wrote is x1_state_copy of the float32 state beside it: the base's
        (dt rounded it, each step's last stage rewrote it) and the A
        buffers' (the third stage's output)."""
        ops, st = card_case(n, "smoothing", n + 2)
        ws = sgk.chunk_workspace(ops, st, 7, INF)
        ws.update(sgk.x1_workspace(ops))
        if done:
            ws["flags"][0] = 1
        sgk._run_chunk(ops, ws, 7, 0, 10, 16, False, 1e-30, x1=True)
        torch.cuda.synchronize()
        base = T.SpectralState(ws["u"], ws["v"], ws["p"])
        for got, state in ((ws["x1s"][0, 0], base),
                           (ws["x1s"][1, 0], T.SpectralState(
                               ws["au"][0], ws["av"][0], ws["ap"][0]))):
            want = sgk.x1_state_copy(state)
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        if done:
            for a, b in zip(base, st):
                assert torch.equal(a, b)

    # 248 / 256, 288 / 296: each side of the orders where the stage's
    # copy-group regions drop from 4 to 3 and from 3 to 2 (the C geometry
    # check and its Python mirror must agree there, or the launch fails)
    @pytest.mark.parametrize("n", [32, 96, 128, 248, 256, 288, 296, 320])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_bench_stage_matches_plain(self, cuda, n, corner):
        """The bench entry's x1 stage (its input rounded by its own launch
        first) against stage_x1_plain on the same inputs, within 1e-5,
        its bf16 input copy x1_state_copy of the input."""
        ops, st = card_case(n, corner, n + 3)
        _, base = card_case(n, corner, n + 4)
        ws = sgk.chunk_workspace(ops, base, 1, INF)
        ws.update(sgk.x1_workspace(ops))
        for name, t in zip(("au", "av", "ap"), st):
            ws[name].copy_(t)
        sgk.bench_kernel(ops, ws, "dt", 1)
        sgk.bench_kernel(ops, ws, "sg_stage", 1, x1=True)
        torch.cuda.synchronize()
        dt = ws["scal"][0, 0].clone()
        want, _ = sgk.stage_x1_plain(ops, sgk.x1_operators(ops), *st, *base,
                                     dt)
        for a, b in zip((ws["bu"], ws["bv"], ws["bp"]), want):
            assert rel(a.cpu(), b.cpu()) <= TOL
        assert torch.equal(ws["x1s"][1, 0].view(torch.int16),
                           sgk.x1_state_copy(st).view(torch.int16))
