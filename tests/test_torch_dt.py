"""The SG step's dt in anap3_tpu_torch: dt_kernel (csrc/sg_diag.cu) and the
smoother's dt from the partials its last stage leaves (csrc/sg_stage.cu,
csrc/sg_host.cu:sg_smooth_run).

On the CPU (every run): the plain versions ``sg_kernels.base_parts`` (the
partials a last stage writes of the base it leaves, one row a stage block)
and ``sg_kernels.dt_from_parts`` (dt from their maxima) against the port's
``adaptive_dt`` (bit for bit) and the JAX package's
``anap3_tpu/models/spectral_sg.py:adaptive_dt``, on seeded states at N =
12-48, both lids, float32 and float64. JAX computes the same formula with
its scalars in the working type and XLA's own contractions, so its dt is
not the port's bits: both land within 2 ulps of each other (the largest
distance over these inputs), and the maxima dt is taken from are equal.
Also the card's arithmetic of dt (``kernel=True``: csrc/sg_common.cuh:
dt_of, each fused multiply-add rounded once, done exactly on the host).

On a CUDA card (marker ``gpu``): dt_kernel's dt bit-equal to
``dt_from_parts(..., kernel=True)`` and within 1e-4 (float32) / 1e-11
(float64) of ``adaptive_dt``, its base norms within the same of the plain
sums, at N = 24-320, one lane and 8, and under x1 (with the state's bf16
copy it writes); the smoother bit-equal to as many steps, with 4 n + 2
launches a call. Run them there with
``python -m pytest tests/test_torch_dt.py -m gpu --noconftest``.
"""

import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.ops import sg_kernels as sgk

torch.set_num_threads(1)

CSRC = Path(sgk.__file__).resolve().parent.parent / "csrc"
F32_TOL = 1e-4
F64_TOL = 1e-11
# the largest distance of JAX's dt from the port's, and of the card's
# arithmetic from the plain formula, over the CPU inputs below
JAX_ULPS = 2
KERNEL_ULPS = 2
NP = {torch.float32: np.float32, torch.float64: np.float64}


def ops_of(n, dtype, corner="smoothing", device="cpu", Re=400.0, cs=0.15,
           cfl=1.5, beta=5.0):
    return T.build_spectral_ops(SpectralParameters(
        Re=Re, nx=n, ny=n, basis_type="chebyshev", CFL=cfl,
        beta_squared=beta, corner_treatment=corner, corner_smoothing=cs,
        device=device,
        dtype="float64" if dtype == torch.float64 else "float32"))[0]


def seeded_fields(n, dtype, seed):
    """u, v as numpy arrays of the working type; the scale varies with the
    seed, so that the lid clamp and the largest |u| both decide dt."""
    rng = np.random.default_rng(seed)
    scale = (0.01, 0.3, 3.0)[seed % 3]
    return tuple((scale * rng.standard_normal((n + 1, n + 1))).astype(
        NP[dtype]) for _ in range(2))


def ulps(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    as_int = np.int32 if a.dtype == np.float32 else np.int64
    return abs(int(a.view(as_int)) - int(b.view(as_int)))


CASES = [(n, dtype, corner) for n in (12, 20, 33, 48)
         for dtype in (torch.float32, torch.float64)
         for corner in ("smoothing", "singular")]


class TestPlain:
    @pytest.mark.parametrize("n, dtype, corner", CASES)
    def test_parts_cover_the_grid(self, n, dtype, corner):
        """One row a stage block; every point in one block."""
        ops = ops_of(n, dtype, corner)
        u, v = (torch.as_tensor(x) for x in seeded_fields(n, dtype, 1))
        parts = sgk.base_parts(ops, u, v)
        assert parts.shape == (sgk.stage_geometry(ops.nf, dtype).nparts, 4)
        ut = u + ops.sing_u if ops.singular else u
        assert parts[:, 0].max() == ut.abs().max()
        assert torch.allclose(parts[:, 2].sum(), (u * u).sum(),
                              rtol=1e-6 if dtype == torch.float32 else 1e-13)
        # a block's own maximum is where it lies
        g = sgk.stage_geometry(ops.nf, dtype)
        i, j = divmod(int(ut.abs().argmax()), ops.nf)
        blk = (i // sgk.STAGE_TM) * g.cluster + j // g.tn
        assert parts[blk, 0] == ut.abs().max()

    @pytest.mark.parametrize("n, dtype, corner", CASES)
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_dt_from_parts_is_adaptive_dt(self, n, dtype, corner, seed):
        ops = ops_of(n, dtype, corner)
        u, v = (torch.as_tensor(x) for x in seeded_fields(n, dtype, seed))
        got = sgk.dt_from_parts(ops, sgk.base_parts(ops, u, v))
        want = T.adaptive_dt(ops, u, v)
        assert got.dtype == want.dtype and got.shape == want.shape == ()
        assert got.numpy().tobytes() == want.numpy().tobytes()

    @pytest.mark.parametrize("n, dtype, corner", CASES)
    def test_card_arithmetic_is_within_ulps(self, n, dtype, corner):
        ops = ops_of(n, dtype, corner)
        for seed in range(3):
            u, v = (torch.as_tensor(x) for x in seeded_fields(n, dtype, seed))
            parts = sgk.base_parts(ops, u, v)
            plain = sgk.dt_from_parts(ops, parts)
            card = sgk.dt_from_parts(ops, parts, kernel=True)
            assert card.dtype == dtype
            assert ulps(card.numpy(), plain.numpy()) <= KERNEL_ULPS

    def test_fma_rounds_once(self):
        f32 = np.float32
        a = f32(1 + 2.0 ** -12)
        # a * a = 1 + 2^-11 + 2^-24: rounded first, the 2^-24 is lost
        assert sgk._fma(a, a, f32(-1), f32) == f32(2.0 ** -11 + 2.0 ** -24)
        assert a * a - f32(1) == f32(2.0 ** -11)
        # just above a float32 tie: rounded to float64 first, it would be
        # the tie, and the tie goes to even
        q = Fraction(1) + Fraction(1, 2 ** 24) + Fraction(1, 2 ** 80)
        assert sgk._round_exact(q, f32) == f32(1 + 2.0 ** -23)
        assert sgk._round_exact(q - Fraction(1, 2 ** 79), f32) == f32(1)
        d = np.float64(1 + 2.0 ** -30)
        assert sgk._fma(d, d, np.float64(-1), np.float64) == np.float64(
            2.0 ** -29 + 2.0 ** -60)

    def test_nan_propagates(self):
        ops = ops_of(12, torch.float32)
        u, v = (torch.as_tensor(x) for x in seeded_fields(12, torch.float32,
                                                          0))
        u[3, 4] = float("nan")
        parts = sgk.base_parts(ops, u, v)
        for kernel in (False, True):
            assert torch.isnan(sgk.dt_from_parts(ops, parts, kernel=kernel))


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here: the card's machine has no JAX."""
    import jax.numpy as jnp
    from anap3_tpu.models import spectral_sg as J
    from anap3_tpu.models.params import SpectralParameters as JaxParameters

    def run(n, dtype, corner, u, v):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        jops = J.build_spectral_ops(JaxParameters(
            Re=400.0, nx=n, ny=n, basis_type="chebyshev", CFL=1.5,
            beta_squared=5.0, corner_treatment=corner, corner_smoothing=0.15,
            dtype="float64" if dtype == torch.float64 else "float32"),
            dtype=jdt)[0]
        ju, jv = jnp.asarray(u), jnp.asarray(v)
        if jops.sing_u is not None:
            ju, jv = ju + jops.sing_u, jv + jops.sing_v
        return (np.asarray(J.adaptive_dt(jops, jnp.asarray(u),
                                         jnp.asarray(v))),
                np.asarray(jnp.max(jnp.abs(ju))),
                np.asarray(jnp.max(jnp.abs(jv))))

    return run


class TestAgainstJax:
    @pytest.mark.parametrize("n, dtype, corner", CASES)
    def test_dt_from_parts_meets_jax(self, jx, n, dtype, corner):
        ops = ops_of(n, dtype, corner)
        for seed in range(3):
            u, v = seeded_fields(n, dtype, seed)
            want, umax, vmax = jx(n, dtype, corner, u, v)
            parts = sgk.base_parts(ops, torch.as_tensor(u),
                                   torch.as_tensor(v))
            got = sgk.dt_from_parts(ops, parts)
            card = sgk.dt_from_parts(ops, parts, kernel=True)
            assert got.numpy().dtype == want.dtype
            assert ulps(got.numpy(), want) <= JAX_ULPS, (seed, got, want)
            assert ulps(card.numpy(), want) <= JAX_ULPS, (seed, card, want)
            if corner == "smoothing":  # the same fields: the same maxima
                assert parts[:, 0].max().numpy() == umax
                assert parts[:, 1].max().numpy() == vmax


class TestHeader:
    def test_counts_follow_the_c_enum(self):
        """The wrappers read the C entries' counts in Count's order."""
        text = (CSRC / "sg_common.cuh").read_text()
        body = re.search(r"enum Count \{([^}]*)\}", text).group(1)
        names = [c.strip() for c in body.split(",") if c.strip()]
        assert names[-1] == "C_COUNT"
        assert len(names) - 1 == len(sgk.KERNELS + sgk.PARTS)
        assert names.index("C_DT") == len(sgk.KERNELS)
        assert len(sgk._new_counts()) == len(names) - 1

    @pytest.mark.parametrize("n_steps", [1, 2, 5, 30])
    def test_smoother_plan(self, n_steps):
        plan = sgk.smoother_launches(n_steps)
        assert sum(plan.values()) == 4 * n_steps + 2
        assert plan["sg_diag"] == 2


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SG kernels have no CPU mode")
    return torch.device("cuda")


LANES = [(100.0, 0.15, 1.5, 5.0), (400.0, 0.10, 1.2, 4.0),
         (1000.0, 0.05, 1.0, 6.0), (3200.0, 0.20, 1.5, 5.0),
         (100.0, 0.08, 1.3, 5.5), (400.0, 0.12, 1.5, 4.5),
         (1000.0, 0.15, 1.1, 5.0), (200.0, 0.03, 1.4, 6.0)]


def card_state(ops, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    nf = ops.nf
    st = T.state_from_numpy(tuple(scale * rng.standard_normal(s) for s in (
        (nf, nf), (nf, nf), (nf - 2, nf - 2))), ops.device, ops.dtype)
    u, v = T.enforce_bc(ops, st.u, st.v)
    return T.SpectralState(u.contiguous(), v.contiguous(), st.p)


def tol_of(dtype):
    return F64_TOL if dtype == torch.float64 else F32_TOL


def rel_t(a, b) -> float:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def dt_launch(ops_list, states, x1=False):
    """One dt_kernel launch on the stacked states of len(ops_list) lanes
    through the bench entry; its scalar table (and with x1 the bf16 copies)."""
    from anap3_tpu_torch.ops import sg_lane_kernels as sgl

    o0, B = ops_list[0], len(ops_list)
    u, v, p = (torch.stack(t).contiguous() for t in zip(*states))
    kw = dict(dtype=o0.dtype, device=o0.device)
    ws = sgk._workspace(
        o0, lanes=B, **sgl._lane_statics(ops_list), u=u, v=v, p=p,
        bu=u.clone(), bv=v.clone(), bp=p.clone(),
        rows=torch.empty((1, B, 7), **kw),
        flags=torch.zeros((B, 3), dtype=torch.int32, device=o0.device),
        ref_norm=torch.full((B,), float("inf"), **kw))
    if x1:
        ws.update(sgk.x1_workspace(o0, lanes=B))
    sgk.reset_counts()
    sgk.bench_kernel(o0, ws, "dt", 1, B, x1=x1)
    torch.cuda.synchronize()
    assert sgk.LAUNCHES == {k: 0 for k in sgk.KERNELS}  # a timing aid
    return ws


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("n", [24, 48, 96, 128, 192, 320])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("lanes", [1, 8])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_dt_kernel_is_dt_from_parts(self, cuda, n, dtype, lanes, corner):
        """Each lane its own scalars and scale (the lid clamp or the
        largest |u| decides); dt bit for bit, the norms to the
        tolerance."""
        ops_list = [ops_of(n, dtype, corner, "cuda", *LANES[b])
                    for b in range(lanes)]
        states = [card_state(o, 10 * n + b, (0.01, 0.3, 3.0)[b % 3])
                  for b, o in enumerate(ops_list)]
        ws = dt_launch(ops_list, states)
        for b, (o, st) in enumerate(zip(ops_list, states)):
            scal = ws["scal"][b]
            want = sgk.dt_from_parts(o, sgk.base_parts(o, st.u, st.v).cpu(),
                                     kernel=True)
            assert bits(scal[0].cpu(), want), (b, scal[0], want)
            assert rel_t(scal[0], T.adaptive_dt(o, st.u, st.v)) <= tol_of(
                dtype)
            assert rel_t(scal[1], (st.u * st.u).sum()) <= tol_of(dtype)
            assert rel_t(scal[2], (st.v * st.v).sum()) <= tol_of(dtype)

    @pytest.mark.parametrize("n", [32, 96, 320])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    def test_x1_dt_kernel_rounds_the_base(self, cuda, n, corner):
        o = ops_of(n, torch.float32, corner, "cuda", Re=1000.0)
        st = card_state(o, n)
        ws = dt_launch([o], [st], x1=True)
        want = sgk.dt_from_parts(o, sgk.base_parts(o, st.u, st.v).cpu(),
                                 kernel=True)
        assert bits(ws["scal"][0, 0].cpu(), want)
        assert bits(ws["x1s"][0, 0], sgk.x1_state_copy(st))

    @pytest.mark.parametrize("n", [24, 96])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    @pytest.mark.parametrize("n_steps", [1, 2, 5, 30])
    def test_smoother_is_its_steps_bit_for_bit(self, cuda, n, dtype, corner,
                                               n_steps):
        """n_steps smoother steps (dt from the last stage's partials after
        the first) against as many make_sg_step calls (dt_kernel every
        step), forced by a tau that is zero on the velocity boundary ring:
        the same state and metrics, in 4 n + 2 launches."""
        ops = ops_of(n, dtype, corner, "cuda", Re=1000.0)
        st = card_state(ops, n, 0.05)
        rng = np.random.default_rng(n_steps)
        ring = ops.interior.to(dtype)
        nf = ops.nf
        tau = tuple(torch.as_tensor(0.01 * rng.standard_normal(s),
                                    dtype=dtype, device=ops.device) * m
                    for s, m in (((nf, nf), ring), ((nf, nf), ring),
                                 ((nf - 2, nf - 2), 1.0)))
        sgk.reset_counts()
        s_k, m_k = sgk.make_sg_smoother(ops)(st, tau, n_steps)
        torch.cuda.synchronize()
        assert sgk.LAUNCHES == dict({k: 0 for k in sgk.KERNELS},
                                    **sgk.smoother_launches(n_steps))
        assert sum(sgk.LAUNCHES.values()) == 4 * n_steps + 2
        assert sgk.PART_LAUNCHES == {"dt_kernel": 1}
        step = sgk.make_sg_step(ops, with_tau=True)
        s_s = st
        for _ in range(n_steps):
            s_s, m_s = step(s_s, tau)
        for a, b in zip(s_k, s_s):
            assert bits(a, b)
        for k in m_s:
            assert bits(m_k[k], m_s[k]), k
