"""The SG step's tail in anap3_tpu_torch: the last stage's in-place commit,
``control_kernel`` and the cooperative ``tail_kernel`` (csrc/sg_stage.cu,
sg_control.cu, sg_diag.cu; ops/sg_kernels.py).

On the CPU (every run): the tail kernel's grid (``tail_grid``,
``tail_block_items``: every (tile, lane) item taken once, never more blocks
than fit on the card at once, a grid that leaves a block too many items
refused), the chunk's launch plan (``chunk_launches``, which the wrappers
hold the C entry's counts to) against the steps on which the plain chunk
takes its quadratures, the plain chunk against the JAX aligned chunk kernel
on those steps, and the constants the Python side shares with the C header.

On a CUDA card (marker ``gpu``): a chunk against the same steps taken one
by one (bit for bit: state, and rows against the step metrics), a lane
converging mid-chunk among three keeping its state at convergence bit for
bit, and the tail at N=400 with 8 lanes (items strided over the blocks)
and in float64 against the plain lanes (<= 1e-4 relative in float32,
<= 1e-11 in float64, flags equal) and against one-lane chunks (bit for
bit). Run them there with
``python -m pytest tests/test_torch_sg_tail.py -m gpu --noconftest``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import runner as TR
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.ops import sg_kernels as sgk
from anap3_tpu_torch.ops import sg_lane_kernels as sgl
from anap3_tpu_torch.parallel.sweep import stack_states

torch.set_num_threads(1)

CSRC = Path(sgk.__file__).resolve().parents[1] / "csrc"
F32_TOL = 1e-4
F64_TOL = 1e-11
# co-resident blocks of a card: 2 and 8 blocks of 256 threads on each of
# an H100's 132 SMs, and a small card
CORESIDENT = (264, 1056, 40)


class TestTailGrid:
    @pytest.mark.parametrize("n", [12, 19, 20, 47, 96, 128, 255, 383, 400,
                                   511, 767])
    @pytest.mark.parametrize("lanes", [1, 2, 3, 8])
    def test_every_item_once_within_the_card(self, n, lanes):
        nf, nt = n + 1, -(-(n + 1) // 16)
        for most in CORESIDENT:
            try:
                blocks = sgk.tail_grid(nf, lanes, most)
            except ValueError:
                # refused only where a block would take too many items
                assert nt * nt * lanes > most * sgk.MAX_TAIL_ITEMS
                continue
            assert lanes <= blocks <= min(most, nt * nt * lanes)
            taken = [it for b in range(blocks)
                     for it in sgk.tail_block_items(nf, lanes, blocks, b)]
            assert sorted(taken) == [(lane, i, j) for lane in range(lanes)
                                     for i in range(nt) for j in range(nt)]
            assert max(len(sgk.tail_block_items(nf, lanes, blocks, b))
                       for b in range(blocks)) <= sgk.MAX_TAIL_ITEMS
            # one block an item wherever the card holds them all
            if nt * nt * lanes <= most:
                assert blocks == nt * nt * lanes
        # an H100 takes every order the kernels take, 8 lanes included
        assert sgk.tail_grid(nf, lanes, 264) >= 1

    def test_refuses_a_grid_it_cannot_launch(self):
        with pytest.raises(ValueError, match="more than 128 a block"):
            sgk.tail_grid(768, 8, 100)
        with pytest.raises(RuntimeError, match="cooperative launch"):
            sgk.tail_grid(129, 1, 0)
        # block b finishes lane b
        with pytest.raises(RuntimeError, match="a block a lane"):
            sgk.tail_grid(21, 8, 7)
        # the largest load that still fits a block
        assert sgk.tail_grid(768, 8, 144) == 144

    def test_items_follow_the_kernel_order(self):
        # block b takes items b, b + grid, ...: lane-major, tile rows, then
        # tile columns (csrc/sg_diag.cu:tail_kernel)
        assert sgk.tail_block_items(33, 2, 5, 1) == [
            (0, 0, 1), (0, 2, 0), (1, 0, 2), (1, 2, 1)]


def plain_sampled_steps(monkeypatch, chunk, start, every):
    """The steps on which ``chunk_plain`` takes its quadratures."""
    steps, sampled = [], []
    rk4, quadratures = T.rk4_step, T.conserved_quantities

    def step(*a, **kw):
        steps.append(None)
        return rk4(*a, **kw)

    def quad(*a, **kw):
        sampled.append(len(steps) - 1)
        return quadratures(*a, **kw)

    monkeypatch.setattr(T, "rk4_step", step)
    monkeypatch.setattr(T, "conserved_quantities", quad)
    ops = T.build_spectral_ops(SpectralParameters(
        Re=100.0, nx=6, ny=6, dtype="float64", device="cpu"))[0]
    sgk.chunk_plain(ops, T.initial_state(ops), start, np.inf, chunk, 1e-30,
                    10, False, every)
    assert len(steps) == chunk
    return sampled


class TestLaunchPlan:
    @pytest.mark.parametrize("chunk,start,every", [
        (20, 0, 16), (20, 5, 16), (1, 7, 16), (33, 16, 16), (40, 3, 1),
        (17, 31, 4), (5, 100, 1000)])
    def test_sampled_steps_are_the_plain_chunks(self, monkeypatch, chunk,
                                                start, every):
        sampled = plain_sampled_steps(monkeypatch, chunk, start, every)
        assert sampled == [i for i in range(chunk)
                           if i == 0 or (start + i) % every == 0]
        plan = sgk.chunk_launches(chunk, start, every)
        # four stages a step, dt once a chunk, one tail a step: the tail
        # kernel where the plain chunk samples, control elsewhere
        assert plan == {"sg_stage": 4 * chunk,
                        "sg_diag": 1 + len(sampled),
                        "sg_control": chunk - len(sampled)}
        assert sum(plan.values()) == 5 * chunk + 1

    def test_the_counts_are_held_to_the_plan(self):
        sgk._check_launches((80, 3, 18), 20, 0, 16)
        with pytest.raises(RuntimeError, match="planned"):
            sgk._check_launches((80, 22, 20), 20, 0, 16)

    def test_the_counters_cover_the_chunk_tail(self):
        # a 20-step chunk from 0 at cadence 16: samples at i = 0 and idx = 16
        assert sgk.chunk_launches(20, 0, 16) == {
            "sg_stage": 80, "sg_diag": 3, "sg_control": 18}


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here: the card's machine has no JAX."""
    import jax.numpy as jnp
    from anap3_tpu.models import spectral_sg as J
    from anap3_tpu.models.params import SpectralParameters as JaxParameters
    from anap3_tpu.ops.pallas_aligned import make_aligned_chunk_runner

    return J, JaxParameters, jnp, make_aligned_chunk_runner


class TestAgainstJax:
    def test_held_quadratures_follow_the_aligned_cadence(self, jx):
        """From a start that is no multiple of the cadence, the port's plain
        chunk (the kernels' reference, whose sampled steps the launch plan
        follows) and the JAX aligned chunk kernel (interpret mode, x6)
        sample their quadratures on the same steps, to the same values
        (float32, 1e-4), and hold them between."""
        J, JP, jnp, aligned = jx
        jops = J.build_spectral_ops(JP(
            Re=400.0, nx=32, ny=32, dtype="float32", basis_type="chebyshev",
            CFL=1.5), dtype=jnp.float32)[0]
        chunk, every, start = 20, 16, 13
        jst = J.initial_state(jops)
        rows_j = np.asarray(aligned(
            jops, chunk, 1e-30, 10, interpret=True, algorithm="x6",
            metrics_every=every)(jst, jnp.int32(start),
                                 jnp.float32(np.inf))[4])
        ops = T.ops_from_jax(jops, "cpu", torch.float32)
        st = T.state_from_numpy(jst, "cpu", torch.float32)
        rows_t = sgk.chunk_plain(ops, st, start, np.inf, chunk, 1e-30, 10,
                                 False, every)[4].numpy()
        sampled = [i for i in range(chunk)
                   if i == 0 or (start + i) % every == 0]
        for i in sampled:
            for c in (4, 5, 6):
                assert abs(rows_t[i, c] - rows_j[i, c]) <= F32_TOL * max(
                    abs(rows_j[i, c]), 1e-30), (i, c)
        assert sampled == [0, 3, 19]
        for rows in (rows_t, rows_j):
            for i in range(1, chunk):
                held = i not in sampled
                assert (rows[i, 4:] == rows[i - 1, 4:]).all() == held, i


class TestHeader:
    def test_constants_match_the_c_header(self):
        text = (CSRC / "sg_common.cuh").read_text()
        for name, value in (("NPART", sgk._NPART), ("NDPART", sgk._NDPART),
                            ("NQPART", sgk._NQPART),
                            ("MAX_TAIL_ITEMS", sgk.MAX_TAIL_ITEMS)):
            assert int(re.search(r"constexpr int " + name + r" = (\d+);",
                                 text).group(1)) == value, name
        assert "P_DPART" in text and "dpart" in sgk._PTR_NAMES

    def test_the_tail_is_one_launch_and_moves_no_state(self):
        control = (CSRC / "sg_control.cu").read_text()
        diag = (CSRC / "sg_diag.cu").read_text()
        for gone in ("omega_kernel", "grad_kernel", "step_finish_kernel",
                     "launch_quadratures"):
            assert gone not in control + diag, gone
        code = re.sub(r"//.*", "", control)
        assert "u_new" not in code and "[k] =" not in code
        assert "cudaLaunchAttributeCooperative" in diag
        assert len(re.findall(r"grid\.sync\(\)", diag)) == 2


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SG kernels have no CPU mode")
    return torch.device("cuda")


def card_ops(n, dtype, Re=1000.0, corner="smoothing", cs=0.15, cfl=1.5,
             beta=5.0):
    return T.build_spectral_ops(SpectralParameters(
        Re=Re, nx=n, ny=n, basis_type="chebyshev", CFL=cfl,
        beta_squared=beta, corner_treatment=corner, corner_smoothing=cs,
        device="cuda",
        dtype="float64" if dtype == torch.float64 else "float32"))[0]


def bits(a, b) -> bool:
    """Equal bits, NaN where NaN."""
    return a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def rel_t(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    fin = torch.isfinite(b)
    assert torch.equal(fin, torch.isfinite(a))
    scale = float(b[fin].abs().max()) if bool(fin.any()) else 1.0
    return float((a[fin] - b[fin]).abs().max()) / max(scale, 1e-300)


LANES = [(100.0, 0.15, 1.5, 5.0), (400.0, 0.10, 1.2, 4.0),
         (1000.0, 0.05, 1.0, 6.0), (3200.0, 0.20, 1.5, 5.0),
         (100.0, 0.08, 1.3, 5.5), (400.0, 0.12, 1.5, 4.5),
         (1000.0, 0.15, 1.1, 5.0), (200.0, 0.03, 1.4, 6.0)]


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("n", [20, 96])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    @pytest.mark.parametrize("every", [1, 16])
    def test_chunk_is_its_steps_bit_for_bit(self, cuda, n, dtype, corner,
                                            every):
        """A 20-step chunk (dt from the tails, state committed in place)
        against 20 make_sg_step calls (dt_kernel every step, out of
        place): the same states and, in rows columns 1-6, the step
        metrics where the chunk sampled."""
        ops = card_ops(n, dtype, corner=corner)
        st = T.initial_state(ops)
        out = sgk.make_sg_chunk_runner(ops, 20, 1e-30, 10, "rel_iter",
                                       every)(st, 0, np.inf)
        step = sgk.make_sg_step(ops)
        keys = ("u_eq", "v_eq", "continuity", "energy", "enstrophy",
                "palinstrophy")
        s = st
        for i in range(20):
            s, m = step(s)
            cols = range(1, 7) if i == 0 or i % every == 0 else range(1, 4)
            for c in cols:
                assert bits(out[4][i, c], m[keys[c - 1]]), (i, c)
        for a, b in zip(out[0], s):
            assert bits(a, b)
        assert [int(out[k]) for k in (1, 2, 3)] == [0, -1, 0]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_a_lane_converging_mid_chunk_keeps_its_state(self, cuda, dtype):
        """Of three lanes, the first meets the tolerance mid-chunk: its
        state is the one it reached at convergence, bit for bit (the last
        stage of every later step stores nothing for it), and the others
        run on as their one-lane chunks."""
        ops = [card_ops(20, dtype, Re, cs=cs, cfl=cfl, beta=beta)
               for Re, cs, cfl, beta in LANES[:3]]
        st = stack_states([T.initial_state(o) for o in ops])
        probe = sgl.lanes_plain(ops, st, 0, TR.fresh_carry(3, dtype, cuda),
                                40, 1e-30, 10, False, 1)[2].cpu().numpy()
        tol = float(probe[14:22, 0, 0].min()) * (1 + 1e-3)
        assert (probe[14:22, 1:, 0] > tol).all()
        out = sgl.make_lane_chunk_runner(ops, 40, tol)(st, 0)
        flags = out[1].flags.tolist()
        assert flags[0][0] == 1 and flags[0][2] == 1
        k = flags[0][1]
        # the others run past it (they may meet the tolerance later)
        assert 15 <= k <= 22
        assert all(f[0] == 0 or f[1] > k for f in flags[1:])
        assert torch.isnan(out[2][k:, 0]).all()
        lane0 = T.SpectralState(*(t[0] for t in st))
        at_conv = sgk.make_sg_chunk_runner(ops[0], k, 1e-30, 10, "rel_iter",
                                           1)(lane0, 0, np.inf)
        for a, c in zip(out[0], at_conv[0]):
            assert bits(a[0], c)
        for b in (1, 2):
            one = sgk.make_sg_chunk_runner(ops[b], 40, tol, 10, "rel_iter",
                                           1)(
                T.SpectralState(*(t[b] for t in st)), 0, np.inf)
            for a, c in zip(out[0], one[0]):
                assert bits(a[b], c)
            assert bits(out[2][:, b], one[4])
            assert flags[b] == [int(one[i]) for i in (1, 2, 3)]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_tail_at_n400_with_8_lanes(self, cuda, dtype):
        """N=400, 8 lanes: 5,408 (tile, lane) items, more than the card
        holds blocks, so the blocks stride over them. Rows and states
        against the plain lanes; every lane against its one-lane chunk."""
        ops = [card_ops(400, dtype, Re, cs=cs, cfl=cfl, beta=beta)
               for Re, cs, cfl, beta in LANES]
        items = 26 * 26 * 8
        st = stack_states([T.initial_state(o) for o in ops])
        out = sgl.make_lane_chunk_runner(ops, 3, 1e-30)(st, 0)
        torch.cuda.synchronize()
        assert sgk._CORESIDENT[0 if dtype == torch.float32 else 1] < items
        plain = sgl.lanes_plain(ops, st, 0, TR.fresh_carry(8, dtype, cuda),
                                3, 1e-30, 10, False, 1)
        tol = F64_TOL if dtype == torch.float64 else F32_TOL
        for a, b in zip(out[0], plain[0]):
            assert rel_t(a, b) <= tol
        for c in range(7):
            assert rel_t(out[2][:, :, c], plain[2][:, :, c]) <= tol, c
        assert torch.equal(out[1].flags, plain[1].flags)
        for b in (0, 5):
            one = sgk.make_sg_chunk_runner(ops[b], 3, 1e-30, 10, "rel_iter",
                                           1)(
                T.SpectralState(*(t[b] for t in st)), 0, np.inf)
            for a, c in zip(out[0], one[0]):
                assert bits(a[b], c)
            assert bits(out[2][:, b], one[4])
