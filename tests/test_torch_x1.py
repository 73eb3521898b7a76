"""``matmul_algorithm=x1`` of the port: one bf16 pass a product.

On the CPU (every run): the plain x1 chunk of ``ops/sg_kernels.py``
(``chunk_plain(..., hi=x1_operators(ops))``) against the JAX package's x1
mode, ``anap3_tpu/ops/pallas_aligned.py:make_aligned_chunk_runner(...,
interpret=True, algorithm="x1", metrics_every=16)``, float32, at N = 32
and 40, smoothed and singular lids, Re 100 and 1000. Both round the same
float32 values to bf16 and form exact products, so they differ in the
float32 sum order alone, and the bound is TOL = 1e-5 relative on u, v, p
and each row column, flags equal. A sum-order difference can move a
value across a bf16 rounding midpoint, though: that element then rounds
one bf16 step (2^-8 relative) away from JAX's, the Chebyshev operators
carry it into whole lines, and the steps after it amplify it (a seeded
state drifts to ~1e-3 over 16 steps, as far as two plain x1 chunks from
starts one float32 ulp apart do). Where that happens is set by the
host's sum order, not by the port. So the trajectories are held by rule
1, and no trajectory is compared across 16 amplifying steps:

- Rule 1, a port step from JAX's own state: within TOL of JAX's step;
  or else the excess is a bf16 rounding taken on the other side: at most
  MAX_FLIPS rounded elements, each within FLIP_ULPS float32 ulps of its
  bf16 rounding midpoint, whose roundings flipped bring the step within
  TOL (``X1Step``: the step of ``chunk_plain`` rebuilt from
  ``stage_x1_plain``, its roundings through a hook, bit-equal to it when
  it flips nothing). The rounded arrays are the ones the x1 products
  read: the state each RK stage starts from (the base, stages 1-3: u, v,
  p) with its pressure intermediates Gx p and Ix p, and in the
  quadrature pass the step's u and v and omega. At most
  MAX_FLIPPED_STEPS steps of a 16-step trajectory may need a flip. Each
  accepted flip is printed (run with ``-s``): the step, the state, the
  array, the element, its ulps from the midpoint, the distance before
  and after.
- ``test_one_step``: one step from a seeded white-noise state, within
  TOL.
- ``test_sixteen_steps_step_by_step``: rule 1 at each step of JAX's
  16-step trajectory from a seeded smooth state.
- ``test_sixteen_step_chunk_from_rest``: the port's 16-step chunk is
  bit-equal to its chain of 16 one-step chunks (rows at the sampled
  cadence); JAX's 16-step chunk is bit-equal to its chain of one-step
  runs; rule 1 at each step of that chain.
- ``TestX1Mutants``: rule 1 refuses, on both trajectories of every case,
  each of three wrong x1 versions of the port: the border term k = N
  rounded to bf16, Dx's hi half left in float32, and stage 3's state
  read unrounded by the last stage's products.

Readings on an 8-core Intel Xeon (Sapphire Rapids, amx_bf16): one step
3.6e-7 at most. Unflipped, the worst step of the 12 trajectories that
need no flip reads 6.7e-7 to 9.4e-6 (N=40 smoothing Re=100, seeded).
Four steps need one flip each, in four trajectories: N=32 smoothing
Re=100 seeded, step 12, 3.79e-5 on row column 2 (the norm of R_v),
stage 2's v (10, 31), 18 ulps from its midpoint, to 3.6e-7; N=32
smoothing Re=1000 seeded, step 12, 1.004e-5 on p, stage 1's Gx p
(1, 30), 294 ulps, to 9.7e-7; N=32 singular Re=1000 seeded, step 6,
1.96e-5 on u, stage 3's Gx p (1, 4), 2 ulps, to 2.1e-7; N=32 singular
Re=100 from rest, step 3, 5.16e-5 on row column 6 (the palinstrophy),
the quadratures' omega (23, 31), 1 ulp, to 4.5e-7. A flip in the
pressure intermediates or in the quadratures' omega explains three of
the four; the nearest flip of a stage state alone needs 1,333 ulps for
one of them. An earlier host needed no flip: step by step <= 1.2e-6,
the whole 16-step chunk from rest <= 7.1e-6. The mutants are refused at
their first step, 6.9e-4 to 0.20 from JAX's.

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
from contextlib import contextmanager
from itertools import combinations
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import spectral as TSP
from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.models.runner import control_step, freeze, rel_change
from anap3_tpu_torch.ops import sg_kernels as sgk

torch.set_num_threads(1)

TOL = 1e-5
CASES = [(n, corner, re) for n in (32, 40)
         for corner in ("smoothing", "singular") for re in (100.0, 1000.0)]
INF = float("inf")
# Rule 1 (the module docstring). The port and JAX round an element to the
# two bf16 values either side of it only where the midpoint between them
# lies between their two float32 sums, so no further from the port's value
# than the sums' difference. That difference scales with the terms of the
# sum, not with the element, which can cancel: the readings' largest is
# 294 ulps of the element (a Gx p element of -0.446 whose row of products
# reaches 11.2, N=32 smoothing Re=1000), and FLIP_ULPS is the next power
# of two. A bf16 step is 65,536 float32 ulps, so ~1.6% of the rounded
# elements are candidates.
FLIP_ULPS = 512
# elements flipped in one step, and steps of a 16-step trajectory with a
# flip: the readings need one of each
MAX_FLIPS = 1
MAX_FLIPPED_STEPS = 1


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

    chains = {}

    def trajectory(n, corner, re, start):
        """JAX's chain of 16 one-step runs from the seeded smooth state
        (``start`` "seeded") or from rest ("rest"): its 17 states and 16
        outputs."""
        if (n, corner, re, start) not in chains:
            jops, ops, _, nodes = case(n, corner, re)
            st = (seeded_state(ops, nodes, 7 * n + int(re), smooth=True)
                  if start == "seeded" else T.initial_state(ops))
            states, outs = [st], []
            for k in range(16):
                js, jout = run(jops, (n, corner, re), 1, states[-1], k)
                states.append(js)
                outs.append(jout)
            chains[(n, corner, re, start)] = (states, outs)
        return chains[(n, corner, re, start)]

    return SimpleNamespace(case=case, run=run, trajectory=trajectory)


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


# ------------------------------------------------------------ bf16 flips

BF16_HALF = 0x8000  # float32 ulps from a bf16 value to the next midpoint


def bf16_sides(x):
    """For float32 ``x``: the bf16 value it rounds to (to nearest, ties to
    even), the other bf16 neighbour, and x's distance from the midpoint
    between them in float32 ulps. By the bits: the high 16 are the bf16
    value truncated toward zero, the low 16 the rest."""
    bits = x.contiguous().view(torch.int32)
    low = bits & 0xFFFF
    down = bits - low
    up = down + 0x10000
    odd = ((down >> 16) & 1).bool()
    go_up = (low > BF16_HALF) | ((low == BF16_HALF) & odd)
    near = torch.where(go_up, up, down).view(torch.float32)
    far = torch.where(go_up, down, up).view(torch.float32)
    return near, far, (low - BF16_HALF).abs()


# the states the passes of a step round, by pass: the products of RK
# stages 1-4 read the base and the states of stages 1-3, the quadrature
# pass the step's state
PASSES = ("base", "stage 1", "stage 2", "stage 3", "quadratures")
# the intermediates a pass rounds, in the order it first rounds them
_INTERMEDIATES = {"stage": ("Gx p", "Ix p"), "quadratures": ("omega",)}


class StepRounding:
    """``sg_kernels.bf16_round`` during one plain x1 step from pass
    ``first`` on: names each rounded array by its pass and name, records
    the elements a pass rounds (``record``), and takes the other side
    (``bf16_sides``) at ``flips``, ((pass, name, (i, j)), ...).
    ``unrounded``: passes whose state u, v, p enters the products in
    float32 (a mutant)."""

    def __init__(self, flips=(), unrounded=(), first=0, record=False):
        self.flips = {}
        for at, name, ij in flips:
            self.flips.setdefault((at, name), []).append(ij)
        self.unrounded = set(unrounded)
        self.record = record
        self.rounded = {}  # (pass, name) -> (array, elements rounded)
        self.at = first - 1
        self.inside = False

    def enter(self, kind, **state):
        """A pass begins: ``state`` its u, v (and p)."""
        self.at += 1
        self.inside = True
        self.names = {t.data_ptr(): (name, t) for name, t in state.items()}
        self.intermediates = list(_INTERMEDIATES[kind])

    def __call__(self, x):
        near = x.to(torch.bfloat16).to(x.dtype)
        if not self.inside:
            return near
        # x is an array of the pass or a slice of it from its start
        if x.data_ptr() not in self.names:
            whole = x if x._base is None else x._base
            self.names[x.data_ptr()] = (self.intermediates.pop(0), whole)
        name, whole = self.names[x.data_ptr()]
        offset = x.storage_offset() - whole.storage_offset()

        def part(mask):
            return mask.as_strided(x.shape, x.stride(), offset)
        key = (self.at, name)
        if self.record:
            if key not in self.rounded:
                self.rounded[key] = (whole, torch.zeros(whole.shape,
                                                        dtype=torch.bool))
            part(self.rounded[key][1]).fill_(True)
        if name in ("u", "v", "p") and self.at in self.unrounded:
            return x.clone()
        if key not in self.flips:
            return near
        mask = torch.zeros(whole.shape, dtype=torch.bool)
        for ij in self.flips[key]:
            mask[ij] = True
        return torch.where(part(mask), bf16_sides(x)[1], near)


@contextmanager
def rounding_hook(rounding):
    """The plain x1 arithmetic of ``sg_kernels`` with its bf16 roundings
    through ``rounding``: each ``x1_residuals`` call (an RK stage's
    products) and each ``x1_conserved_quantities`` call (the quadratures)
    is a pass."""
    residuals = sgk.x1_residuals
    quadratures = sgk.x1_conserved_quantities
    bf16_round = sgk.bf16_round

    def stage(ops, hi, u, v, p):
        rounding.enter("stage", u=u, v=v, p=p)
        try:
            return residuals(ops, hi, u, v, p)
        finally:
            rounding.inside = False

    def quad(ops, hi, u, v):
        rounding.enter("quadratures", u=u, v=v)
        try:
            return quadratures(ops, hi, u, v)
        finally:
            rounding.inside = False
    sgk.x1_residuals, sgk.x1_conserved_quantities = stage, quad
    sgk.bf16_round = rounding
    try:
        yield rounding
    finally:
        sgk.x1_residuals, sgk.x1_conserved_quantities = residuals, quadratures
        sgk.bf16_round = bf16_round


class X1Step:
    """``chunk_plain``'s one x1 step from ``state`` at global step ``k``,
    rebuilt from the plain x1 stage (``sg_kernels.stage_x1_plain``, four
    stages from the base at alpha dt, as ``x1_rk4_step``), the quadratures
    and ``chunk_body``'s row and flags, its bf16 roundings through a
    ``StepRounding``. ``out`` is chunk_plain's output (bit for bit,
    ``TestFlipHelper``); ``run(flips)`` runs the step with those roundings
    flipped, from the first pass a flip is in, on the states the passes
    before it left; ``candidates()`` are the elements a flip may take."""

    def __init__(self, ops, hi, state, k, unrounded=()):
        self.ops, self.hi, self.state, self.k = ops, hi, state, k
        self.unrounded = unrounded
        self.dt = T.adaptive_dt(ops, state.u, state.v)
        self.states, self.res = [state], None
        self.rounding = StepRounding(unrounded=unrounded, record=True)
        self.out = self._run(self.rounding, 0)

    def run(self, flips, first=None):
        """The step's output with ``flips`` taken on the other side, from
        pass ``first`` (the first flip's when None) on."""
        if first is None:
            first = min(at for at, _, _ in flips)
        return self._run(StepRounding(flips, self.unrounded, first), first)

    def _run(self, rounding, first):
        ops, hi = self.ops, self.hi
        states, res = self.states[:first + 1], self.res
        with rounding_hook(rounding):
            for s in range(first, 4):
                adt = T.RK4_ALPHAS[s] * self.dt
                new, res = sgk.stage_x1_plain(ops, hi, *states[s],
                                              *self.state, adt)
                states.append(new)
            held = torch.stack(sgk.x1_conserved_quantities(
                ops, hi, states[4].u, states[4].v))
        if rounding.record:
            self.states, self.res = states, res
        new, base = states[4], self.state
        rel = torch.maximum(rel_change(new.u, base.u),
                            rel_change(new.v, base.v))
        row = torch.cat([torch.stack([rel] + [torch.linalg.norm(r)
                                              for r in res]), held])
        false = torch.zeros((), dtype=torch.bool)
        row, done, conv_iter, converged, ref_norm = control_step(
            row, self.k, false, torch.full((), -1, dtype=torch.int32), false,
            torch.as_tensor(INF, dtype=ops.dtype), 1e-30, 10, False)
        return (freeze(false, base, new), done, conv_iter, converged,
                row[None], ref_norm)

    def candidates(self, ulps=FLIP_ULPS):
        """The rounded elements within ``ulps`` of their bf16 midpoint,
        nearest first: (ulps, pass, name, (i, j)). The boundary values of
        u and v are left out: the BCs, the same constants on both sides."""
        out = []
        for (at, name), (whole, rounded) in self.rounding.rounded.items():
            dist = bf16_sides(whole)[2]
            near = rounded & (dist <= ulps)
            if name in ("u", "v"):
                near[[0, -1]] = False
                near[:, [0, -1]] = False
            out += [(int(dist[i, j]), at, name, (i, j))
                    for i, j in torch.nonzero(near).tolist()]
        return sorted(out)


def step_distance(out, want_state, want_out):
    """(the largest rel over u, v, p and the row's columns, where); inf
    where the flags differ."""
    if flags(out) != flags(want_out):
        return INF, "flags"
    trow, jrow = out[4][0].numpy(), np.asarray(want_out[4])[0]
    d = [(rel(a, b), f) for a, b, f in zip(out[0], want_state, "uvp")]
    return max(d + [(rel(trow[c], jrow[c]), f"row column {c}")
                    for c in range(7)])


def hold_step(step, want_state, want_out):
    """Rule 1 for the X1Step ``step`` against JAX's step from the same
    state: (flips, distance, distance flipped). flips is () where the step
    is within TOL as it is, the fewest candidates (at most MAX_FLIPS)
    whose flip brings it within TOL, or None: refused."""
    d = step_distance(step.out, want_state, want_out)
    if d[0] <= TOL:
        return (), d, d
    found = step.candidates()
    for size in range(1, MAX_FLIPS + 1):
        for group in combinations(found, size):
            flipped = step_distance(step.run([c[1:] for c in group]),
                                    want_state, want_out)
            if flipped[0] <= TOL:
                return group, d, flipped
    return None, d, d


def hold_trajectory(make_step, states, outs):
    """Rule 1 at each step k of JAX's trajectory (``make_step(states[k],
    k)``, an X1Step, against states[k + 1] and outs[k]), up to the first
    refused step: the steps that needed a flip and the refused one, as (k,
    flips, distance, distance flipped), and whether the trajectory
    passes."""
    flipped = []
    for k in range(len(outs)):
        verdict = (k,) + hold_step(make_step(states[k], k), states[k + 1],
                                   outs[k])
        if verdict[1] is None:
            return flipped + [verdict], False
        if verdict[1]:
            flipped.append(verdict)
    return flipped, len(flipped) <= MAX_FLIPPED_STEPS


def report(where, verdicts):
    """One line a step that needed a flip or was refused."""
    lines = []
    for k, group, d, after in verdicts:
        head = f"{where}: step {k}: {d[0]:.3e} ({d[1]}) over {TOL:g}"
        if group is None:
            lines.append(f"{head}; refused: no {MAX_FLIPS} flip(s) within "
                         f"{FLIP_ULPS} ulps explain it")
            continue
        what = "; ".join(f"{PASSES[at]} {name} {ij}, {ulps} ulps from its "
                         f"bf16 midpoint" for ulps, at, name, ij in group)
        lines.append(f"{head}; flipped {what}: {after[0]:.3e} ({after[1]})")
    return lines


def port_step(ops, hi, unrounded=()):
    return lambda state, k: X1Step(ops, hi, state, k, unrounded)


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
        """Rule 1 at each step of JAX's 16-step x1 trajectory from a
        seeded smooth state."""
        _, ops, hi, _ = jx.case(n, corner, re)
        states, outs = jx.trajectory(n, corner, re, "seeded")
        verdicts, ok = hold_trajectory(port_step(ops, hi), states, outs)
        lines = report(f"N={n} {corner} Re={re:g} seeded", verdicts)
        print("\n".join(lines))
        assert ok, lines

    @pytest.mark.parametrize("n,corner,re", CASES)
    def test_sixteen_step_chunk_from_rest(self, jx, n, corner, re):
        """The 16-step x1 chunk from rest (every solve's start): the
        port's chunk bit-equal to its chain of one-step chunks (u, v, p,
        flags, rows columns 0-3 every step, 4-6 where the chunk sampled
        them), JAX's chunk bit-equal to JAX's chain, and rule 1 at each
        step of that chain."""
        jops, ops, hi, _ = jx.case(n, corner, re)
        rest = T.initial_state(ops)
        chunk = sgk.chunk_plain(ops, rest, 0, INF, 16, 1e-30, 10, False, 16,
                                hi=hi)
        st, rows = rest, []
        for k in range(16):
            out = sgk.chunk_plain(ops, st, k, INF, 1, 1e-30, 10, False, 16,
                                  hi=hi)
            st = out[0]
            rows.append(out[4][0])
        assert all(torch.equal(a, b) for a, b in zip(chunk[0], st))
        assert flags(chunk) == flags(out)
        rows = torch.stack(rows)
        assert torch.equal(chunk[4][:, :4], rows[:, :4])
        assert torch.equal(chunk[4][0], rows[0])  # the sampled step

        states, outs = jx.trajectory(n, corner, re, "rest")
        js, jout = jx.run(jops, (n, corner, re), 16, rest, 0)
        assert all(torch.equal(a, b) for a, b in zip(js, states[-1]))
        assert flags(jout) == flags(outs[-1])

        verdicts, ok = hold_trajectory(port_step(ops, hi), states, outs)
        lines = report(f"N={n} {corner} Re={re:g} from rest", verdicts)
        print("\n".join(lines))
        assert ok, lines

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


class TestFlipHelper:
    """``X1Step``, the plain x1 step that rule 1 flips roundings in."""

    def test_rounding_by_the_bits(self):
        """bf16_sides rounds as torch does (to nearest even, ties
        included); the other side is the bf16 neighbour one step away
        across x; the distance is the low bits' from 0x8000."""
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.standard_normal(4096) * 10.0 ** rng.integers(
            -6, 6, 4096), dtype=torch.float32)
        bits = x.view(torch.int32)
        x[:64] = ((bits[:64] & ~0xFFFF) | BF16_HALF).view(torch.float32)
        near, far, dist = bf16_sides(x)
        assert torch.equal(near, x.to(torch.bfloat16).float())
        assert torch.equal((x - near).sign() * (far - x).sign() >= 0,
                           torch.ones_like(x, dtype=torch.bool))
        step = (far.view(torch.int32) - near.view(torch.int32)).abs()
        assert torch.equal(step, torch.full_like(step, 0x10000))
        assert dist[:64].eq(0).all() and dist.max() <= BF16_HALF

    @pytest.mark.parametrize("n,corner,re", CASES)
    def test_no_flip_is_chunk_plain(self, jx, n, corner, re):
        """Flipping nothing, X1Step is chunk_plain's step bit for bit
        (state, flags, row) from the seeded smooth state and from rest, and
        it sees every pass; a flip of the largest u of stage 3's state moves
        the step (one of the base's can vanish in u0 + adt R: dt is small);
        a flip run from its own pass is the run from the base."""
        _, ops, hi, _ = jx.case(n, corner, re)
        for start in ("seeded", "rest"):
            st = jx.trajectory(n, corner, re, start)[0][0]
            want = sgk.chunk_plain(ops, st, 0, INF, 1, 1e-30, 10, False, 16,
                                   hi=hi)
            step = X1Step(ops, hi, st, 0)
            assert all(torch.equal(a, b) for a, b in zip(step.out[0], want[0]))
            assert flags(step.out) == flags(want)
            assert torch.equal(step.out[4], want[4])
            assert sorted(step.rounding.rounded) == sorted(
                [(at, name) for at in range(4)
                 for name in ("u", "v", "p", "Gx p", "Ix p")]
                + [(4, name) for name in ("u", "v", "omega")])
            inner = step.states[3].u[1:-1, 1:-1].abs()
            i, j = divmod(int(torch.argmax(inner)), inner.shape[1])
            moved = step.run([(3, "u", (i + 1, j + 1))])
            assert not torch.equal(moved[0].u, want[0].u)
            for _, at, name, ij in step.candidates()[:8]:
                late, early = step.run([(at, name, ij)]), step.run(
                    [(at, name, ij)], first=0)
                assert all(torch.equal(a, b) for a, b in zip(late[0],
                                                              early[0]))
                assert torch.equal(late[4], early[4])


# ------------------------------------------------------------ mutants


def _bf16(t):
    """``t`` rounded to bf16 past the rounding hook (a mutant's own)."""
    return t.to(torch.bfloat16).to(t.dtype)


def left_border_in_bf16(hi_op, op, w, exact_border_column, tc=False):
    """``sg_kernels.x1_left`` with its border term k = N in bf16."""
    n = w.shape[0] - 1
    out = hi_op @ sgk.bf16_round(w[:n]) + _bf16(op[:, n:]) @ _bf16(w[n:])
    if exact_border_column:
        out[:, n] = (op.double() @ w[:, n].double()).to(out.dtype)
    else:
        out[n, n] = op[n] @ w[:, n]
    return out


def right_border_in_bf16(w, hi_opT, opT, exact_border_row, tc=False):
    """``sg_kernels.x1_right`` with its border term k = N in bf16."""
    n = w.shape[1] - 1
    out = sgk.bf16_round(w[:, :n]) @ hi_opT + _bf16(w[:, n:]) @ _bf16(opT[n:])
    if exact_border_row:
        out[n] = (w[n].double() @ opT.double()).to(out.dtype)
    else:
        out[n, n] = w[n] @ opT[:, n]
    return out


MUTANTS = ("border term in bf16", "Dx hi in float32",
           "stage 3 state unrounded")


class TestX1Mutants:
    """Rule 1 is no looser than a fixed TOL where it matters: it refuses
    wrong x1 versions of the port on both trajectories of every case."""

    @pytest.mark.parametrize("n,corner,re", CASES)
    @pytest.mark.parametrize("mutant", MUTANTS)
    def test_rule_one_refuses(self, jx, monkeypatch, mutant, n, corner, re):
        """The border term k = N of every velocity product rounded to bf16
        (``x1_left``, ``x1_right``); Dx's hi half left in float32; the
        state of stage 3 read unrounded by the last stage's products."""
        _, ops, hi, _ = jx.case(n, corner, re)
        unrounded = ()
        if mutant == "border term in bf16":
            monkeypatch.setattr(sgk, "x1_left", left_border_in_bf16)
            monkeypatch.setattr(sgk, "x1_right", right_border_in_bf16)
        elif mutant == "Dx hi in float32":
            hi = hi._replace(Dx=ops.Dx[:, :ops.nf - 1].clone())
        else:
            unrounded = (3,)

        for start in ("seeded", "rest"):
            states, outs = jx.trajectory(n, corner, re, start)
            verdicts, ok = hold_trajectory(port_step(ops, hi, unrounded),
                                           states, outs)
            lines = report(f"{mutant}: N={n} {corner} Re={re:g} {start}",
                           verdicts)
            print("\n".join(lines))
            assert not ok, lines


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
                                "sg_diag_x1": 2, "sg_resident": 0}
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
