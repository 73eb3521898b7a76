"""The resident SG chunk kernel (csrc/sg_resident.cu) and its dispatch
(ops/sg_kernels.py:resident_geometry).

On the CPU (every run): the resident geometry of every order N = 2..767
in float32 and float64, for 1, 8, 32 and 128 lanes, with and without x1,
is a launch shape (a block a row band of the stage geometry, a sub-block a
column tile) exactly at the orders up to ``RESIDENT_MAX_N``, and None
elsewhere (x1 always), pinned by a digest; the resident chunk's launch
plan (one launch) and its check; the new launch counters; and the chunk
runners' dispatch, which
takes the resident C entry wherever the geometry exists and the
multi-launch entry otherwise (a fake library stands in for the card's).

On a CUDA card (marker ``gpu``): the C entry's geometry
(``sg_resident_geometry``, from csrc/sg_common.cuh:res_layout) exists at
exactly the orders ``resident_geometry`` takes, with its cluster and
sub-blocks, in both dtypes; the resident entry against the
multi-launch entry, called directly on the same workspace, bit for bit in
every output (state, flags, rows, residual normalization): N = 12, 20,
24, 40, 48, 51 in float32 and N = 8, 20, 24, 31 in float64, 1 and 8 lanes with
different lids, Reynolds numbers and CFL numbers per lane, quadratures
every step and every 16th, a chunk that starts inside the warm-up under
the residual criterion, one in which the lanes converge mid-chunk, and one
that starts with lanes done; the singular lid; N = 64, past the resident
geometry, on the multi-launch chunk; and the FSG [48, 96]
Re=1000 flagship solved through ``run_fixed_point`` both ways, the final
state bitwise and the iterations equal. Run them there with
``python -m pytest tests/test_torch_sg_resident.py -m gpu --noconftest``.
"""

import ctypes
import hashlib
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.models.runner import LaneCarry, fresh_carry
from anap3_tpu_torch.ops import _build
from anap3_tpu_torch.ops import sg_kernels as sgk
from anap3_tpu_torch.ops import sg_lane_kernels as sgl
from anap3_tpu_torch.parallel.sweep import stack_states

torch.set_num_threads(1)

CSRC = Path(sgk.__file__).resolve().parents[1] / "csrc"
DTYPES = [torch.float32, torch.float64]
ORDERS = range(2, 768)
# sha256 of repr((n, str(dtype), lanes, x1, geometry or None)) over
# N = 2..767, float32 then float64, lanes 1, 8, 32, 128, x1 off then on:
# where the resident kernel takes a chunk, and with what cluster,
# sub-blocks and threads.
RESIDENT_GEOMETRY_SHA256 = (
    "69ea0d2507803f9e4877633e94bc4af306dbf608362417e977676612b20b51d7")


def geometry_digest():
    h = hashlib.sha256()
    for dtype in DTYPES:
        for lanes in (1, 8, 32, 128):
            for x1 in (False, True):
                for n in ORDERS:
                    g = sgk.resident_geometry(n + 1, dtype, lanes, x1)
                    h.update(repr((n, str(dtype), lanes, x1,
                                   None if g is None else tuple(g))).encode())
    return h.hexdigest()


class TestGeometry:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("lanes", [1, 8, 32, 128])
    @pytest.mark.parametrize("x1", [False, True])
    def test_a_layout_exactly_where_the_lane_fits(self, dtype, lanes, x1):
        e = torch.finfo(dtype).bits // 8
        taken = []
        for n in ORDERS:
            nf = n + 1
            g = sgk.resident_geometry(nf, dtype, lanes, x1)
            if x1 or n > sgk.RESIDENT_MAX_N[e]:
                assert g is None, n
                continue
            taken.append(n)
            st = sgk.stage_geometry(nf, dtype)
            # a block a row band (8 rows), a sub-block a column tile of the
            # stage kernel's (16 columns, 4 k groups)
            assert (st.tn, st.ksplit) == (16, 4)
            assert (g.cluster, g.sub) == (st.rows, st.cluster)
            assert g.cluster * 8 >= nf > (g.cluster - 1) * 8
            assert g.sub * 16 >= nf > (g.sub - 1) * 16
            assert g.cluster * g.sub == st.nparts
            assert g.cluster <= sgk.MAX_CLUSTER
            assert g.threads == 128 * g.sub <= (512 if e == 4 else 256)
            # the geometry does not depend on the lanes
            assert g == sgk.resident_geometry(nf, dtype)
        # one contiguous run of orders from N = 2, the working sizes in it
        assert taken == list(range(2, taken[-1] + 1)) if taken else x1
        if not x1:
            assert taken[-1] == (51 if dtype == torch.float32 else 31)
            assert {20, 24} <= set(taken)
            if dtype == torch.float32:
                assert {40, 48} <= set(taken)
            assert 64 not in taken

    def test_the_digest_pins_every_layout(self):
        assert geometry_digest() == RESIDENT_GEOMETRY_SHA256

    @pytest.mark.parametrize("n,dtype,want", [
        (20, torch.float32, (3, 2, 256)), (24, torch.float32, (4, 2, 256)),
        (40, torch.float32, (6, 3, 384)), (48, torch.float32, (7, 4, 512)),
        (20, torch.float64, (3, 2, 256)), (31, torch.float64, (4, 2, 256))])
    def test_the_working_orders(self, n, dtype, want):
        g = sgk.resident_geometry(n + 1, dtype)
        assert (g.cluster, g.sub, g.threads) == want
        with pytest.raises(TypeError):
            sgk.resident_geometry(n + 1, torch.float16)


class TestPlan:
    @pytest.mark.parametrize("chunk,start,every", [(1, 0, 16), (40, 3, 1),
                                                   (5000, 16, 16)])
    def test_one_launch_a_chunk(self, chunk, start, every):
        assert sgk.chunk_launches(chunk, start, every, resident=True) == {
            "sg_resident": 1}
        assert sgk.chunk_launches(0, start, every, resident=True) == {
            "sg_resident": 0}

    def test_the_check_takes_the_plan_and_refuses_other_counts(self):
        n = len(sgk.KERNELS)
        at = sgk.KERNELS.index("sg_resident")
        good = sgk._new_counts()
        good[at] = 1
        sgk._check_launches(good, 40, 0, 16, resident=True)
        for k, v in ((at, 2), (at, 0), (0, 1), (n, 1)):
            bad = sgk._new_counts()
            bad[at] = 1
            bad[k] = v
            with pytest.raises(RuntimeError, match="chunk launches"):
                sgk._check_launches(bad, 40, 0, 16, resident=True)
        # a resident count where the multi-launch plan was due
        with pytest.raises(RuntimeError, match="chunk launches"):
            sgk._check_launches(good, 40, 0, 16)

    def test_the_counters_carry_the_resident_keys(self):
        assert "sg_resident" in sgk.KERNELS
        assert sgk.KERNELS[-1] == "sg_resident"
        assert "sg_lanes_resident" in sgl.KERNELS
        sgk.LAUNCHES["sg_resident"] = 3
        sgl.LAUNCHES["sg_lanes_resident"] = 2
        sgk.reset_counts()
        sgl.reset_counts()
        assert sgk.LAUNCHES == {k: 0 for k in sgk.KERNELS}
        assert sgl.LAUNCHES == {k: 0 for k in sgl.KERNELS}

    def test_the_count_slot_follows_the_c_enum(self):
        text = (CSRC / "sg_common.cuh").read_text()
        body = re.search(r"enum Count \{([^}]*)\}", text).group(1)
        names = [c.strip() for c in body.split(",") if c.strip()]
        assert names.index("C_RESIDENT") == sgk.KERNELS.index("sg_resident")


class FakeLib:
    """The SG library's entries as the wrappers call them: each records
    its call and fills the launch counts of its plan."""

    def __init__(self):
        self.calls = []

    def _fill(self, counts, plan, dt):
        for k, v in plan.items():
            counts[sgk.KERNELS.index(k)] = v
        counts[len(sgk.KERNELS)] = dt
        return 0

    def sg_resident_chunk_run(self, dtype, nf, geo, lanes, ptrs, chunk,
                              start, warmup, every, resid, tol, counts,
                              stream):
        self.calls.append(("resident", nf, lanes, tuple(geo)))
        return self._fill(counts, sgk.chunk_launches(chunk, start, every,
                                                     resident=True), 0)

    def sg_chunk_run(self, dtype, nf, geo, ptrs, chunk, start, warmup, every,
                     resid, tol, x1, blocks, counts, stream):
        self.calls.append(("multi", nf, 1, bool(x1)))
        return self._fill(counts, sgk.chunk_launches(chunk, start, every,
                                                     bool(x1)), 1)

    def sg_lanes_chunk_run(self, dtype, nf, geo, lanes, ptrs, chunk, start,
                           warmup, every, resid, tol, x1, blocks, counts,
                           stream):
        self.calls.append(("multi", nf, lanes, bool(x1)))
        return self._fill(counts, sgk.chunk_launches(chunk, start, every),
                          1)

    def sg_tail_coresident(self, dtype, x1, most):
        most._obj.value = 1 << 20
        return 0

    def sg_error_string(self, rc):
        return b"fake"


def fake_ops(nf, dtype):
    ops = SimpleNamespace(nf=nf, dtype=dtype, device=torch.device("cpu"))
    for name in sgk._OP_NAMES:
        setattr(ops, name, None)
    return ops


@pytest.fixture
def fake_lib(monkeypatch):
    lib = FakeLib()
    monkeypatch.setattr(_build, "load_library", lambda family: lib)
    monkeypatch.setattr(sgk, "_stream", lambda: None)
    monkeypatch.setattr(sgk, "_CORESIDENT", {})
    monkeypatch.setattr(sgk, "_CORESIDENT_X1", {})
    sgk.reset_counts()
    sgl.reset_counts()
    yield lib
    sgk.reset_counts()
    sgl.reset_counts()


class TestDispatch:
    @pytest.mark.parametrize("n,dtype,x1,path", [
        (20, torch.float32, False, "resident"),
        (48, torch.float32, False, "resident"),
        (51, torch.float32, False, "resident"),
        (52, torch.float32, False, "multi"),
        (64, torch.float32, False, "multi"),
        (96, torch.float32, False, "multi"),
        (48, torch.float32, True, "multi"),
        (24, torch.float64, False, "resident"),
        (32, torch.float64, False, "multi")])
    def test_the_one_lane_chunk(self, fake_lib, n, dtype, x1, path):
        sgk._run_chunk(fake_ops(n + 1, dtype), {}, 40, 0, 10, 16, False,
                       1e-6, x1)
        assert [c[0] for c in fake_lib.calls] == [path]
        if path == "resident":
            assert fake_lib.calls[0][3] == tuple(
                sgk.stage_geometry(n + 1, dtype).as_c())
            assert sgk.LAUNCHES["sg_resident"] == 1
            assert sgk.PART_LAUNCHES["dt_kernel"] == 0
        else:
            assert sgk.LAUNCHES["sg_resident"] == 0
            assert sgk.PART_LAUNCHES["dt_kernel"] == 1

    @pytest.mark.parametrize("n,lanes,path", [
        (20, 8, "resident"), (40, 8, "resident"), (40, 128, "resident"),
        (64, 8, "multi"), (128, 8, "multi")])
    def test_the_lane_chunk(self, fake_lib, n, lanes, path):
        nf, ni = n + 1, n - 1
        ops = [fake_ops(nf, torch.float32)] * lanes
        z = lambda *s: torch.zeros(s, dtype=torch.float32)
        states = T.SpectralState(z(lanes, nf, nf), z(lanes, nf, nf),
                                 z(lanes, ni, ni))
        carry = fresh_carry(lanes, torch.float32, torch.device("cpu"))
        statics = {"lsc": z(lanes, 6)}
        sgl._lanes_kernel(ops, statics, states, 0, carry, 20, 1e-6, 10,
                          False, 16)
        assert fake_lib.calls[0][:3] == (path, nf, lanes)
        key = "sg_lanes_resident" if path == "resident" else "sg_lanes_aligned"
        assert sgl.LAUNCHES[key] > 0
        assert sum(sgl.LAUNCHES.values()) == sgl.LAUNCHES[key]
        assert sgk.LAUNCHES == {k: 0 for k in sgk.KERNELS}


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the resident kernel has no CPU mode")
    return torch.device("cuda")


# (Re, lid velocity, corner smoothing, CFL) of the card's lanes
LANES = [(1000.0, 1.0, 0.15, 1.5), (400.0, 1.0, 0.15, 1.5),
         (1000.0, 0.75, 0.10, 1.2), (100.0, 1.25, 0.05, 1.5),
         (1000.0, 1.0 + 2 ** -20, 0.15, 1.5), (3200.0, 1.0, 0.12, 1.0),
         (250.0, 0.5, 0.08, 1.5), (1000.0, 1.5, 0.01, 0.8)]


def card_ops(lanes, n, dtype, corner="smoothing"):
    return [T.build_spectral_ops(SpectralParameters(
        Re=Re, lid_velocity=lid, nx=n, ny=n, device="cuda",
        corner_treatment=corner, corner_smoothing=cs, CFL=cfl,
        dtype="float64" if dtype == torch.float64 else "float32"))[0]
        for Re, lid, cs, cfl in lanes]


def lane_ws(ops_list, states, chunk, carry):
    """A chunk workspace of the lanes, as the lane runner builds it."""
    ops0, B = ops_list[0], len(ops_list)
    return sgk._workspace(
        ops0, lanes=B, **sgl._lane_statics(ops_list),
        u=states.u.clone(), v=states.v.clone(), p=states.p.clone(),
        bu=torch.empty_like(states.u), bv=torch.empty_like(states.v),
        bp=torch.empty_like(states.p),
        rows=torch.empty((chunk, B, 7), dtype=ops0.dtype, device=ops0.device),
        flags=carry.flags.clone(), ref_norm=carry.ref_norm.clone())


def run_entry(resident, ops_list, states, carry, chunk, start, warmup,
              every, use_residual, tol):
    """One chunk through the C entry named, the launch counts held to its
    plan; the workspace after it."""
    lib = _build.load_library("sg")
    ops0, B = ops_list[0], len(ops_list)
    ws = lane_ws(ops_list, states, chunk, carry)
    args = (int(chunk), int(start), int(warmup), int(every),
            int(use_residual), float(tol))
    if resident:
        sgk._run_resident(ops0, B, ws, *args, {"sg_resident": 0},
                          "sg_resident")
    else:
        counts = sgk._new_counts()
        rc = lib.sg_lanes_chunk_run(
            sgk._dtype_code(ops0.dtype), ops0.nf, sgk._geo(ops0, B), B,
            sgk._ptr_table(ws), *args, 0, sgk._tail_blocks(ops0, B, lib),
            counts, sgk._stream())
        sgk._raise_on(lib, rc, "chunk")
        sgk._check_launches(counts, chunk, start, every)
    torch.cuda.synchronize()
    return ws


def bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def assert_same_outputs(a, b):
    for name in ("u", "v", "p", "rows", "ref_norm", "flags"):
        x, y = a[name], b[name]
        if x.dtype.is_floating_point:
            assert torch.equal(bits(x), bits(y)), name
        else:
            assert torch.equal(x, y), name


def developed(ops_list, steps=200):
    """The lanes' state after ``steps`` multi-launch steps from rest."""
    st = stack_states([T.initial_state(o) for o in ops_list])
    carry = fresh_carry(len(ops_list), ops_list[0].dtype, ops_list[0].device)
    ws = run_entry(False, ops_list, st, carry, steps, 0, 10, 16, False,
                   1e-30)
    return T.SpectralState(ws["u"], ws["v"], ws["p"])


CASES = [(n, torch.float32) for n in (12, 20, 24, 40, 48, 51)] + [
    (n, torch.float64) for n in (8, 20, 24, 31)]


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_the_c_geometry_exists_exactly_where_the_dispatch_takes(
            self, cuda, dtype):
        lib = _build.load_library("sg")
        code = sgk._dtype_code(dtype)
        for n in ORDERS:
            nf = n + 1
            out = (ctypes.c_int * 3)()
            rc = lib.sg_resident_geometry(
                code, nf, sgk.stage_geometry(nf, dtype).as_c(), out)
            g = sgk.resident_geometry(nf, dtype)
            assert (rc == 0) == (g is not None), n
            if g is not None:
                assert (out[0], out[1]) == (g.cluster, g.sub), n
                assert 0 < out[2] <= sgk.MAX_SMEM, n

    @pytest.mark.parametrize("n,dtype", CASES)
    @pytest.mark.parametrize("lanes", [1, 8])
    @pytest.mark.parametrize("every", [1, 16])
    @pytest.mark.parametrize("case", ["warmup", "converge", "done"])
    def test_bit_for_bit_the_multi_launch_chunk(self, cuda, n, dtype, lanes,
                                                 every, case):
        assert sgk.resident_geometry(n + 1, dtype, lanes) is not None
        ops = card_ops(LANES[:lanes], n, dtype)
        st = developed(ops)
        carry = fresh_carry(lanes, dtype, cuda)
        chunk, start, warmup, resid, tol = 40, 200, 10, False, 1e-30
        if case == "warmup":  # the residual normalization pins inside
            start, resid, tol = 3, True, 1e-3
        elif case == "converge":  # each lane's rel below tol mid-chunk
            probe = run_entry(False, ops, st, carry, chunk, start, warmup,
                              every, False, 1e-30)["rows"]
            tol = float(probe[15:25, :, 0].min()) * (1 + 1e-6)
        else:  # lanes done in an earlier chunk stay frozen
            flags = carry.flags.clone()
            flags[::2] = torch.tensor([1, 150, 1], dtype=flags.dtype)
            carry = LaneCarry(flags, carry.ref_norm)
        want = run_entry(False, ops, st, carry, chunk, start, warmup, every,
                         resid, tol)
        got = run_entry(True, ops, st, carry, chunk, start, warmup, every,
                        resid, tol)
        assert_same_outputs(got, want)
        if case == "converge":
            assert int(want["flags"][:, 0].sum()) >= 1
            assert torch.isnan(want["rows"][-1, :, 0]).any()

    @pytest.mark.parametrize("n", [24, 48])
    @pytest.mark.parametrize("every", [1, 16])
    def test_the_singular_lid(self, cuda, n, every):
        ops = card_ops(LANES[:3], n, torch.float32, corner="singular")
        st = developed(ops)
        carry = fresh_carry(3, torch.float32, cuda)
        want = run_entry(False, ops, st, carry, 40, 200, 10, every, False,
                         1e-30)
        got = run_entry(True, ops, st, carry, 40, 200, 10, every, False,
                        1e-30)
        assert_same_outputs(got, want)

    def test_the_runners_take_the_resident_kernel(self, cuda):
        ops = card_ops(LANES[:8], 40, torch.float32)
        st = stack_states([T.initial_state(o) for o in ops])
        sgk.reset_counts()
        sgl.reset_counts()
        sgl.make_lane_chunk_runner(ops, 20, 1e-30)(st, 0)
        sgk.make_sg_chunk_runner(ops[0], 20, 1e-30)(T.initial_state(ops[0]),
                                                    0, np.inf)
        assert sgl.LAUNCHES == dict({k: 0 for k in sgl.KERNELS},
                                    sg_lanes_resident=1)
        assert sgk.LAUNCHES == dict({k: 0 for k in sgk.KERNELS},
                                    sg_resident=1)
        assert sgk.PART_LAUNCHES == {"dt_kernel": 0}

    def test_past_the_geometry_the_multi_launch_chunk(self, cuda):
        assert sgk.resident_geometry(65, torch.float32) is None
        ops = card_ops(LANES[:1], 64, torch.float32)
        sgk.reset_counts()
        sgk.make_sg_chunk_runner(ops[0], 20, 1e-30)(T.initial_state(ops[0]),
                                                    0, np.inf)
        assert sgk.LAUNCHES["sg_resident"] == 0
        assert sgk.LAUNCHES["sg_stage"] == 4 * 20
        assert sgk.PART_LAUNCHES == {"dt_kernel": 1}

    def test_the_flagship_solve(self, cuda, monkeypatch):
        from anap3_tpu_torch.models.spectral import FSGSolver

        def solve():
            params = SpectralParameters(
                Re=1000.0, nx=96, ny=96, tolerance=1e-6, CFL=1.5,
                beta_squared=5.0, corner_treatment="smoothing",
                corner_smoothing=0.15, multigrid="fsg", n_levels=2,
                coarse_tolerance_factor=1.0, prolongation_method="fft",
                restriction_method="fft", dtype="float32", chunk_size=5000,
                device="cuda")
            s = FSGSolver(params=params)
            s.solve()
            torch.cuda.synchronize()
            return s

        sgk.reset_counts()
        got = solve()
        assert sgk.LAUNCHES["sg_resident"] > 0
        monkeypatch.setattr(sgk, "resident_geometry", lambda *a, **k: None)
        sgk.reset_counts()
        want = solve()
        assert sgk.LAUNCHES["sg_resident"] == 0
        assert [lv["iterations"] for lv in got.levels] == [
            lv["iterations"] for lv in want.levels]
        assert [lv["n"] for lv in got.levels] == [48, 96]
        for a, b in zip(got.state, want.state):
            assert torch.equal(bits(a), bits(b))
