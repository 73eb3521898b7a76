"""The SG stage kernel's launch geometry and its card checks
(ops/sg_kernels.py:stage_geometry, csrc/sg_stage.cu).

On the CPU (every run): the geometry of every order N = 12..512 in float32
and float64, for 1 and 8 lanes, is one the kernel can take (shared memory,
cluster, column and row coverage, the partial-sum buffers the workspaces
allocate, no scratch between launches), the same as before non-portable
clusters up to N = 383, with a cluster above 8 only where 8 blocks of 48
columns cannot cover the band; an order above ``MAX_KERNEL_N`` routes to
the plain step by design; the Python constants and
slot orders agree with the C headers; and a numpy model of the kernel's
decomposition (8-row bands, tn-wide column tiles, k-slabs of ks, each
cluster block's slice of Gx p and Ix p gathered into the band) gives the
residuals of ``models/spectral_sg.residuals`` to 1e-12 relative in float64.

On a CUDA card (marker ``gpu``): the stage kernel through the step and the
chunk against their plain versions at N = 12, 20, 24, 40, 96, 128, 192, 320
(the geometry's branches: one and several blocks a cluster, 16-, 32- and
48-wide tiles, whole bands and 3- and 2-slot rings), float32 and float64,
smoothed and singular lids, with and without tau; relative error <= 1e-4
(float32) and <= 1e-11 (float64), flags equal; a B=3 lane chunk bit for
bit equal to its one-lane chunks at a ragged N and at the first order past
a 16-wide cluster of 8; and at N = 400 (a non-portable cluster of 9) a
chunk in float32 and float64 and a 2-lane chunk against plain. Run them
there with
``python -m pytest tests/test_torch_sg_stage.py -m gpu --noconftest``.
"""

import re
from pathlib import Path
from types import SimpleNamespace

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
ORDERS = range(12, 513)
# sha256 of repr((n, str(dtype), lanes, tuple(stage_geometry(n + 1, dtype,
# lanes)))) over N = 12..383, float32 then float64, lanes 1 then 8: the
# geometries of the portable-cluster rule. Tile and k split fix the bits of
# every SG kernel result, so none of these may change.
PORTABLE_GEOMETRY_SHA256 = (
    "4ebe50996e8938c915cf9bd99bd1928971f527a456ec59eb30983f338737302b")
DTYPES = [torch.float32, torch.float64]
F32_TOL = 1e-4
F64_TOL = 1e-11


def fake_ops(nf, dtype):
    """What ``_workspace`` reads of the operators, without building them."""
    ops = SimpleNamespace(nf=nf, dtype=dtype, device=torch.device("cpu"))
    for name in sgk._OP_NAMES:
        setattr(ops, name, None)
    return ops


def c_enum(text, name):
    body = re.search(r"enum " + name + r" \{([^}]*)\}", text).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [t.strip() for t in body.split(",") if t.strip()]


def c_ternary(expr, **env):
    """Evaluate a C expression of ==, ?: and parentheses over ``env``."""
    expr = expr.strip()
    while expr.startswith("(") and _close(expr, 0) == len(expr) - 1:
        expr = expr[1:-1].strip()
    depth, q = 0, None
    for i, ch in enumerate(expr):
        depth += {"(": 1, ")": -1}.get(ch, 0)
        if depth == 0 and ch == "?" and q is None:
            q, nested = i, 0
        elif depth == 0 and q is not None and ch == "?":
            nested += 1
        elif depth == 0 and q is not None and ch == ":":
            if nested == 0:
                cond = eval(expr[:q], {}, env)
                return c_ternary(expr[q + 1:i] if cond else expr[i + 1:],
                                 **env)
            nested -= 1
    return eval(expr, {}, env)


def _close(expr, start):
    depth = 0
    for i in range(start, len(expr)):
        depth += {"(": 1, ")": -1}.get(expr[i], 0)
        if depth == 0:
            return i
    return -1


class TestGeometry:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("lanes", [1, 8])
    def test_every_order_takes_a_launchable_geometry(self, dtype, lanes):
        e = torch.finfo(dtype).bits // 8
        for n in ORDERS:
            nf, ni = n + 1, n - 1
            g = sgk.stage_geometry(nf, dtype, lanes)
            assert g.smem <= sgk.MAX_SMEM, n
            # the arithmetic (tile, k groups) and the partial sums of a
            # lane do not depend on how many lanes share the launch
            one = sgk.stage_geometry(nf, dtype)
            assert (g.tn, g.ksplit, g.cluster, g.rows, g.nparts) == (
                one.tn, one.ksplit, one.cluster, one.rows, one.nparts)
            assert g.smem == e * sgk._stage_smem_elems(nf, g.tn, g.ks,
                                                       g.depth, g.ksplit)
            # a portable cluster covers every band up to N = 383, a
            # non-portable one of 48-wide tiles up to 16 blocks beyond
            assert 1 <= g.cluster <= (8 if n <= 383 else 16), n
            assert g.grid == (g.cluster, g.rows)
            assert g.grid[0] % g.cluster == 0
            # the cluster's column tiles cover the nf velocity and ni
            # pressure columns, and none of them is empty
            assert g.cluster * g.tn >= nf > ni
            assert (g.cluster - 1) * g.tn < nf
            assert g.rows * sgk.STAGE_TM >= nf > (g.rows - 1) * sgk.STAGE_TM
            assert g.ksplit in (1, 2, 4, 8)
            assert g.threads == g.ksplit * sgk.stage_group_threads(g.tn)
            assert g.threads % (32 * g.ksplit) == 0
            assert g.threads <= sgk.stage_max_threads(e, g.tn) <= 1024
            # every band whole, or a ring of 2-3 slabs that each k group
            # enters at the same phase
            assert (g.depth == 1 and g.ks == nf) or (
                g.depth in (2, 3) and g.ks in (16, 32)
                and g.ks % g.ksplit == 0)
            ws = sgk._workspace(fake_ops(nf, dtype), lanes=lanes)
            assert g.nparts == g.cluster * g.rows
            assert tuple(ws["part"].shape) == (lanes, g.nparts, 5)
            tiles = -(-nf // 16)  # the quadrature kernels keep 16x16 tiles
            assert tuple(ws["qpart"].shape) == (lanes, tiles * tiles, 3)
            assert "left" not in ws

    def test_orders_up_to_383_keep_the_portable_geometry(self):
        import hashlib

        h = hashlib.sha256()
        for n in range(12, 384):
            for dtype in DTYPES:
                for lanes in (1, 8):
                    g = sgk.stage_geometry(n + 1, dtype, lanes)
                    h.update(repr((n, str(dtype), lanes, tuple(g))).encode())
        assert h.hexdigest() == PORTABLE_GEOMETRY_SHA256

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_clusters_above_8_only_where_8_cannot_cover_the_band(self,
                                                                 dtype):
        for n in ORDERS:
            nf = n + 1
            g = sgk.stage_geometry(nf, dtype)
            portable = -(-nf // 48) <= sgk.MAX_CLUSTER
            assert (g.cluster > sgk.MAX_CLUSTER) == (not portable), n
            if not portable:
                assert (g.tn, g.cluster) == (48, -(-nf // 48)), n
        assert sgk.MAX_KERNEL_N == 767
        g = sgk.stage_geometry(sgk.MAX_KERNEL_N + 1, dtype, 8)
        assert g.cluster == sgk.MAX_CLUSTER_NP and g.smem <= sgk.MAX_SMEM

    def test_staging_follows_the_waves_of_blocks(self):
        for n in ORDERS:
            for dtype in DTYPES:
                g = sgk.stage_geometry(n + 1, dtype)
                whole = torch.finfo(dtype).bits // 8 * sgk._stage_smem_elems(
                    n + 1, g.tn, n + 1, 1, g.ksplit)
                if g.nparts <= sgk.SMS and whole <= sgk.MAX_SMEM:
                    # one wave: every band whole
                    assert (g.ks, g.depth) == (n + 1, 1), n
                elif n >= 64:
                    assert g.ks in (16, 32) and g.depth >= 2, n
        # the main paths' one-lane orders run one wave with whole bands
        for n in (24, 48, 96, 128):
            assert sgk.stage_geometry(n + 1, torch.float32).depth == 1
        # several lanes: whole bands while small, then a small ring
        assert sgk.stage_geometry(41, torch.float32, 8).depth == 1
        g = sgk.stage_geometry(129, torch.float32, 8)
        assert (g.ks, g.depth) == (32, 2)
        assert sgk.stage_geometry(193, torch.float32).depth == 2

    def test_blocks_at_b1_outnumber_the_16x16_tiles(self):
        """More blocks than the 16x16 tiles of the two-launch stage at the
        orders the main paths run at B = 1."""
        for n, old in ((96, 49), (128, 81)):
            g = sgk.stage_geometry(n + 1, torch.float32)
            assert g.cluster * g.rows > old

    def test_refuses_what_it_cannot_take(self):
        with pytest.raises(TypeError, match="float32 or float64"):
            sgk.stage_geometry(21, torch.float16)
        with pytest.raises(ValueError, match="too small"):
            sgk.stage_geometry(2, torch.float32)
        with pytest.raises(ValueError, match="more than 16 blocks"):
            sgk.stage_geometry(sgk.MAX_KERNEL_N + 2, torch.float32)
        with pytest.raises(ValueError, match="no tile of 16"):
            sgk.stage_geometry(129, torch.float32, tn=16)
        with pytest.raises(ValueError, match="ksplit 3"):
            sgk.stage_geometry(129, torch.float32, ksplit=3)
        with pytest.raises(ValueError, match="ksplit 8"):
            sgk.stage_geometry(129, torch.float64, ksplit=8)
        with pytest.raises(ValueError, match="cannot be launched"):
            sgk.stage_geometry(321, torch.float64, ks=321, depth=1)
        with pytest.raises(ValueError, match="cannot be launched"):
            sgk.stage_geometry(97, torch.float32, ks=97, depth=0)
        with pytest.raises(ValueError, match="cannot be launched"):
            sgk.stage_geometry(97, torch.float32, ksplit=4, ks=30, depth=2)

    def test_thread_limits_match_the_c_header(self):
        """The launch bounds of csrc/sg_common.cuh:stage_max_threads."""
        text = (CSRC / "sg_common.cuh").read_text()
        body = re.search(r"stage_max_threads\(int elem, int tn\) \{\s*"
                         r"return ([^;]*);", text).group(1)
        for elem in (4, 8):
            for tn in (16, 32, 48):
                assert c_ternary(body, elem=elem, tn=tn) == \
                    sgk.stage_max_threads(elem, tn), (elem, tn)

    def test_constants_and_slots_match_the_c_header(self):
        text = (CSRC / "sg_common.cuh").read_text()
        for name in ("STAGE_TM", "STAGE_RM", "STAGE_RN", "MAX_CLUSTER",
                     "MAX_CLUSTER_NP", "MAX_SMEM"):
            value = re.search(r"constexpr int " + name + r" = (\d+);",
                              text).group(1)
            assert int(value) == getattr(sgk, name), name
        slots = c_enum(text, "GeoSlot")
        assert slots == ["G_" + s.upper() for s in sgk._GEO_SLOTS] + [
            "G_COUNT"]
        ptrs = c_enum(text, "Ptr")
        assert ptrs[-1] == "P_COUNT" and len(ptrs) - 1 == len(sgk._PTR_NAMES)
        assert "P_LEFT" not in ptrs
        assert "lane_left" not in text
        geo = sgk.stage_geometry(97, torch.float64).as_c()
        assert list(geo) == [getattr(sgk.stage_geometry(97, torch.float64),
                                     s) for s in sgk._GEO_SLOTS]

    def test_the_stage_is_one_launch(self):
        host = (CSRC / "sg_host.cu").read_text()
        assert "counts[C_STAGE] += 1;" in host
        assert "counts[C_STAGE] += 2;" not in host
        stage = (CSRC / "sg_stage.cu").read_text()
        assert len(re.findall(r"__global__", stage)) == 1


def zero_ops(nf, dtype=torch.float32):
    """Operators of the shapes the kernel wrappers check, all zero, with
    the scalars of the scalar table: what ``make_fused_paths`` and the lane
    validation read, without building an order's basis."""
    ni = nf - 2
    shapes = {"Ix": (nf, ni), "Gx": (nf, ni), "IyT": (ni, nf),
              "GyT": (ni, nf)}
    ops = SimpleNamespace(nf=nf, dtype=dtype, device=torch.device("cpu"),
                          singular=False, nu=0.01, beta_sq=5.0, CFL=1.5,
                          lid_velocity=1.0, inv_dx_min=1.0, inv_dy_min=1.0)
    for name in sgk._OP_NAMES:
        setattr(ops, name, None if name.startswith("sing_") else torch.zeros(
            shapes.get(name, (nf, nf)), dtype=dtype))
    return ops


class TestRouting:
    """Orders up to MAX_KERNEL_N take the kernels; above it a level runs
    the plain step by design, and the lane kernels refuse the batch."""

    def test_make_fused_paths_returns_the_kernels_at_400(self, monkeypatch):
        from anap3_tpu_torch.models import spectral as TS

        called = []
        monkeypatch.setattr(TS.core, "sg_step",
                            lambda ops, s: called.append(ops.nf))
        step, factory = TS.make_fused_paths(zero_ops(401))
        assert factory is not None
        assert callable(factory(2, 1e-30, "rel_iter"))
        assert step.__qualname__.startswith("make_sg_step")
        assert not called

    def test_make_fused_paths_routes_above_the_cap_to_plain(self,
                                                            monkeypatch,
                                                            caplog):
        import logging

        from anap3_tpu_torch.models import spectral as TS

        called = []
        monkeypatch.setattr(TS.core, "sg_step",
                            lambda ops, s: called.append((ops.nf, s)))
        n = sgk.MAX_KERNEL_N + 1
        ops = SimpleNamespace(nf=n + 1, singular=False)
        TS._PLAIN_ORDERS_LOGGED.discard(n)
        with caplog.at_level(logging.INFO, logger=TS.log.name):
            step, factory = TS.make_fused_paths(ops)
            TS.make_fused_paths(ops, "x6")
        assert factory is None
        step("state")
        assert called == [(n + 1, "state")]
        routed = [r for r in caplog.records if "plain step" in r.message]
        assert len(routed) == 1 and f"N={n}" in routed[0].message

    def test_lane_kernels_refuse_an_order_above_the_cap(self):
        big = SimpleNamespace(nf=sgk.MAX_KERNEL_N + 2)
        with pytest.raises(ValueError, match="largest order 767"):
            sgl.validate_lanes([big, big])

    def test_vmg_smooths_a_level_above_the_cap_with_the_plain_step(self):
        from anap3_tpu_torch.models.spectral_vmg import VMGSolver

        levels = [SimpleNamespace(ops=zero_ops(401)),
                  SimpleNamespace(ops=SimpleNamespace(
                      nf=sgk.MAX_KERNEL_N + 2))]
        host = SimpleNamespace(_kernels_enabled=lambda: True)
        smoothers = VMGSolver._smoothers(host, levels[::-1])
        assert list(smoothers) == [1]


def tiled_residuals(ops, u, v, p, g):
    """The residuals as the stage kernel decomposes them (numpy, float64):
    per 8-row band and tn-wide column tile, k-slab by k-slab; the pressure
    chain from the band that each cluster's blocks assemble from their
    column slices of Gx p and Ix p."""
    a = {k: getattr(ops, k).double().numpy() for k in (
        "Dx", "Dxx", "DyT", "DyyT", "Gx", "Ix", "IyT", "GyT")}
    u, v, p = (t.double().numpy() for t in (u, v, p))
    nf, ni, tm = ops.nf, ops.nf - 2, sgk.STAGE_TM
    prods = {k: np.zeros((nf, nf)) for k in (
        "dudx", "dxxu", "dvdx", "dxxv", "dudy", "udyy", "dvdy", "vdyy",
        "dpdx", "dpdy")}

    def slabs(K):
        return [slice(k0, min(K, k0 + g.ks)) for k0 in range(0, K, g.ks)]

    for y in range(g.rows):
        rows = slice(y * tm, min(nf, (y + 1) * tm))
        # each cluster block's column slice of Gx p and Ix p, then the band
        gp_band, ip_band = np.zeros((rows.stop - rows.start, ni)), \
            np.zeros((rows.stop - rows.start, ni))
        for x in range(g.cluster):
            cols = slice(x * g.tn, min(ni, (x + 1) * g.tn))
            for ks in slabs(ni):
                gp_band[:, cols] += a["Gx"][rows, ks] @ p[ks, cols]
                ip_band[:, cols] += a["Ix"][rows, ks] @ p[ks, cols]
        for x in range(g.cluster):
            cols = slice(x * g.tn, min(nf, (x + 1) * g.tn))
            for ks in slabs(nf):
                for key, lhs, rhs in (
                        ("dudx", a["Dx"][rows, ks], u[ks, cols]),
                        ("dxxu", a["Dxx"][rows, ks], u[ks, cols]),
                        ("dvdx", a["Dx"][rows, ks], v[ks, cols]),
                        ("dxxv", a["Dxx"][rows, ks], v[ks, cols]),
                        ("dudy", u[rows, ks], a["DyT"][ks, cols]),
                        ("udyy", u[rows, ks], a["DyyT"][ks, cols]),
                        ("dvdy", v[rows, ks], a["DyT"][ks, cols]),
                        ("vdyy", v[rows, ks], a["DyyT"][ks, cols])):
                    prods[key][rows, cols] += lhs @ rhs
            for ks in slabs(ni):
                prods["dpdx"][rows, cols] += gp_band[:, ks] @ a["IyT"][ks,
                                                                       cols]
                prods["dpdy"][rows, cols] += ip_band[:, ks] @ a["GyT"][ks,
                                                                       cols]
    P = SimpleNamespace(**prods)
    R_u = -(u * P.dudx + v * P.dudy) - P.dpdx + ops.nu * (P.dxxu + P.udyy)
    R_v = -(u * P.dvdx + v * P.dvdy) - P.dpdy + ops.nu * (P.dxxv + P.vdyy)
    R_p = -ops.beta_sq * (P.dudx + P.dvdy)[1:-1, 1:-1]
    return R_u, R_v, R_p


@pytest.mark.parametrize("n,dtype,lanes", [
    (12, torch.float32, 1), (20, torch.float32, 8), (97, torch.float32, 1),
    (128, torch.float32, 1), (128, torch.float32, 8), (192, torch.float64, 1)])
def test_the_decomposition_gives_the_residuals(n, dtype, lanes):
    """Every output, slab and pressure column is covered once: the model
    of the kernel's tiling (with the geometry of ``dtype`` and ``lanes``:
    whole bands or a ring) agrees with the plain residuals in float64."""
    p = SpectralParameters(device="cpu", nx=n, ny=n, dtype="float64")
    ops = T.build_spectral_ops(p, dtype=torch.float64)[0]
    rng = np.random.default_rng(n)
    u, v, pp = (torch.as_tensor(0.05 * rng.standard_normal(s)) for s in (
        (ops.nf, ops.nf), (ops.nf, ops.nf), (ops.nf - 2, ops.nf - 2)))
    got = tiled_residuals(ops, u, v, pp,
                          sgk.stage_geometry(ops.nf, dtype, lanes))
    for a, b in zip(got, T.residuals(ops, u, v, pp)):
        b = b.numpy()
        assert np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(b))


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the stage kernel has no CPU mode")
    return torch.device("cuda")


def cuda_ops(n, dtype, corner="smoothing", **kw):
    kw = dict(dict(basis_type="chebyshev", CFL=1.5), **kw)
    p = SpectralParameters(nx=n, ny=n, corner_treatment=corner,
                           device="cuda", dtype="float64"
                           if dtype == torch.float64 else "float32", **kw)
    return T.build_spectral_ops(p)[0]


def rel_t(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def tol_of(dtype):
    return F64_TOL if dtype == torch.float64 else F32_TOL


def random_state(ops, seed):
    rng = np.random.default_rng(seed)
    nf = ops.nf
    st = T.state_from_numpy(tuple(0.05 * rng.standard_normal(s) for s in (
        (nf, nf), (nf, nf), (nf - 2, nf - 2))), ops.device, ops.dtype)
    u, v = T.enforce_bc(ops, st.u, st.v)
    return T.SpectralState(u.contiguous(), v.contiguous(), st.p)


@pytest.mark.gpu
class TestOnCard:
    @pytest.mark.parametrize("n", [12, 20, 24, 40, 96, 128, 192, 320])
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("corner", ["smoothing", "singular"])
    @pytest.mark.parametrize("with_tau", [False, True])
    def test_stage_kernel_matches_plain(self, cuda, n, dtype, corner,
                                        with_tau):
        """The step (four stage launches, tau on every stage residual) and
        an 8-step chunk from the step's flow (quadratures at i = 0 and 4)
        against their plain versions."""
        ops = cuda_ops(n, dtype, corner)
        st = random_state(ops, n)
        tau = tuple(0.2 * t for t in random_state(ops, n + 1)) \
            if with_tau else None
        s_k, m_k = sgk.make_sg_step(ops, with_tau=with_tau)(
            *((st, tau) if with_tau else (st,)))
        torch.cuda.synchronize()
        s_p, m_p = sgk.step_plain(ops, st, tau)
        for a, b in zip(s_k, s_p):
            assert rel_t(a, b) <= tol_of(dtype)
        for k in m_p:
            assert rel_t(m_k[k], m_p[k]) <= tol_of(dtype), k
        if with_tau:
            return
        out_k = sgk.make_sg_chunk_runner(ops, 8, 1e-30, 2, "rel_iter", 4)(
            s_p, 0, np.inf)
        out_p = sgk.chunk_plain(ops, s_p, 0, np.inf, 8, 1e-30, 2, False, 4)
        assert [int(out_k[i]) for i in (1, 2, 3)] == [
            int(out_p[i]) for i in (1, 2, 3)]
        for a, b in zip(out_k[0], out_p[0]):
            assert rel_t(a, b) <= tol_of(dtype)
        for c in range(7):
            assert rel_t(out_k[4][:, c], out_p[4][:, c]) <= tol_of(dtype), c

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_n400_takes_a_non_portable_cluster(self, cuda, dtype):
        """N = 400: nine 48-wide blocks a cluster. The step and an 8-step
        chunk against their plain versions, and a 2-lane chunk against
        lanes_plain, flags equal."""
        import dataclasses

        assert sgk.stage_geometry(401, dtype).cluster == 9
        o0 = cuda_ops(400, dtype, Re=100.0)  # one basis build: ~7 s
        ops = [o0, dataclasses.replace(o0, nu=1e-3, CFL=1.0)]
        st = random_state(ops[0], 400)
        s_k, m_k = sgk.make_sg_step(ops[0])(st)
        torch.cuda.synchronize()
        s_p, m_p = sgk.step_plain(ops[0], st)
        for a, b in zip(s_k, s_p):
            assert rel_t(a, b) <= tol_of(dtype)
        for k in m_p:
            assert rel_t(m_k[k], m_p[k]) <= tol_of(dtype), k
        out_k = sgk.make_sg_chunk_runner(ops[0], 8, 1e-30, 2, "rel_iter",
                                         4)(s_p, 0, np.inf)
        out_p = sgk.chunk_plain(ops[0], s_p, 0, np.inf, 8, 1e-30, 2, False,
                                4)
        assert [int(out_k[i]) for i in (1, 2, 3)] == [
            int(out_p[i]) for i in (1, 2, 3)]
        for a, b in zip(out_k[0], out_p[0]):
            assert rel_t(a, b) <= tol_of(dtype)
        for c in range(7):
            assert rel_t(out_k[4][:, c], out_p[4][:, c]) <= tol_of(dtype), c
        sts = stack_states([random_state(o, 401 + b)
                            for b, o in enumerate(ops)])
        carry = TR.fresh_carry(2, dtype, cuda)
        lk = sgl.make_lane_chunk_runner(ops, 8, 1e-30, 2)(sts, 0, carry)
        lp = sgl.lanes_plain(ops, sts, 0, carry, 8, 1e-30, 2, False,
                             sgl.lane_metrics_every(400))
        assert torch.equal(lk[1].flags, lp[1].flags)
        for a, b in zip(lk[0], lp[0]):
            assert rel_t(a, b) <= tol_of(dtype)
        for c in range(7):
            assert rel_t(lk[2][..., c], lp[2][..., c]) <= tol_of(dtype), c

    @pytest.mark.parametrize("n", [20, 128])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_lanes_are_bit_equal_to_one_lane_chunks(self, cuda, n, dtype):
        """B = 3 lanes (Re, corner_smoothing, CFL differ) at a ragged order
        (N = 20: two blocks a cluster, the last one part-empty) and at the
        first order past a 16-wide cluster of 8 (N = 128: 32-wide tiles)."""
        lanes = [(100.0, 0.15, 1.5), (400.0, 0.10, 1.2), (1000.0, 0.05, 1.0)]
        ops = [cuda_ops(n, dtype, Re=Re, corner_smoothing=cs, CFL=cfl)
               for Re, cs, cfl in lanes]
        st = stack_states([random_state(o, 7) for o in ops])
        m = sgl.lane_metrics_every(n)
        out = sgl.make_lane_chunk_runner(ops, 12, 1e-30)(st, 0)
        for b, o in enumerate(ops):
            one = sgk.make_sg_chunk_runner(o, 12, 1e-30, 10, "rel_iter", m)(
                T.SpectralState(*(t[b] for t in st)), 0, np.inf)
            for x, y in zip(out[0], one[0]):
                assert torch.equal(x[b], y)
            assert torch.equal(out[2][:, b], one[4])
