"""The x-sharded SG solve of anap3_tpu_torch (parallel/spatial.py and
SGSolver with ``spatial_mesh``) against anap3_tpu.parallel.spatial.

The JAX side runs in this process on the virtual 8-device CPU mesh of
tests/conftest.py; the port's side runs once, on 4 gloo ranks spawned by
``distributed.launch_local_ranks`` (``torch_ranks.spatial_job``, a 180 s
timeout), which write their gathered arrays as ``.npz``. Float64 unless
stated, N=15 (16 rows, 4 blocks), Re=100, sg.yaml numerics; the step's
inputs are seeded with numpy.

- ``build_sharded_ops`` equals JAX's field by field (within 1e-14) and
  ``shard_ops`` takes the blocks of ``make_step_ops_spec``;
- the (1 x 4) sharded step within 1e-12 relative of JAX's
  ``make_sharded_step``, and of the port's ``core.sg_step`` within 1e-10
  after 1 step and 1e-8 after 5 (JAX's bounds, tests/test_parallel.py);
  the batched (2 x 2) step likewise;
- the sharded chunk runner through ``run_fixed_point`` (inside
  ``SGSolver`` with a mesh): float64 from rest (tol 2e-3), iterations
  equal to JAX's sharded runner, to the port's unsharded run and to the
  unsharded solver, fields and the stored time series within 1e-9, vortex
  metrics finite; float32 at tol 1e-5 (the bounds of
  tests/test_parallel.py's float32 case), from the unsharded run's state
  at step ``F32_START`` through its convergence at step 6,836: iterations
  equal to the port's unsharded run from rest, u within rtol 1e-4 /
  atol 1e-5 (the whole case from rest, too long for a busy host's 180 s,
  is ``PYTHONPATH=. python tests/torch_ranks.py``);
- a checkpointed sharded solve resumed bit-equal to an uninterrupted
  one; the singular lid refused; ``spatial_mesh_from_config`` takes every
  rank or none.

The ``gpu`` test runs the sharded step at world size 1 over NCCL.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from anap3_tpu_torch.models import spectral_sg as T
from anap3_tpu_torch.models.params import SpectralParameters
from anap3_tpu_torch.models.runner import run_fixed_point
from anap3_tpu_torch.models.spectral import SGSolver
from anap3_tpu_torch.parallel import spatial as S
from anap3_tpu_torch.parallel.distributed import launch_local_ranks

import torch_ranks as R

torch.set_num_threads(1)



def jx():
    """The JAX side, imported when a test needs it: the card's machine,
    where the ``gpu`` tests run, has no JAX."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from anap3_tpu.models import spectral_sg as J
    from anap3_tpu.models.params import SpectralParameters
    from anap3_tpu.models.runner import run_fixed_point
    from anap3_tpu.parallel import spatial

    return SimpleNamespace(jax=jax, jnp=jnp, Mesh=Mesh,
                           NamedSharding=NamedSharding, J=J,
                           Parameters=SpectralParameters,
                           run_fixed_point=run_fixed_point, SP=spatial)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    """The 4-rank run of ``torch_ranks.spatial_job``: (its summary, the
    directory of its arrays)."""
    out = tmp_path_factory.mktemp("spatial4")
    R.warm32(out)
    info = launch_local_ranks(4, R.spatial_job, {"out_dir": str(out)},
                              device="cpu", timeout=180)
    return info[0], out


def load(ranks, name):
    return np.load(ranks[1] / f"{name}.npz")


def jax_ops(**over):
    X = jx()
    p = X.Parameters(**R.spec(**over))
    return p, X.J.build_spectral_ops(p)[0]


def port_ops(**over):
    return T.build_spectral_ops(SpectralParameters(device="cpu",
                                                   **R.spec(**over)))[0]


def jax_sharded_step(mesh, u, v, p):
    """JAX's make_sharded_step on (B, nf, nf) lanes."""
    X = jx()
    JSP, jnp = X.SP, X.jnp
    params, _ = jax_ops()
    ops, _ = JSP.build_sharded_ops(params, dtype=jnp.float64)
    ops = X.jax.tree.map(
        lambda a, s: X.jax.device_put(a, X.NamedSharding(mesh, s)), ops,
        JSP.make_step_ops_spec())
    state = JSP.shard_state(mesh, (jnp.asarray(u), jnp.asarray(v),
                                   JSP.pad_pressure(jnp.asarray(p))),
                            batch_axis="sweep")
    step = JSP.make_sharded_step(mesh, batch_axis="sweep")
    return step, ops, state


def jax_mesh(shape, names):
    X = jx()
    return X.Mesh(np.array(X.jax.devices()[:4]).reshape(shape), names)


class TestOperators:
    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    def test_build_sharded_ops_matches_jax(self, dtype):
        JSP = jx().SP
        params, _ = jax_ops(dtype=dtype)
        jops, _ = JSP.build_sharded_ops(params, dtype=jx().jnp.dtype(dtype))
        tops, _ = S.build_sharded_ops(
            SpectralParameters(device="cpu", **R.spec(dtype=dtype)))
        for name in JSP.ShardedSpectralOps._FIELDS:
            a = getattr(tops, name)
            b = np.asarray(getattr(jops, name))
            assert a.dtype == getattr(torch, dtype), name
            assert tuple(a.shape) == b.shape, name
            assert rel(a.numpy(), b) <= 1e-14, name

    def test_shard_ops_takes_the_spec_blocks(self):
        JSP = jx().SP
        whole, _ = S.build_sharded_ops(SpectralParameters(device="cpu",
                                                          **R.spec()))
        spec = JSP.make_step_ops_spec()
        parts = [S.shard_ops(whole, r, 4) for r in range(4)]
        for name in JSP.ShardedSpectralOps._FIELDS:
            blocks = [getattr(p, name) for p in parts]
            layout = tuple(getattr(spec, name))
            full = getattr(whole, name)
            if layout == (None, "x"):
                assert torch.equal(torch.cat(blocks, 1), full), name
                assert blocks[0].shape == (16, 4), name
            elif layout == ("x", None):
                assert torch.equal(torch.cat(blocks, 0), full), name
                assert blocks[0].shape == (4, 16), name
            else:
                assert all(b is full for b in blocks), name
        with pytest.raises(ValueError, match="divide"):
            S.shard_ops(whole, 0, 3)

    def test_pad_pressure_round_trip(self):
        p = torch.as_tensor(np.random.default_rng(3).standard_normal(
            (2, 14, 14)))
        pp = S.pad_pressure(p)
        assert pp.shape == (2, 16, 16)
        assert torch.equal(S.unpad_pressure(pp), p)
        ring = pp.clone()
        ring[..., 1:-1, 1:-1] = 0
        assert not ring.any()
        X = jx()
        np.testing.assert_array_equal(
            pp.numpy(), np.asarray(X.SP.pad_pressure(X.jnp.asarray(
                p.numpy()))))


class TestShardedStep:
    def test_1x4_step_matches_jax(self, ranks4):
        d = load(ranks4, "step14")
        mesh = jax_mesh((1, 4), ("sweep", "x"))
        step, ops, state = jax_sharded_step(
            mesh, d["u0"][None], d["v0"][None], d["p0"][None])
        for k in range(1, 6):
            state = step(ops, *state)
            if k in (1, 5):
                u, v, p = (np.asarray(a)[0] for a in state)
                assert rel(d[f"u{k}"], u) <= 1e-12
                assert rel(d[f"v{k}"], v) <= 1e-12
                assert rel(d[f"p{k}"], p[1:-1, 1:-1]) <= 1e-12

    def test_1x4_step_matches_sg_step(self, ranks4):
        d = load(ranks4, "step14")
        ops = port_ops()
        s = T.SpectralState(*(torch.as_tensor(d[k]) for k in
                              ("u0", "v0", "p0")))
        for k, tol in ((1, 1e-10), (5, 1e-8)):
            for _ in range(1 if k == 1 else 4):
                s, _ = T.sg_step(ops, s)
            for name, ref in zip("uvp", s):
                np.testing.assert_allclose(d[f"{name}{k}"], ref.numpy(),
                                           rtol=tol, atol=tol * 1e-2)

    def test_2x2_batched_step(self, ranks4):
        d = load(ranks4, "step22")
        mesh = jax_mesh((2, 2), ("sweep", "x"))
        step, ops, state = jax_sharded_step(mesh, d["u0"], d["v0"], d["p0"])
        u, v, p = (np.asarray(a) for a in step(ops, *state))
        assert rel(d["u1"], u) <= 1e-12 and rel(d["v1"], v) <= 1e-12
        assert rel(d["p1"], p[:, 1:-1, 1:-1]) <= 1e-12
        top = port_ops()
        for b in range(2):
            ref, _ = T.sg_step(top, T.SpectralState(*(
                torch.as_tensor(d[k][b]) for k in ("u0", "v0", "p0"))))
            for name, r in zip("uvp", ref):
                np.testing.assert_allclose(d[f"{name}1"][b], r.numpy(),
                                           rtol=1e-10, atol=1e-12)


def unsharded(dtype, tol):
    ops = port_ops(dtype=dtype)
    return run_fixed_point(lambda s: T.sg_step(ops, s), lambda s: (s.u, s.v),
                           T.initial_state(ops), tolerance=tol,
                           max_iterations=20000, chunk=200)


class TestShardedRunner:
    def test_float64_matches_jax_and_unsharded(self, ranks4):
        d = load(ranks4, "solver")
        X = jx()
        JSP = X.SP
        params, jops = jax_ops()
        mesh = jax_mesh((4,), ("x",))
        sh, _ = JSP.build_sharded_ops(params, dtype=X.jnp.float64)
        sh = X.jax.tree.map(
            lambda a, s: X.jax.device_put(a, X.NamedSharding(mesh, s)), sh,
            JSP.make_step_ops_spec())
        s0 = X.J.initial_state(jops)
        state = JSP.shard_state(mesh, (s0.u, s0.v, JSP.pad_pressure(s0.p)))
        jres = X.run_fixed_point(
            None, lambda s: (s[0], s[1]), state, tolerance=R.RUN64_TOL,
            max_iterations=20000, chunk=200,
            chunk_runner=lambda c, t, m: JSP.make_sharded_chunk_runner(
                mesh, sh, c, t, 10, convergence_metric=m))
        ref = unsharded("float64", R.RUN64_TOL)
        assert bool(d["converged"]) and jres.converged and ref.converged
        assert int(d["iterations"]) == jres.iterations == ref.iterations
        assert rel(d["u"], np.asarray(jres.state[0])) <= 1e-9
        for name, t in zip("uvp", ref.state):
            assert rel(d[name], t.numpy()) <= 1e-9

    def test_float32_matches_unsharded(self, ranks4):
        d = load(ranks4, "run32")
        ref = unsharded("float32", 1e-5)
        assert bool(d["converged"]) and ref.converged
        assert R.F32_START < int(d["iterations"]) == ref.iterations
        np.testing.assert_allclose(d["u"], ref.state.u.numpy(), rtol=1e-4,
                                   atol=1e-5)
        rows = np.isin(ref.history_iters, d["history_iters"][:50])
        np.testing.assert_array_equal(ref.history_iters[rows],
                                      d["history_iters"][:50])
        np.testing.assert_allclose(d["energy"][:50],
                                   np.asarray(ref.history["energy"])[rows],
                                   rtol=1e-4)


class TestShardedSolver:
    def test_solver_matches_unsharded(self, ranks4):
        d = load(ranks4, "solver")
        ref = SGSolver(device="cpu", **R.spec(tolerance=R.RUN64_TOL,
                                              chunk_size=200))
        ref.solve()
        assert bool(d["converged"]) and ref.metrics.converged
        assert int(d["iterations"]) == ref.metrics.iterations
        for name, t in zip("uvp", ref.state):
            assert rel(d[name], t.numpy()) <= 1e-9
        for key, series in vars(ref.time_series).items():
            assert len(series) > 50, key
            np.testing.assert_allclose(d[key], series, rtol=1e-9,
                                       err_msg=key)
        m = ref.compute_vortex_metrics()
        assert np.isfinite(d["psi_min"]) and np.isfinite(d["omega_center"])
        assert abs(float(d["psi_min"]) - m["psi_min"]) <= 1e-9

    def test_resume_is_bit_equal(self, ranks4):
        info = ranks4[0]["resume"]
        assert info["iterations"] == [60, 60]
        assert info["bit_equal"]
        # rank 0 wrote whole fields: the newest two after the resumed chunk
        assert info["files"] == ["ckpt_000000040.npz", "ckpt_000000060.npz"]
        with np.load(ranks4[1] / "ck" / "ckpt_000000060.npz") as f:
            assert f["leaf_0"].shape == (16, 16)
            assert f["leaf_2"].shape == (16, 16)

    def test_singular_lid_is_refused(self, ranks4):
        assert "corner_treatment=singular" in ranks4[0]["singular"]

    def test_mesh_from_config(self, ranks4):
        assert ranks4[0]["mesh_from_config"] == {
            "x:16": 4, "sweep:16": None, "x:13": None, "x:18": None}
        # no process group in this process: no mesh
        assert S.spatial_mesh_from_config({"mesh_axes": ["x"]}, nf=16,
                                          device="cpu") is None

    def test_spatial_mesh_stays_unclaimed(self):
        """main.py would hand a solver that claims the mesh a JAX Mesh."""
        assert SGSolver.SUPPORTS_SPATIAL_MESH is False
        assert SGSolver(device="cpu", **R.spec()).spatial_mesh is None


@pytest.fixture
def nccl_world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs on the card only")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    yield torch.device("cuda")
    dist.destroy_process_group()


@pytest.mark.gpu
class TestOnCard:
    """World size 1 over NCCL (``python -m pytest tests/test_torch_spatial.py
    -m gpu --noconftest``)."""

    def test_sharded_step_matches_plain_step(self, nccl_world):
        from torch.distributed.device_mesh import init_device_mesh

        p = SpectralParameters(device="cuda", **R.spec(48))
        ops = T.build_spectral_ops(p)[0]
        whole, _ = S.build_sharded_ops(p)
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("x",))
        u, v, pi = (t.to(nccl_world) for t in R.random_state(ops, 0))
        step = S.make_sharded_step(mesh)
        su, sv, sp = step(S.shard_ops(whole, 0, 1), u, v, S.pad_pressure(pi))
        ref, _ = T.sg_step(ops, T.SpectralState(u, v, pi))
        for a, b in zip((su, sv, S.unpad_pressure(sp)), ref):
            assert a.is_cuda
            assert rel(a.cpu().numpy(), b.cpu().numpy()) <= 1e-11
