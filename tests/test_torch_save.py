"""``CavitySolver.save`` and ``compute_global_quantities`` of the port
against the JAX package's (``anap3_tpu/models/base.py``).

The same small solves on both sides, float64 on the CPU (SG N=12 Re=100,
FV 16x16 Re=100), each written with ``save``: the HDF5 files must hold the
same groups and, in each group, the same datasets. Values within the
parity bounds of PERF.md section 2: params equal; metrics' iterations and
flags equal, other numbers within 1e-9 relative (the wall time aside: it
is a measurement); time series within 1e-9 relative; fields within 1e-12
relative (SG) and 1e-10 (FV). The caps are whole chunks: where they are
not, the JAX runner steps past its cap and the port does not.
"""

import sys

import numpy as np
import pytest
import torch

# before the JAX package: the card's machine has neither h5py nor JAX, and
# skips this file there
h5py = pytest.importorskip("h5py")

from anap3_tpu.models.fv import FVSolver as JaxFV  # noqa: E402
from anap3_tpu.models.spectral import SGSolver as JaxSG  # noqa: E402
from anap3_tpu_torch.models.fv import FVSolver  # noqa: E402
from anap3_tpu_torch.models.spectral import SGSolver  # noqa: E402

torch.set_num_threads(1)

CASES = {
    "sg": (JaxSG, SGSolver, dict(Re=100.0, nx=12, ny=12, dtype="float64",
                                 tolerance=1e-3, max_iterations=300,
                                 chunk_size=100, basis_type="chebyshev",
                                 CFL=1.5), 1e-12),
    "fv": (JaxFV, FVSolver, dict(Re=100.0, nx=16, ny=16, dtype="float64",
                                 tolerance=1e-3, max_iterations=60,
                                 chunk_size=20), 1e-10),
}
# measurements, not results of the solve
TIMINGS = {"wall_time_seconds"}


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


@pytest.fixture(scope="module", params=sorted(CASES))
def saved(request, tmp_path_factory):
    jax_cls, port_cls, kw, field_tol = CASES[request.param]
    ref = jax_cls(**kw)
    ref.solve()
    port = port_cls(device="cpu", **kw)
    port.solve()
    out = tmp_path_factory.mktemp(request.param)
    ref.save(out / "jax.h5")
    port.save(out / "sub" / "port.h5")  # save makes the directory
    return ref, port, out / "jax.h5", out / "sub" / "port.h5", field_tol


def test_same_groups_and_datasets(saved):
    _, _, jpath, tpath, _ = saved
    with h5py.File(jpath, "r") as j, h5py.File(tpath, "r") as t:
        assert sorted(t) == sorted(j) == ["fields", "metrics", "params",
                                          "time_series"]
        for group in j:
            assert sorted(t[group]) == sorted(j[group]), group
            for name in j[group]:
                assert t[group][name].shape == j[group][name].shape, name
                assert t[group][name].dtype.kind == \
                    j[group][name].dtype.kind, name


def test_values_within_the_parity_bounds(saved):
    _, _, jpath, tpath, field_tol = saved
    with h5py.File(jpath, "r") as j, h5py.File(tpath, "r") as t:
        for name in j["params"]:
            assert np.array_equal(t["params"][name][()],
                                  j["params"][name][()]), name
        for name in j["metrics"]:
            a, b = t["metrics"][name][()], j["metrics"][name][()]
            if name in TIMINGS:
                continue
            if np.issubdtype(b.dtype, np.integer):
                assert np.array_equal(a, b), name
            else:
                assert rel(a, b) <= 1e-9, name
        for name in j["time_series"]:
            assert rel(t["time_series"][name][()],
                       j["time_series"][name][()]) <= 1e-9, name
        for name in j["fields"]:
            assert rel(t["fields"][name][()],
                       j["fields"][name][()]) <= field_tol, name


def test_global_quantities_match(saved):
    ref, port, _, _, _ = saved
    got, want = port.compute_global_quantities(), ref.compute_global_quantities()
    assert sorted(got) == sorted(want) == ["E", "P", "Z"]
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-9)


@pytest.mark.parametrize("missing", ["h5py", "pandas"])
def test_save_names_a_missing_package(saved, tmp_path, monkeypatch, missing):
    _, port, _, _, _ = saved
    monkeypatch.setitem(sys.modules, missing, None)
    target = tmp_path / "none.h5"
    with pytest.raises(ImportError, match=missing):
        port.save(target)
    assert not target.exists()
