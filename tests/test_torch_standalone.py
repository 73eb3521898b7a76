"""anap3_tpu_torch stands alone: it imports nothing of JAX or anap3_tpu.

- A fresh interpreter imports every module of the port (the batched-sweep
  modules of ``parallel/``, the lane-kernel wrappers, the Newton solver
  ``models/steady.py``, ``utils/checkpoint.py``, the multi-process modules
  ``parallel/{spatial,distributed,scaling,dryrun}.py`` and the tracer
  ``utils/profiling.py`` among them) and
  chip_smoke.py's import block while a ``sys.meta_path`` finder refuses
  ``jax``, ``jaxlib`` and ``anap3_tpu`` (and their submodules); none of
  them may end up in ``sys.modules``.
- The port's copies of the JAX package's numpy modules (bases, transfer
  operators, lid profile, singular fields, VTS reader) give results equal
  bit for bit to the originals.
- The port's parameter dataclasses carry every field and default of the
  JAX package's, in the same order, plus ``device``.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

from anap3_tpu.models import params as jax_params
from anap3_tpu.ops import basis as jax_basis
from anap3_tpu.ops import corner as jax_corner
from anap3_tpu.ops import singular as jax_singular
from anap3_tpu.ops import transfer as jax_transfer
from anap3_tpu.utils import vts as jax_vts
from anap3_tpu_torch.models import params as port_params
from anap3_tpu_torch.ops import basis as port_basis
from anap3_tpu_torch.ops import corner as port_corner
from anap3_tpu_torch.ops import singular as port_singular
from anap3_tpu_torch.ops import transfer as port_transfer
from anap3_tpu_torch.utils import vts as port_vts

_BLOCKED_IMPORTS = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "anap3_tpu")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import anap3_tpu_torch
names = [m.name for m in pkgutil.walk_packages(anap3_tpu_torch.__path__,
                                               "anap3_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the batched-sweep path and its lane kernels are among them
SWEEP = {"anap3_tpu_torch.parallel.sweep", "anap3_tpu_torch.parallel.fsg_sweep",
         "anap3_tpu_torch.parallel.batched",
         "anap3_tpu_torch.ops.sg_lane_kernels",
         "anap3_tpu_torch.ops.fv_lane_kernels"}
assert SWEEP <= set(names), SWEEP - set(names)
# and the Newton solver and checkpoint modules
STEADY = {"anap3_tpu_torch.models.steady", "anap3_tpu_torch.utils.checkpoint"}
assert STEADY <= set(names), STEADY - set(names)
# and the multi-process modules and the tracer
MULTI = {"anap3_tpu_torch.parallel.spatial",
         "anap3_tpu_torch.parallel.distributed",
         "anap3_tpu_torch.parallel.scaling", "anap3_tpu_torch.parallel.dryrun",
         "anap3_tpu_torch.utils.profiling"}
assert MULTI <= set(names), MULTI - set(names)
import chip_smoke  # its import block; main() runs only as a script
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names), "modules")
"""


def test_port_imports_no_jax_and_no_jax_package(repo_root):
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS],
                          cwd=repo_root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 25  # every module was imported


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("kind", ["chebyshev", "legendre"])
@pytest.mark.parametrize("n", [12, 24, 48])
def test_basis_is_bit_equal(kind, n):
    jb = jax_basis.make_basis(kind, (0.0, 1.0))
    pb = port_basis.make_basis(kind, (0.0, 1.0))
    x = jb.nodes(n + 1)
    for name in ("nodes", "diff_matrix", "quadrature_weights"):
        _equal(getattr(pb, name)(n + 1), getattr(jb, name)(n + 1))
    _equal(port_basis.inner_to_full_interp_matrix(x),
           jax_basis.inner_to_full_interp_matrix(x))
    ref = 2.0 * x - 1.0
    _equal(port_basis.jacobi_vandermonde(ref),
           jax_basis.jacobi_vandermonde(ref))
    xc = jb.nodes(n // 2 + 1)
    _equal(port_basis.interpolation_matrix_1d(xc, x),
           jax_basis.interpolation_matrix_1d(xc, x))


@pytest.mark.parametrize("kind", ["chebyshev", "legendre"])
@pytest.mark.parametrize("nf,nc", [(48, 24), (24, 12), (48, 32), (24, 20)])
def test_transfer_matrices_are_bit_equal(kind, nf, nc):
    """Every transfer the V-cycle builds, on nested (halving) and
    non-nested pairs."""
    b = jax_basis.make_basis(kind, (0.0, 1.0))
    x_f, x_c = b.nodes(nf + 1), b.nodes(nc + 1)
    x_fi, x_ci = x_f[1:-1], x_c[1:-1]
    J, P = jax_transfer, port_transfer
    _equal(P.fft_restriction_matrix(nf + 1, nc + 1),
           J.fft_restriction_matrix(nf + 1, nc + 1))
    _equal(P.injection_restriction_matrix(nf + 1, nc + 1),
           J.injection_restriction_matrix(nf + 1, nc + 1))
    _equal(P.modal_restriction_matrix(x_f, x_c),
           J.modal_restriction_matrix(x_f, x_c))
    for a, c in ((x_f, x_c), (x_fi, x_ci), (x_ci, x_fi), (x_c, x_f)):
        _equal(P.nodal_injection_matrix(a, c), J.nodal_injection_matrix(a, c))
        _equal(P.nodal_interpolation_matrix(a, c),
               J.nodal_interpolation_matrix(a, c))
    for pro in ("fft", "polynomial"):
        for a, c in zip(P.make_level_transfer_matrices(
                x_c, x_f, pro, "fft", chebyshev=kind == "chebyshev"),
                J.make_level_transfer_matrices(
                x_c, x_f, pro, "fft", chebyshev=kind == "chebyshev")):
            _equal(a, c)


def test_lid_and_singular_fields_are_bit_equal():
    x = jax_basis.make_basis("chebyshev", (0.0, 1.0)).nodes(33)
    for method in ("smoothing", "saad", "polynomial", "none"):
        _equal(port_corner.lid_profile(x, method=method, smoothing_width=0.15),
               jax_corner.lid_profile(x, method=method, smoothing_width=0.15))
    sp = port_singular.singular_fields_on_grid(x, x)
    sj = jax_singular.singular_fields_on_grid(x, x)
    assert sorted(sp) == sorted(sj)
    for key in sj:
        _equal(sp[key], sj[key])
    pts = np.linspace(0.01, 0.99, 7)
    for a, c in zip(port_singular.eval_singular_uv(pts, pts[::-1]),
                    jax_singular.eval_singular_uv(pts, pts[::-1])):
        _equal(a, c)
    assert port_singular.singular_min_n(1000.0) == \
        jax_singular.singular_min_n(1000.0)


def test_read_vts_is_bit_equal(repo_root):
    path = repo_root / "data/validation/fv/Re100/solution.vts"
    a, b = port_vts.read_vts(path), jax_vts.read_vts(path)
    _equal(a.points, b.points)
    assert sorted(a.point_data) == sorted(b.point_data)
    for key in b.point_data:
        _equal(a.point_data[key], b.point_data[key])
    assert a.dimensions == b.dimensions


def test_write_vts_reads_back_in_both_packages(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((12, 3))
    data = {"u": rng.standard_normal(12), "velocity": rng.standard_normal((12, 3))}
    port_vts.write_vts(tmp_path / "p.vts", pts, data, {"Re": np.array([100])},
                       (3, 4, 1))
    for reader in (port_vts.read_vts, jax_vts.read_vts):
        g = reader(tmp_path / "p.vts")
        np.testing.assert_array_equal(g.points, pts)
        for key in data:
            np.testing.assert_array_equal(g.point_data[key], data[key])


@pytest.mark.parametrize("name", ["SpectralParameters", "FVParameters"])
def test_parameter_dataclasses_carry_every_jax_field(name):
    """Every field of the JAX dataclass, with its default and in its
    order, then ``device``; the port's classes subclass nothing of the
    JAX package."""
    jax_cls, port_cls = getattr(jax_params, name), getattr(port_params, name)
    jf = [(f.name, f.default) for f in dataclasses.fields(jax_cls)]
    pf = [(f.name, f.default) for f in dataclasses.fields(port_cls)]
    assert pf == jf + [("device", "cuda")]
    assert not issubclass(port_cls, jax_params.Parameters)
    for cls in ("Metrics", "TimeSeries", "Fields"):
        assert [f.name for f in dataclasses.fields(getattr(port_params, cls))] \
            == [f.name for f in dataclasses.fields(getattr(jax_params, cls))]
    assert port_cls().to_mlflow() == dict(jax_cls().to_mlflow(),
                                          device="cuda")
