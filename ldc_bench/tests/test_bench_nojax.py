"""The check that the process which prints a result holds no module of
JAX, flax or the JAX package: top-level names compared whole, so the port
(``anap3_tpu_torch``) passes and the JAX package (``anap3_tpu``) does
not."""

import subprocess
import sys

import pytest

from ldc_bench.run import forbidden_modules
from ldc_bench.spec import ROOT


@pytest.mark.parametrize("names, found", [
    (["anap3_tpu_torch", "anap3_tpu_torch.ops.sg_kernels", "numpy"], []),
    (["anap3_tpu"], ["anap3_tpu"]),
    (["anap3_tpu.models.spectral", "anap3_tpu_torch"],
     ["anap3_tpu.models.spectral"]),
    (["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client"]),
    (["jaxtyping", "flaxen", "anap3_tpux"], []),
])
def test_forbidden_modules(names, found):
    assert forbidden_modules(names) == found


def test_the_harness_and_the_program_load_no_jax():
    """A process that imports every module of the harness and the program
    modules it drives holds none of them (JAX is installed here, so an
    import of it anywhere would show)."""
    code = (
        "import sys\n"
        "import ldc_bench.run, ldc_bench.drive, ldc_bench.judge, "
        "ldc_bench.trace, ldc_bench.control, ldc_bench.work\n"
        "ldc_bench.drive.program()\n"
        "from ldc_bench import spec\n"
        "b = spec.benchmark()\n"
        "[spec.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]\n"
        "print(ldc_bench.run.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
