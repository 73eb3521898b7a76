"""Build and load the hand-written CUDA kernels of the port.

``nvcc`` compiles ``anap3_tpu_torch/csrc/*.cu`` for Hopper (``sm_90a``) into
one shared library with a plain C interface, which is loaded with
``ctypes`` (no PyTorch headers, so a cold build takes seconds, not
minutes). The library lands in ``build/anap3_tpu_torch/<hash>/`` at the
repository root, keyed by a hash of the sources and the flags: it is built
on first use, into a temporary file that is renamed into place atomically,
so concurrent processes never load a half-written library.

Nothing here runs at import time: the CPU tests import every module of the
package on a host without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

__all__ = ["load_library", "build_info", "CSRC", "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "anap3_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "libsgkernels.so"

_lib: Optional[ctypes.CDLL] = None
_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the SG kernels cannot be built on this host")


def _source_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path, sources) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sources if s.suffix == ".cu"]]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log_text = proc.stdout + proc.stderr
    (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + log_text)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log_text}")
    os.replace(tmp, out)
    _info.update(build_seconds=time.time() - t0, ptxas=log_text)


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pp = ctypes.POINTER(ctypes.c_void_p)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.sg_step_run.argtypes = [i, i, pp, dp, i, ip, vp]
    lib.sg_step_run.restype = i
    lib.sg_chunk_run.argtypes = [i, i, pp, dp, i, i, i, i, i, d, ip, vp]
    lib.sg_chunk_run.restype = i
    lib.sg_bench_run.argtypes = [i, i, pp, dp, i, i, vp]
    lib.sg_bench_run.restype = i
    lib.sg_error_string.argtypes = [i]
    lib.sg_error_string.restype = ctypes.c_char_p


def load_library() -> ctypes.CDLL:
    """The SG kernel library, built on first use. Raises when it cannot be
    built or loaded: there is no fallback to the plain versions."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    out = _BUILD_ROOT / _source_hash(sources) / _LIB_NAME
    t0 = time.time()
    if out.exists():
        _info.update(build_seconds=0.0, cached=True)
    else:
        _build(out, sources)
        _info["cached"] = False
    lib = ctypes.CDLL(str(out))
    _bind(lib)
    _info.update(path=str(out), load_seconds=time.time() - t0)
    _lib = lib
    return lib


def build_info() -> dict:
    """Build facts of the loaded library: path, build seconds (0 when it
    came from the cache), whether it was cached, and the ptxas report."""
    return dict(_info)
