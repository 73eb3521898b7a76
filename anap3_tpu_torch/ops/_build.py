"""Build and load the hand-written CUDA kernels of the port.

``nvcc`` compiles the sources of one kernel family in
``anap3_tpu_torch/csrc/`` (``<family>_*.cu`` and ``<family>_*.cuh``: "sg"
for the spectral kernels, "fv" for the FV-SIMPLE kernels, "nk" for the
Newton-Krylov Schur solve) for Hopper
(``sm_90a``) into one shared library per family with a plain C interface,
loaded with ``ctypes`` (no PyTorch headers, so a cold build takes seconds,
not minutes). A library lands in ``build/anap3_tpu_torch/<hash>/`` at the
repository root, keyed by a hash of its family's sources and the flags, so
an edit of one family does not rebuild the other: it is built on first
use, into a temporary file that is renamed into place atomically, so
concurrent processes never load a half-written library.

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
from typing import Dict

__all__ = ["load_library", "build_info", "sources", "build_all", "CSRC",
           "NVCC_FLAGS", "FAMILIES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "anap3_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
FAMILIES = ("sg", "fv", "nk")

_libs: Dict[str, ctypes.CDLL] = {}
_info: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built on this host")


def _source_hash(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in srcs:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def sources(family: str) -> list:
    """The source files of one kernel family."""
    if family not in FAMILIES:
        raise ValueError(f"unknown kernel family {family!r}: {FAMILIES}")
    return (sorted(CSRC.glob(f"{family}_*.cu"))
            + sorted(CSRC.glob(f"{family}_*.cuh")))


def _build(out: Path, srcs, info: dict) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in srcs if s.suffix == ".cu"]]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log_text = proc.stdout + proc.stderr
    (out.parent / "build.log").write_text(" ".join(cmd) + "\n" + log_text)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log_text}")
    os.replace(tmp, out)
    info.update(build_seconds=time.time() - t0, ptxas=log_text)


def _bind_sg(lib: ctypes.CDLL) -> None:
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pp = ctypes.POINTER(ctypes.c_void_p)
    ip = ctypes.POINTER(ctypes.c_int)
    # (dtype, nf, stage geometry, ...): the geometry is an int array
    # ..., the tail kernel's grid, the launch counts, the stream
    lib.sg_step_run.argtypes = [i, i, ip, pp, i, i, ip, vp]
    lib.sg_step_run.restype = i
    lib.sg_chunk_run.argtypes = [i, i, ip, pp, i, i, i, i, i, d, i, ip, vp]
    lib.sg_chunk_run.restype = i
    lib.sg_lanes_chunk_run.argtypes = [i, i, ip, i, pp, i, i, i, i, i, d, i,
                                       ip, vp]
    lib.sg_lanes_chunk_run.restype = i
    lib.sg_smooth_run.argtypes = [i, i, ip, pp, i, i, i, ip, vp]
    lib.sg_smooth_run.restype = i
    lib.sg_bench_run.argtypes = [i, i, ip, i, pp, i, i, i, vp]
    lib.sg_bench_run.restype = i
    lib.sg_tail_coresident.argtypes = [i, ip]
    lib.sg_tail_coresident.restype = i
    lib.sg_error_string.argtypes = [i]
    lib.sg_error_string.restype = ctypes.c_char_p


def _bind_fv(lib: ctypes.CDLL) -> None:
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    pp = ctypes.POINTER(ctypes.c_void_p)
    ip = ctypes.POINTER(ctypes.c_int)
    common = [i, i, i, pp, i, i, i]  # dtype ny nx ptrs K n_refine upwind
    lanes = [i, i, i, i, pp, i, i, i]  # dtype ny nx lanes ptrs K n_ref upw
    lib.fv_step_run.argtypes = common + [ip, vp]
    lib.fv_step_run.restype = i
    lib.fv_chunk_run.argtypes = common + [i, i, i, d, ip, vp]
    lib.fv_chunk_run.restype = i
    lib.fv_lanes_chunk_run.argtypes = lanes + [i, i, i, i, d, ip, vp]
    lib.fv_lanes_chunk_run.restype = i
    lib.fv_bench_run.argtypes = lanes + [i, i, i, vp]  # which folded reps
    lib.fv_bench_run.restype = i
    lib.fv_pressure_coresident.argtypes = [i, ip]
    lib.fv_pressure_coresident.restype = i
    lib.fv_error_string.argtypes = [i]
    lib.fv_error_string.restype = ctypes.c_char_p


def _bind_nk(lib: ctypes.CDLL) -> None:
    vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    # ni, ptrs, tol^2, beta^2, maxiter, the stream
    lib.nk_schur_run.argtypes = [i, ctypes.POINTER(vp), d, d, i, vp]
    lib.nk_schur_run.restype = i
    lib.nk_schur_geometry.argtypes = [i, ctypes.POINTER(i)]
    lib.nk_schur_geometry.restype = i
    lib.nk_error_string.argtypes = [i]
    lib.nk_error_string.restype = ctypes.c_char_p


_BIND = {"sg": _bind_sg, "fv": _bind_fv, "nk": _bind_nk}


def _library_path(family: str) -> Path:
    srcs = sources(family)
    return _BUILD_ROOT / _source_hash(srcs) / f"lib{family}kernels.so"


def _ensure_built(family: str) -> Path:
    """The library path of ``family``, built first when it is not cached."""
    out = _library_path(family)
    info = _info.setdefault(family, {})
    if not out.exists():
        _build(out, sources(family), info)
        info["cached"] = False
    info.setdefault("build_seconds", 0.0)
    info.setdefault("cached", True)
    return out


def load_library(family: str) -> ctypes.CDLL:
    """The kernel library of ``family``, built on first use. Raises when
    it cannot be built or loaded: there is no fallback to the plain
    versions."""
    if family in _libs:
        return _libs[family]
    t0 = time.time()
    out = _ensure_built(family)
    lib = ctypes.CDLL(str(out))
    _BIND[family](lib)
    _info[family].update(path=str(out), load_seconds=time.time() - t0)
    _libs[family] = lib
    return lib


def build_all() -> None:
    """Build every family's library that is not cached, with one ``nvcc``
    per family, all started together; then load them."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(FAMILIES)) as pool:
        list(pool.map(_ensure_built, FAMILIES))
    for family in FAMILIES:
        load_library(family)


def build_info(family: str) -> dict:
    """Build facts of a loaded library: path, build seconds (0 when it
    came from the cache), whether it was cached, and the ptxas report."""
    return dict(_info.get(family, {}))
