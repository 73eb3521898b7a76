"""numpy's BLAS and LAPACK in one thread for a block of host assembly.

A threaded BLAS splits a product or a factorization by the host's core
count, and so rounds it differently on different hosts. The spectral
operators (``models/spectral_sg.build_spectral_ops``), the Newton
preconditioner's eigen-factors and the Schur kernel's folded operators
(``ops/nk_kernels.SchurOps``) are built on the host in numpy float64 once a
solve; built in one thread, they are the same bits on every host, so a
kernel and its CPU yardstick see the same system wherever they run.

The thread count is set through the ``openblas_set_num_threads`` entry of
the OpenBLAS that numpy's wheel bundles (``numpy.libs``, beside the
package). A numpy without it runs the block in the host's default threads.
Blocks nest, and threads that assemble at once take turns.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from contextlib import contextmanager
from pathlib import Path

__all__ = ["one_thread"]

# the thread count is process-wide: one block at a time sets and restores it
_LOCK = threading.RLock()


@functools.lru_cache(maxsize=1)
def _openblas():
    """(get, set) of numpy's bundled OpenBLAS thread count, or None."""
    import numpy as np

    libs = Path(np.__file__).resolve().parent.parent / "numpy.libs"
    for path in sorted(libs.glob("*openblas*.so*")):
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            continue
        for prefix in ("", "scipy_"):
            for suffix in ("", "64_", "_64"):
                get = getattr(lib, f"{prefix}openblas_get_num_threads{suffix}",
                              None)
                put = getattr(lib, f"{prefix}openblas_set_num_threads{suffix}",
                              None)
                if get is not None and put is not None:
                    get.restype, get.argtypes = ctypes.c_int, []
                    put.restype, put.argtypes = None, [ctypes.c_int]
                    return get, put
    return None


@contextmanager
def one_thread():
    """Run the block with numpy's BLAS and LAPACK in one thread."""
    calls = _openblas()
    if calls is None:
        yield
        return
    get, put = calls
    with _LOCK:
        before = get()
        put(1)
        try:
            yield
        finally:
            put(before)
