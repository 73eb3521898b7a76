"""The native VTS codec of the port: ``csrc/vts_codec.cpp`` (zlib and
base64 in one C++ pass), built with ``g++`` on first use and bound with
ctypes.

The port's counterpart of ``anap3_tpu/utils/native.py``. The library is
built by ``ops/_build.py``'s ``_build`` (g++ in place of nvcc) into
``build/anap3_tpu_torch/native/<hash>/``, keyed by a hash of the source
and the flags. Where ``g++`` or zlib is missing, or the build or the load
fails, ``vts_codec()`` logs a warning once and returns None, and
``utils/vts.py`` runs its Python codec: this is host file I/O, and the
two codecs write the same bytes. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import logging
import shutil
from typing import Optional

from ..ops._build import _BUILD_ROOT, _build, _source_hash, CSRC

log = logging.getLogger(__name__)

__all__ = ["vts_codec", "GXX_FLAGS"]

SOURCE = CSRC / "vts_codec.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_CACHE = {}


class _VtsCodec:
    """ctypes binding of csrc/vts_codec.cpp."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        ll, cp = ctypes.c_longlong, ctypes.c_char_p
        lib.vts_encode.restype = ll
        lib.vts_encode.argtypes = [cp, ll, ctypes.c_int, cp, ll]
        lib.vts_decode.restype = ll
        lib.vts_decode.argtypes = [cp, ll, cp, ll]
        lib.vts_decoded_size.restype = ll
        lib.vts_decoded_size.argtypes = [cp, ll]

    def encode(self, data: bytes, level: int = 5) -> str:
        """base64(u32 header) + base64(one zlib block) of ``data``."""
        cap = 4 * ((len(data) + 64 + 2) // 3) + 64
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.vts_encode(data, len(data), level, buf, cap)
        if n < -1:  # the buffer was short: -n characters are needed
            cap = -n + 8
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.vts_encode(data, len(data), level, buf, cap)
        if n < 0:
            raise RuntimeError("vts_encode failed")
        return buf.raw[:n].decode("ascii")

    def decode(self, text: str) -> bytes:
        """The payload of a zlib-compressed inline-binary block (UInt32
        header); ValueError on a corrupt one."""
        raw = text.encode("ascii")
        size = self._lib.vts_decoded_size(raw, len(raw))
        if size < 0:
            raise ValueError("corrupt VTS payload header")
        buf = ctypes.create_string_buffer(max(int(size), 1))
        n = self._lib.vts_decode(raw, len(raw), buf, size)
        if n < 0:
            raise ValueError("corrupt VTS payload")
        return buf.raw[:n]


def vts_codec() -> Optional[_VtsCodec]:
    """The native codec, or None where it cannot be built or loaded (a
    warning says why, once)."""
    if "vts" in _CACHE:
        return _CACHE["vts"]
    codec = None
    gxx = shutil.which("g++")
    if gxx is None:
        log.warning("g++ not found: the native VTS codec is not built; "
                    "using the Python codec")
    else:
        out = (_BUILD_ROOT / "native"
               / _source_hash([SOURCE], GXX_FLAGS + ("-lz",))
               / "libvtscodec.so")
        try:
            if not out.exists():
                _build(out, [SOURCE], {}, compiler=(gxx, *GXX_FLAGS),
                       libs=("-lz",))
                log.info("built the native VTS codec %s", out)
            codec = _VtsCodec(ctypes.CDLL(str(out)))
        except (RuntimeError, OSError) as exc:
            log.warning("the native VTS codec did not build or load (%s); "
                        "using the Python codec", str(exc).strip()[:300])
    _CACHE["vts"] = codec
    return codec
