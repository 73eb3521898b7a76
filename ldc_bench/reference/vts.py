"""Read the point coordinates and point arrays of a VTK XML structured
grid (``.vts``) as the stored truth solutions hold them: inline binary,
zlib blocks behind a UInt32 or UInt64 header, each base64-encoded on its
own (the layout VTK and pyvista write), or ascii."""

from __future__ import annotations

import base64
import zlib
from xml.etree import ElementTree as ET

import numpy as np

_TYPES = {"Float64": np.float64, "Float32": np.float32, "Int64": np.int64,
          "Int32": np.int32, "UInt8": np.uint8}


def _b64(nbytes: int) -> int:
    return 4 * ((nbytes + 2) // 3)


def _decode(text: str, dtype, word, compressed: bool) -> np.ndarray:
    raw = "".join(text.split())
    size = np.dtype(word).itemsize
    if not compressed:
        n = int(np.frombuffer(base64.b64decode(raw[:_b64(size)]), word)[0])
        return np.frombuffer(base64.b64decode(raw[_b64(size):])[:n], dtype)
    n_blocks = int(np.frombuffer(
        base64.b64decode(raw[:_b64(3 * size)])[:size], word)[0])
    head = _b64((3 + n_blocks) * size)
    sizes = np.frombuffer(base64.b64decode(raw[:head])[:(3 + n_blocks) * size],
                          word)[3:]
    payload = base64.b64decode(raw[head:])
    out, off = [], 0
    for cs in sizes:
        out.append(zlib.decompress(payload[off:off + int(cs)]))
        off += int(cs)
    return np.frombuffer(b"".join(out), dtype)


def read_points(path):
    """(points (n, 3), {name: array}) of a ``.vts`` file."""
    root = ET.parse(str(path)).getroot()
    compressed = bool(root.get("compressor"))
    word = np.uint64 if root.get("header_type") == "UInt64" else np.uint32

    def array(el):
        dtype = _TYPES[el.get("type", "Float64")]
        if el.get("format") == "ascii":
            return np.array(el.text.split(), dtype)
        return _decode(el.text or "", dtype, word, compressed)

    piece = root.find("StructuredGrid/Piece")
    data = {el.get("Name"): array(el)
            for el in piece.findall("PointData/DataArray")}
    points = array(piece.find("Points/DataArray")).reshape(-1, 3)
    return points, data
