"""Pure-Python VTK StructuredGrid (.vts) reader/writer.

The reference depends on pyvista/VTK for solution export and for loading its
stored truth solutions (base.py:464-522, 970-1054). Neither is available (or
needed) in this image: the .vts format is plain XML with base64-wrapped
zlib-compressed blocks, which ~100 lines of stdlib code handle. The writer
emits the same layout pyvista produces (inline ``format="binary"`` with
``vtkZLibDataCompressor`` and ``UInt32`` headers), so files written here load
in any VTK tool and the reference fixtures load here bit-exactly.

The port's own copy of ``anap3_tpu/utils/vts.py``. Compressed payloads
with UInt32 headers go through the port's native codec
(``utils/native.py``: ``csrc/vts_codec.cpp``, zlib and base64 in one C++
pass) where it builds, else through the zlib/base64 code below, which
writes the same bytes; ``codec_name()`` says which one runs.

Inline-binary payload layout (per VTK XML spec):
    base64(header) + base64(zlib-block-1 .. zlib-block-n)
    header = [n_blocks, block_size, last_block_size, csize_1..csize_n] (u32/u64)
"""

from __future__ import annotations

import base64
import struct
import zlib
from pathlib import Path
from xml.etree import ElementTree as ET

import numpy as np

__all__ = ["StructuredGridData", "read_vts", "write_vts", "codec_name",
           "encode_python", "decode_python"]

_DTYPES = {
    "Float64": np.float64,
    "Float32": np.float32,
    "Int64": np.int64,
    "Int32": np.int32,
    "UInt64": np.uint64,
    "UInt32": np.uint32,
    "UInt8": np.uint8,
    "Int8": np.int8,
}
_TYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


class StructuredGridData:
    """In-memory .vts contents: points, point_data arrays, field_data metadata."""

    def __init__(self, points: np.ndarray, point_data: dict, field_data: dict,
                 extent: tuple):
        self.points = points          # (n_points, 3)
        self.point_data = point_data  # name -> (n_points,) or (n_points, c)
        self.field_data = field_data  # name -> np.ndarray or str
        self.extent = extent          # (x0, x1, y0, y1, z0, z1)

    @property
    def dimensions(self) -> tuple:
        x0, x1, y0, y1, z0, z1 = self.extent
        return (x1 - x0 + 1, y1 - y0 + 1, z1 - z0 + 1)


def _native_codec():
    from . import native

    return native.vts_codec()


def codec_name() -> str:
    """"native" where the C++ codec encodes and decodes, else "python"."""
    return "python" if _native_codec() is None else "native"


def _decode_inline_binary(text: str, dtype: np.dtype, header_dtype=np.uint32,
                          compressed: bool = True) -> np.ndarray:
    raw = "".join(text.split())
    if compressed and np.dtype(header_dtype).itemsize == 4:
        codec = _native_codec()
        if codec is not None:
            return np.frombuffer(codec.decode(raw), dtype=dtype)
    return decode_python(raw, dtype, header_dtype, compressed)


def decode_python(raw: str, dtype: np.dtype, header_dtype=np.uint32,
                  compressed: bool = True) -> np.ndarray:
    """The Python codec's decode of an inline-binary payload (no
    whitespace)."""
    hsize_word = np.dtype(header_dtype).itemsize
    if not compressed:
        head = base64.b64decode(raw[: _b64len(hsize_word)])
        (nbytes,) = struct.unpack("<I" if hsize_word == 4 else "<Q", head)
        payload = base64.b64decode(raw[_b64len(hsize_word):])
        return np.frombuffer(payload[:nbytes], dtype=dtype)
    # Compressed: first 3 header words tell us how many block-size words follow.
    head3 = base64.b64decode(raw[: _b64len(3 * hsize_word)])[: 3 * hsize_word]
    fmt = "<I" if hsize_word == 4 else "<Q"
    n_blocks = struct.unpack_from(fmt, head3, 0)[0]
    header_words = 3 + n_blocks
    header_b64_len = _b64len(header_words * hsize_word)
    header = base64.b64decode(raw[:header_b64_len])
    words = struct.unpack("<" + ("I" if hsize_word == 4 else "Q") * header_words,
                          header[: header_words * hsize_word])
    csizes = words[3:]
    payload = base64.b64decode(raw[header_b64_len:])
    out = bytearray()
    off = 0
    for cs in csizes:
        out += zlib.decompress(payload[off: off + cs])
        off += cs
    return np.frombuffer(bytes(out), dtype=dtype)


def _b64len(nbytes: int) -> int:
    return 4 * ((nbytes + 2) // 3)


def _encode_inline_binary(data: bytes, header_dtype=np.uint32) -> str:
    if np.dtype(header_dtype).itemsize == 4:
        codec = _native_codec()
        if codec is not None:
            return codec.encode(data, 5)
    return encode_python(data, header_dtype)


def encode_python(data: bytes, header_dtype=np.uint32) -> str:
    """The Python codec's inline-binary payload of ``data``: one zlib block
    at level 5."""
    comp = zlib.compress(data, 5)
    fmt = "<IIII" if np.dtype(header_dtype).itemsize == 4 else "<QQQQ"
    header = struct.pack(fmt, 1, len(data), len(data), len(comp))
    return base64.b64encode(header).decode() + base64.b64encode(comp).decode()


def read_vts(path) -> StructuredGridData:
    """Read a .vts file (inline binary, zlib-compressed or raw, or ascii)."""
    tree = ET.parse(str(path))
    root = tree.getroot()
    compressed = root.get("compressor", "") != ""
    header_dtype = _DTYPES.get(root.get("header_type", "UInt32"), np.uint32)
    sg = root.find("StructuredGrid")
    extent = tuple(int(t) for t in sg.get("WholeExtent").split())

    def read_array(el) -> np.ndarray:
        dtype = _DTYPES[el.get("type", "Float64")]
        fmt = el.get("format", "binary")
        if fmt == "ascii":
            return np.array(el.text.split(), dtype=dtype)
        return _decode_inline_binary(el.text or "", dtype, header_dtype, compressed)

    field_data = {}
    fd = sg.find("FieldData")
    if fd is not None:
        for el in fd:
            name = el.get("Name")
            if el.tag == "Array" and el.get("type") == "String":
                raw = _decode_inline_binary(el.text or "", np.uint8, header_dtype,
                                            compressed)
                field_data[name] = raw.tobytes().rstrip(b"\x00").decode(
                    "utf-8", "replace")
            else:
                field_data[name] = read_array(el)

    piece = sg.find("Piece")
    point_data = {}
    pd = piece.find("PointData")
    if pd is not None:
        for el in pd.findall("DataArray"):
            arr = read_array(el)
            ncomp = int(el.get("NumberOfComponents", "1"))
            if ncomp > 1:
                arr = arr.reshape(-1, ncomp)
            point_data[el.get("Name")] = arr

    pts_el = piece.find("Points/DataArray")
    points = read_array(pts_el).reshape(-1, 3)
    return StructuredGridData(points, point_data, field_data, extent)


def write_vts(path, points: np.ndarray, point_data: dict, field_data: dict,
              dimensions: tuple) -> None:
    """Write a .vts file in the pyvista-compatible inline-binary layout.

    ``points``: (n_points, 3) float64; ``dimensions``: (ni, nj, nk) with
    n_points = ni*nj*nk and the first index varying fastest in point order.
    """
    ni, nj, nk = dimensions
    extent = f"0 {ni - 1} 0 {nj - 1} 0 {nk - 1}"
    lines = [
        '<?xml version="1.0"?>',
        '<VTKFile type="StructuredGrid" version="0.1" byte_order="LittleEndian" '
        'header_type="UInt32" compressor="vtkZLibDataCompressor">',
        f'  <StructuredGrid WholeExtent="{extent}">',
    ]

    def array_xml(name, arr, tag="DataArray") -> str:
        arr = np.asarray(arr)
        if arr.dtype == object or arr.dtype.kind in "US":
            payload = str(arr.ravel()[0]).encode() + b"\x00"
            body = _encode_inline_binary(payload)
            return (f'      <Array type="String" Name="{name}" NumberOfTuples="1" '
                    f'format="binary">{body}</Array>')
        tname = _TYPE_NAMES[arr.dtype]
        ncomp = arr.shape[1] if arr.ndim == 2 else 1
        comp_attr = f' NumberOfComponents="{ncomp}"' if ncomp > 1 else ""
        flat = np.ascontiguousarray(arr)
        body = _encode_inline_binary(flat.tobytes())
        rng = ""
        if arr.dtype.kind in "fiu" and arr.size:
            lo, hi = float(np.min(arr)), float(np.max(arr))
            rng = f' RangeMin="{lo!r}" RangeMax="{hi!r}"'
        tuples_attr = (f' NumberOfTuples="{arr.shape[0] if arr.ndim else 1}"'
                       if tag == "DataArray" and arr.ndim <= 1 else "")
        return (f'      <{tag} type="{tname}" Name="{name}"{tuples_attr}{comp_attr} '
                f'format="binary"{rng}>{body}</{tag}>')

    if field_data:
        lines.append("    <FieldData>")
        for name, val in field_data.items():
            arr = np.asarray(val) if not isinstance(val, str) else np.asarray([val])
            lines.append(array_xml(name, arr))
        lines.append("    </FieldData>")

    lines.append(f'  <Piece Extent="{extent}">')
    lines.append('    <PointData>')
    for name, arr in point_data.items():
        lines.append(array_xml(name, np.asarray(arr, dtype=np.float64)))
    lines.append("    </PointData>")
    lines.append("    <CellData>")
    lines.append("    </CellData>")
    lines.append("    <Points>")
    lines.append(array_xml("Points", np.asarray(points, dtype=np.float64)))
    lines.append("    </Points>")
    lines.append("  </Piece>")
    lines.append("  </StructuredGrid>")
    lines.append("</VTKFile>")

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines))
