"""The port's native VTS codec (``anap3_tpu_torch/utils/native.py``,
``csrc/vts_codec.cpp``) against its Python codec (``utils/vts.py``).

Both ways, bytes equal: the native encoding of random float32 and float64
arrays (lengths around every base64 padding case, and 1 MB) is the Python
encoding's text, and each codec decodes the other's text to the original
bytes; on every array of the stored truths in ``data/validation/`` the two
decodes give the same bytes and their re-encodings the same text. Where
g++ is missing the Python codec runs, with a warning.
"""

import logging
from pathlib import Path
from xml.etree import ElementTree as ET

import numpy as np
import pytest

from anap3_tpu_torch.utils import native
from anap3_tpu_torch.utils import vts

ROOT = Path(__file__).resolve().parents[1]
TRUTHS = sorted((ROOT / "data" / "validation").glob("*/*/solution.vts"))


@pytest.fixture(scope="module")
def codec():
    c = native.vts_codec()
    if c is None:
        pytest.skip("the native codec did not build on this host (g++ or "
                    "zlib missing); the Python codec runs alone")
    return c


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [0, 1, 2, 3, 5, 127, 4096, 131_072])
def test_random_arrays_both_ways(codec, dtype, n):
    data = np.random.default_rng(n).standard_normal(n).astype(dtype)
    raw = data.tobytes()
    text_native = codec.encode(raw, 5)
    text_python = vts.encode_python(raw)
    assert text_native == text_python
    assert codec.decode(text_python) == raw
    assert vts.decode_python(text_native, dtype).tobytes() == raw


def test_stored_truths_decode_and_encode_alike(codec):
    assert len(TRUTHS) == 5
    arrays = 0
    for path in TRUTHS:
        root = ET.parse(str(path)).getroot()
        assert root.get("header_type", "UInt32") == "UInt32"
        assert root.get("compressor", "")
        for el in root.iter("DataArray"):
            if el.get("format", "binary") != "binary":
                continue
            dtype = vts._DTYPES[el.get("type", "Float64")]
            text = "".join((el.text or "").split())
            a = codec.decode(text)
            b = vts.decode_python(text, dtype).tobytes()
            assert a == b, (path, el.get("Name"))
            assert codec.encode(a, 5) == vts.encode_python(b)
            arrays += 1
    assert arrays >= 5 * 4


def test_files_round_trip_through_the_native_codec(codec, tmp_path):
    rng = np.random.default_rng(3)
    pts = rng.standard_normal((12, 3))
    pdata = {"u": rng.standard_normal(12).astype(np.float32),
             "w": rng.standard_normal(12)}
    vts.write_vts(tmp_path / "a.vts", pts, pdata, {"note": "x1"}, (4, 3, 1))
    back = vts.read_vts(tmp_path / "a.vts")
    np.testing.assert_array_equal(back.points, pts)
    for k, v in pdata.items():
        np.testing.assert_array_equal(back.point_data[k], v)
    assert vts.codec_name() == "native"


def test_without_gxx_the_python_codec_runs(monkeypatch, caplog, tmp_path):
    monkeypatch.setattr(native, "_CACHE", {})
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path / "native")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with caplog.at_level(logging.WARNING):
        assert native.vts_codec() is None
        assert vts.codec_name() == "python"
    assert "g++ not found" in caplog.text
    pts = np.arange(6.0).reshape(2, 3)
    vts.write_vts(tmp_path / "b.vts", pts, {"u": np.arange(2.0)}, {},
                  (2, 1, 1))
    np.testing.assert_array_equal(vts.read_vts(tmp_path / "b.vts").points,
                                  pts)
    assert not (tmp_path / "native").exists()
