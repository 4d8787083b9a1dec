"""The port's copy of the native PNG/JPEG decoder
(``cutmix_seg_tpu_torch/native/``): the cases of tests/test_native_decode.py
with the port's ``decode_array`` bit-equal to ``np.array(PIL.Image.open())``
and to the JAX package's ``cutmix_seg_tpu.native.decode.decode_array``; the
fallbacks (unsupported, corrupt, truncated, oversized inputs go to PIL); the
three modes of ``CUTMIX_SEG_NATIVE_DECODE`` (``auto`` falls back to PIL when
the build fails, ``0`` never loads it, ``1`` raises on every call); the
``encode_png`` round trip; and the sources decoding through it. Skipped
where the library does not build (no g++, libpng or libjpeg), as
tests/test_native_decode.py is.
"""

import io
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from cutmix_seg_tpu.native import decode as jnd
from cutmix_seg_tpu_torch.data import sources
from cutmix_seg_tpu_torch.native import decode as nd
from tests.test_native_decode import _cases, _ref

pytestmark = pytest.mark.skipif(
    not nd.native_available(), reason="native decoder unavailable (no g++, libpng or libjpeg?)"
)


def _chunk(tag, payload):
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _png_bytes(h, w, color_type, rows: bytes) -> bytes:
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("name", sorted(_cases()))
def test_bit_parity_with_pil_and_the_jax_decoder(name):
    data = _cases()[name]
    nat = nd._decode_native(data)
    assert nat is not None, f"{name}: expected native decode, got fallback"
    np.testing.assert_array_equal(nat, _ref(data))
    want = jnd.decode_array(data)
    got = nd.decode_array(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_all_png_filter_types_decode():
    """Rows filtered with each type 0..4 (none/sub/up/avg/paeth)."""
    h, w = 5, 8
    raw = np.random.RandomState(3).randint(0, 256, (h, w, 3), np.uint8)
    prev = np.zeros((w, 3), np.int32)
    stream = b""
    for y in range(h):
        row = raw[y].astype(np.int32)
        ft = y % 5
        left = np.zeros_like(row)
        left[1:] = row[:-1]
        ul = np.zeros_like(row)
        ul[1:] = prev[:-1]
        if ft == 0:
            out = row
        elif ft == 1:
            out = row - left
        elif ft == 2:
            out = row - prev
        elif ft == 3:
            out = row - (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            out = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        stream += bytes([ft]) + (out % 256).astype(np.uint8).tobytes()
        prev = row
    png = _png_bytes(h, w, 2, stream)
    nat = nd._decode_native(png)
    assert nat is not None
    np.testing.assert_array_equal(nat, raw)
    np.testing.assert_array_equal(nat, jnd.decode_array(png))


def test_unsupported_and_corrupt_inputs_go_to_pil():
    a16 = np.random.RandomState(0).randint(0, 65535, (10, 11)).astype(np.uint16)
    b = io.BytesIO()
    Image.fromarray(a16).save(b, "PNG")  # 16-bit: outside the native subset
    data = b.getvalue()
    assert nd._decode_native(data) is None
    out = nd.decode_array(data)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, _ref(data))
    assert nd._decode_native(b"not an image") is None
    with pytest.raises(Exception):
        nd.decode_array(b"not an image")
    good = _cases()["rgb_png"]
    for cut in (8, 20, 40, len(good) // 2, len(good) - 5):
        assert nd._decode_native(good[:cut]) is None


def test_decompression_bomb_header_routed_to_pil():
    bomb = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 60000, 60000, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(b"\x00"))
            + _chunk(b"IEND", b""))
    assert nd._decode_native(bomb) is None
    with pytest.raises(Image.DecompressionBombError):
        nd.decode_array(bomb)


def test_threaded_decode_parity():
    cases = _cases()
    names = sorted(cases) * 8
    with ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(lambda n: nd.decode_array(cases[n]), names))
    for name, out in zip(names, outs):
        np.testing.assert_array_equal(out, _ref(cases[name]))


def _fresh(monkeypatch, mode):
    monkeypatch.setenv("CUTMIX_SEG_NATIVE_DECODE", mode)
    monkeypatch.setattr(nd, "_lib", None)
    monkeypatch.setattr(nd, "_lib_failed", False)
    monkeypatch.setattr(nd, "_lib_error", None)


def _failed_build(monkeypatch):
    def fail():
        raise RuntimeError("g++ exploded")

    monkeypatch.setattr(nd, "_compile_library", fail)


def test_mode_0_routes_through_pil(monkeypatch):
    _fresh(monkeypatch, "0")
    assert not nd.native_available()
    data = _cases()["rgb_png"]
    np.testing.assert_array_equal(nd.decode_array(data), _ref(data))
    assert nd._encode_native(np.zeros((4, 4), np.uint8)) is None


def test_mode_auto_falls_back_when_the_build_fails(monkeypatch):
    _fresh(monkeypatch, "auto")
    _failed_build(monkeypatch)
    assert not nd.native_available()
    assert "g++ exploded" in str(nd.build_error())
    for name, data in _cases().items():
        np.testing.assert_array_equal(nd.decode_array(data), _ref(data), err_msg=name)
    arr = np.random.RandomState(1).randint(0, 21, (9, 7)).astype(np.uint32)
    np.testing.assert_array_equal(_ref(nd.encode_png(arr)), arr)


def test_mode_1_raises_on_every_call_when_the_build_fails(monkeypatch):
    _fresh(monkeypatch, "1")
    _failed_build(monkeypatch)
    with pytest.raises(RuntimeError, match="g\\+\\+ exploded"):
        nd.decode_array(_cases()["rgb_png"])
    for _ in range(3):
        with pytest.raises(RuntimeError, match="native decoder is unavailable"):
            nd.decode_array(_cases()["rgb_png"])


def test_build_is_keyed_by_the_source():
    path = nd.library_path()
    assert path.startswith(str(nd.BUILD_DIR)) and path.endswith(".so")
    assert "_decode-" in path and nd.native_available()


def test_encode_png_round_trip():
    """The file decodes (via PIL) to what PIL's own save stores, for every
    dtype the prediction export uses; the native writer is the one used."""
    rng = np.random.RandomState(11)
    cases = {
        "gray8": rng.randint(0, 256, (23, 31), np.uint8),
        "rgb8": rng.randint(0, 256, (23, 31, 3), np.uint8),
        "gray16": rng.randint(0, 65536, (23, 31)).astype(np.uint16),
        "labels_u32": rng.randint(0, 21, (23, 31)).astype(np.uint32),
    }
    for name, arr in cases.items():
        got = _ref(nd.encode_png(arr))
        b = io.BytesIO()
        Image.fromarray(arr).save(b, "PNG")
        np.testing.assert_array_equal(got, _ref(b.getvalue()).astype(got.dtype), name)
        np.testing.assert_array_equal(got.astype(np.int64), arr.astype(np.int64), name)
        np.testing.assert_array_equal(got, _ref(jnd.encode_png(arr)), name)
    assert nd._encode_native(cases["rgb8"]) is not None
    assert nd._encode_native(cases["rgb8"].astype(np.float32)) is None
    with pytest.raises(ValueError, match="cannot narrow"):
        nd.encode_png(np.full((3, 3), 70000, np.int64))


def test_sources_decode_and_encode_through_it(tmp_path):
    assert sources.decode_array is nd.decode_array and sources.encode_png is nd.encode_png
    src = sources.DataSource()
    src.sample_names = ["val/sample_007"]
    pred = np.random.RandomState(0).randint(0, 21, (40, 50)).astype(np.int32)
    src.save_prediction_by_index(str(tmp_path), pred, 0)
    got = np.array(Image.open(tmp_path / "val" / "sample_007.png"))
    np.testing.assert_array_equal(got.astype(np.int64), pred.astype(np.int64))


def test_fuzz_random_images_parity():
    """Many modes, sizes and encoder settings: bit-equal to PIL and to the
    JAX decoder."""
    rng = np.random.RandomState(42)
    for trial in range(60):
        h, w = int(rng.randint(1, 180)), int(rng.randint(1, 180))
        mode = ["L", "RGB", "RGBA", "P", "LA"][trial % 5]
        shape = {"L": (h, w), "RGB": (h, w, 3), "RGBA": (h, w, 4), "P": (h, w),
                 "LA": (h, w, 2)}[mode]
        img = Image.fromarray(rng.randint(0, 256, shape, np.uint8), mode)
        if mode == "P":
            img.putpalette([int(v) for v in rng.randint(0, 256, 768)])
        encodings = [("PNG", dict(optimize=bool(trial % 2),
                                  compress_level=int(rng.randint(0, 10))))]
        if mode in ("L", "RGB"):
            encodings.append(("JPEG", dict(quality=int(rng.randint(10, 101)))))
        for fmt, kw in encodings:
            b = io.BytesIO()
            img.save(b, fmt, **kw)
            data = b.getvalue()
            nat = nd._decode_native(data)
            assert nat is not None, (trial, mode, fmt)
            np.testing.assert_array_equal(nat, _ref(data), err_msg=str((trial, mode, fmt)))
            np.testing.assert_array_equal(nat, jnd.decode_array(data))
