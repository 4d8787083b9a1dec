"""ctypes wrapper for the native PNG/JPEG decoder (decode.cpp; a copy of
cutmix_seg_tpu.native.decode, built into the port's own directory).

``decode_array(data)`` returns exactly what ``np.array(PIL.Image.open(data))``
would for the supported subset (8-bit gray / gray+alpha / palette-indices /
RGB / RGBA PNG; 8-bit gray / RGB JPEG), decoding in C++ with the GIL released
-- loader threads (data/loader.py) decode truly in parallel. Unsupported or
corrupt inputs fall back to PIL so behavior never regresses.

The library is built lazily with g++ (``-lpng -ljpeg -lz``) into
``build/kernels/`` at the checkout root, as ``_decode-<sha>.so`` keyed by a
hash of the source, and reused across processes. Environment:
  CUTMIX_SEG_NATIVE_DECODE=0   force PIL (native never loaded)
  CUTMIX_SEG_NATIVE_DECODE=1   require native (raise if build/load fails)
(default ``auto``: try native, silently fall back to PIL where it does not
build, e.g. on a host without the libpng / libjpeg headers). This host-side
fallback is the decoder's documented mode; it has nothing to do with the
CUDA kernels, which never fall back.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "decode.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_ABI_VERSION = 2

_lock = threading.Lock()
_lib = None
_lib_failed = False
_lib_error: Exception | None = None


def _require_native() -> bool:
    return os.environ.get("CUTMIX_SEG_NATIVE_DECODE") == "1"


def _max_pixels():
    """Mirror PIL's decompression-bomb ceiling: images whose header declares
    more pixels than this are routed to PIL, which applies its own bomb
    warning/error — the native path must not out-allocate the PIL path it
    replaces. Honors user overrides of Image.MAX_IMAGE_PIXELS (None = off)."""
    from PIL import Image

    return Image.MAX_IMAGE_PIXELS


def library_path() -> str:
    """The source-hash-keyed path of the built library."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    return str(BUILD_DIR / f"_decode-{tag}.so")


def _compile_library() -> str:
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a temp name + atomic rename: concurrent processes race safely
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O2", "-fPIC", "-shared", "-o", tmp, _SRC,
           "-lpng", "-ljpeg", "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, so_path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return so_path


def _load():
    global _lib, _lib_failed, _lib_error
    if _lib is not None:
        return _lib
    if _lib_failed:
        # 'require native' must fail loudly on EVERY call, not only the first
        if _lib_error is not None and _require_native():
            raise RuntimeError(
                "CUTMIX_SEG_NATIVE_DECODE=1 but the native decoder is "
                "unavailable") from _lib_error
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _lib_failed:
            # a thread that lost the init race must honour require-native the
            # same way the outside-lock path does, not silently fall to PIL
            if _lib_error is not None and _require_native():
                raise RuntimeError(
                    "CUTMIX_SEG_NATIVE_DECODE=1 but the native decoder is "
                    "unavailable") from _lib_error
            return None
        mode = os.environ.get("CUTMIX_SEG_NATIVE_DECODE", "auto")
        if mode == "0":
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(_compile_library())
            lib.cutmix_decode_probe.restype = ctypes.c_int
            lib.cutmix_decode_probe.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.cutmix_decode.restype = ctypes.c_int
            lib.cutmix_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
            lib.cutmix_encode_png.restype = ctypes.c_int
            lib.cutmix_encode_png.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t)]
            lib.cutmix_free.restype = None
            lib.cutmix_free.argtypes = [ctypes.c_void_p]
            lib.cutmix_decode_abi_version.restype = ctypes.c_int
            if lib.cutmix_decode_abi_version() != _ABI_VERSION:
                raise RuntimeError("stale native decode library (ABI mismatch)")
            _lib = lib
        except Exception as e:
            _lib_failed = True
            _lib_error = e
            if mode == "1":
                raise
        return _lib


def native_available() -> bool:
    """True when the native decoder built/loaded (may trigger the build)."""
    return _load() is not None


def build_error() -> Exception | None:
    """Why the native decoder is unavailable (None when it loaded or has
    not been tried)."""
    return _lib_error


def _decode_native(data: bytes):
    """Native decode; None when the library is unavailable or the image falls
    outside the supported subset (caller falls back to PIL).

    The probe + decode pair parses the container header twice; the probe
    costs far less than the pixel decode of dataset-sized images, so a
    parse-once API is not worth the extra C surface."""
    lib = _load()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    ch = ctypes.c_int()
    rc = lib.cutmix_decode_probe(data, len(data),
                                 ctypes.byref(h), ctypes.byref(w),
                                 ctypes.byref(ch))
    if rc != 0:
        return None
    # decompression-bomb guard: header dimensions are untrusted; oversized
    # declarations go to PIL, which raises its DecompressionBomb error/warning
    # instead of this path allocating multi-GB buffers
    cap = _max_pixels()
    if cap is not None and h.value * w.value > cap:
        return None
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, ch.value)
    out = np.empty(shape, np.uint8)
    rc = lib.cutmix_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        return None
    return out


def _decode_pil(data: bytes) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    img.load()
    return np.array(img)


def _encode_native(arr: np.ndarray):
    """Native PNG encode; None when unavailable or unsupported (caller falls
    back to PIL). Supports uint8 (H,W) / (H,W,3) and uint16 (H,W)."""
    lib = _load()
    if lib is None:
        return None
    if arr.ndim == 2:
        channels = 1
    elif arr.ndim == 3 and arr.shape[2] == 3:
        channels = 3
    else:
        return None
    if arr.dtype == np.uint8:
        depth = 8
    elif arr.dtype == np.uint16 and channels == 1:
        depth = 16
    else:
        return None
    arr = np.ascontiguousarray(arr)
    out = ctypes.c_void_p()
    out_len = ctypes.c_size_t()
    rc = lib.cutmix_encode_png(
        arr.ctypes.data_as(ctypes.c_void_p), arr.shape[0], arr.shape[1],
        channels, depth, ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        return None
    try:
        return ctypes.string_at(out.value, out_len.value)
    finally:
        lib.cutmix_free(out)


def encode_png(arr: np.ndarray) -> bytes:
    """Encode a label map / image to PNG bytes (native, PIL fallback).

    Content-parity with the PIL path: the encoded file decodes back to the
    same array (byte streams may differ -- PNG encoders choose filters
    freely). uint32 label maps are narrowed to uint16, matching what PIL
    stores for mode-I arrays (PNG has no 32-bit depth)."""
    from PIL import Image

    if arr.dtype in (np.uint32, np.int32, np.int64):
        if (arr.ndim == 2 and arr.size > 0
                and arr.min() >= 0 and arr.max() < 65536):
            arr = arr.astype(np.uint16)
        else:
            # PIL's fromarray rejects '<i8' etc. with an opaque KeyError;
            # fail with an actionable message instead
            raise ValueError(
                f"encode_png: cannot narrow {arr.dtype} array of shape "
                f"{arr.shape} to uint16 (need 2-D, non-empty, values in "
                f"[0, 65536)); convert explicitly before encoding")
    data = _encode_native(arr)
    if data is not None:
        return data
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return buf.getvalue()


def decode_array(data: bytes) -> np.ndarray:
    """Decode PNG/JPEG bytes to the ``np.array(Image.open(...))`` array.

    Palette PNGs yield raw indices (H, W) -- the contract the label pipeline
    relies on (reference: pascal_voc_dataset.py label reads via
    ``np.array(Image.open(...))``).
    """
    arr = _decode_native(data)
    if arr is None:
        arr = _decode_pil(data)
    return arr
