"""ctypes bindings of the port's host-side background decoder,
``data/csrc/fastdata.cpp``.

Counterpart of ``layoutdetr_tpu/data/native.py``, with the same functions:

- ``available() -> bool``: whether the library builds and loads;
- ``decode_png(bytes) -> uint8 [H, W, 3]``;
- ``resize_lanczos(img, size) -> uint8 [size, size, 3]`` (PIL's LANCZOS
  within one level);
- ``load_background(bytes, size) -> float32 [size, size, 3]``: decode,
  Lanczos resize and ImageNet normalise in one call.

The library is compiled at first use by ``ops._build.build_host`` (``g++
-O3 -shared -fPIC ... -lz``) into a content-hashed file under ``build/``,
and loaded once a process. A failed build is remembered: ``available()``
then says False and the other functions raise ``RuntimeError`` with the
compiler's message. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Optional

import numpy as np

from layoutdetr_tpu_torch.ops import _build

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "fastdata.cpp")
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_U8P = ctypes.POINTER(ctypes.c_uint8)
_MAX_SIDE = 1 << 14  # a larger PNG is refused before its pixels are allocated

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the build or load failed, once it has


def library() -> ctypes.CDLL:
    """The loaded library, built on first use; ``RuntimeError`` if it does
    not build or load (the first failure is remembered, not retried)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(_build.build_host(SRC, ("-lz",)))
            except (RuntimeError, OSError) as e:
                _error = str(e)
            else:
                lib.fd_decode_png.restype = ctypes.c_int
                lib.fd_decode_png.argtypes = [ctypes.c_char_p, ctypes.c_int64, _U8P, ctypes.c_int64,
                                              ctypes.POINTER(ctypes.c_int),
                                              ctypes.POINTER(ctypes.c_int)]
                lib.fd_resize_lanczos.restype = ctypes.c_int
                lib.fd_resize_lanczos.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _U8P,
                                                  ctypes.c_int, ctypes.c_int]
                lib.fd_load_background.restype = ctypes.c_int
                lib.fd_load_background.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                                                   ctypes.POINTER(ctypes.c_float), _U8P,
                                                   ctypes.c_int64]
                _lib = lib
        if _lib is None:
            raise RuntimeError(f"fastdata did not build: {_error}")
        return _lib


def available() -> bool:
    try:
        library()
    except RuntimeError:
        return False
    return True


def _png_size(data: bytes) -> tuple:
    """(width, height) from the IHDR chunk, which a PNG holds first."""
    if len(data) < 24 or data[:8] != _PNG_MAGIC or data[12:16] != b"IHDR":
        raise ValueError("not a PNG (no signature and IHDR chunk)")
    w, h = struct.unpack(">II", data[16:24])
    if not 0 < w <= _MAX_SIDE or not 0 < h <= _MAX_SIDE:
        raise ValueError(f"PNG size {w} x {h} out of range")
    return w, h


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit gray, gray+alpha, RGB or RGBA) -> uint8 [H, W, 3]."""
    lib = library()
    w, h = _png_size(data)
    out = np.empty((h, w, 3), np.uint8)
    ow, oh = ctypes.c_int(), ctypes.c_int()
    rc = lib.fd_decode_png(data, len(data), out.ctypes.data_as(_U8P), out.size,
                           ctypes.byref(ow), ctypes.byref(oh))
    if rc != 0:
        raise ValueError(f"fd_decode_png failed: {rc}")
    return out


def resize_lanczos(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [size, size, 3], separable Lanczos-3."""
    lib = library()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or size <= 0:
        raise ValueError(f"resize_lanczos takes [H, W, 3] and a positive size, got "
                         f"{img.shape} and {size}")
    out = np.empty((size, size, 3), np.uint8)
    lib.fd_resize_lanczos(img.ctypes.data_as(_U8P), img.shape[1], img.shape[0],
                          out.ctypes.data_as(_U8P), size, size)
    return out


def load_background(data: bytes, size: int) -> np.ndarray:
    """PNG bytes -> ImageNet-normalised float32 [size, size, 3]."""
    lib = library()
    w, h = _png_size(data)
    dst = np.empty((size, size, 3), np.float32)
    scratch = np.empty(w * h * 3, np.uint8)
    rc = lib.fd_load_background(data, len(data), size,
                                dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                scratch.ctypes.data_as(_U8P), scratch.size)
    if rc != 0:
        raise ValueError(f"fd_load_background failed: {rc}")
    return dst
