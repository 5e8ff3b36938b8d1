"""Reading frames from disk: a baseline JPEG decoder in host C++
(``csrc/jpeg_decode.cpp``), bound with ctypes.

Counterpart of the JAX package's ``PIL.Image.open(...).convert("RGB")``
(``dfvod_tpu/data/dataset.py:162-174``) and ``cv2.imread(...,
IMREAD_UNCHANGED)`` (``:29``): the decoder follows libjpeg-turbo's
routines, so it gives their bits. Neither PIL nor cv2 is used here (the
card machine has neither). The library is built at first use
(``ops/build.py::load_host``); a failed build raises.

Each reader takes a path or the file's ``bytes``. Unsupported files
(progressive, arithmetic-coded, 12-bit, lossless, CMYK) and truncated ones
raise ``ValueError`` naming what they are; PNG waits for a later slice.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Union

import numpy as np

from dfvod_tpu_torch.ops import build

Source = Union[str, os.PathLike, bytes]
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load_host("jpeg_decode")
    lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                                ctypes.c_int, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_strerror.argtypes = [ctypes.c_int]
    lib.jpeg_strerror.restype = ctypes.c_char_p
    return lib


def _read(src: Source):
    """(bytes, a name for messages)."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), "<bytes>"
    with open(src, "rb") as f:
        return f.read(), os.fspath(src)


def _header(data: bytes, name: str):
    if data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{name}: PNG (16-bit depth maps) waits for the PNG "
                         "and 16-bit depth slice; only JPEG is decoded")
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = _lib()
    code = lib.jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(c))
    if code:
        raise ValueError(f"{name}: {lib.jpeg_strerror(code).decode()}")
    return h.value, w.value, c.value


def _decode(data: bytes, name: str, h: int, w: int, channels: int):
    out = np.empty((h, w, channels), np.uint8)
    lib = _lib()
    code = lib.jpeg_decode(data, len(data),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           h, w, channels)
    if code:
        raise ValueError(f"{name}: {lib.jpeg_strerror(code).decode()}")
    return out


def read_image(src: Source) -> np.ndarray:
    """The file's own samples, as ``cv2.imread(IMREAD_UNCHANGED)`` gives
    them but in RGB order: (H, W) uint8 for a grayscale JPEG, (H, W, 3) for
    a colour one."""
    data, name = _read(src)
    h, w, c = _header(data, name)
    out = _decode(data, name, h, w, 1 if c == 1 else 3)
    return out[..., 0] if c == 1 else out


def read_rgb(src: Source) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``PIL.Image.open(src).convert("RGB")``: a
    grayscale file's samples are repeated in the three channels."""
    data, name = _read(src)
    h, w, _ = _header(data, name)
    return _decode(data, name, h, w, 3)


def read_gray(src: Source) -> np.ndarray:
    """(H, W) uint8 of a single-component JPEG; a colour file raises."""
    data, name = _read(src)
    h, w, c = _header(data, name)
    if c != 1:
        raise ValueError(f"{name}: has {c} channels (expected a "
                         "single-channel image)")
    return _decode(data, name, h, w, 1)[..., 0]
