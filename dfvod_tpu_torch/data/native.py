"""ctypes bindings of the data path's host resize and RGB-D interleave
(``csrc/preprocess.cpp``; counterpart of ``dfvod_tpu/data/native.py:62-115``).

The library is built from the checkout with the host C++ compiler at first
use (``ops/build.py::load_host``). A failed build or load raises: there is
no Python fallback. ctypes releases the GIL around each call, so the
loader's threads resize in parallel with the train step.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from dfvod_tpu_torch.ops import build

_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load_host("preprocess")
    lib.resize_bilinear_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _U8P, ctypes.c_int,
                                       ctypes.c_int]
    lib.resize_bilinear_u8.restype = None
    lib.pack_rgbd_u8.argtypes = [_U8P, _U8P, ctypes.c_int, ctypes.c_int,
                                 _U8P, ctypes.c_int64]
    lib.pack_rgbd_u8.restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def resize_bilinear_u8(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 (H, W) or (H, W, C) -> the same layout at (dh, dw):
    half-pixel bilinear."""
    if src.dtype != np.uint8 or src.ndim not in (2, 3):
        raise ValueError(f"resize takes uint8 (H, W[, C]), got {src.dtype} "
                         f"{src.shape}")
    if dh < 1 or dw < 1:
        raise ValueError(f"resize to ({dh}, {dw})")
    img = np.ascontiguousarray(src if src.ndim == 3 else src[..., None])
    sh, sw, c = img.shape
    dst = np.empty((dh, dw, c), np.uint8)
    _lib().resize_bilinear_u8(_ptr(img), sh, sw, c, _ptr(dst), dh, dw)
    return dst if src.ndim == 3 else dst[..., 0]


def pack_rgbd_u8(rgb: np.ndarray, depth: np.ndarray, out: np.ndarray):
    """Interleave (h, w, 3) RGB and (h, w) depth into the top-left of
    ``out``, a (ph, pw, 4) uint8 canvas slice with contiguous rows, in
    place."""
    h, w = rgb.shape[:2]
    if (rgb.dtype != np.uint8 or depth.dtype != np.uint8
            or rgb.shape != (h, w, 3) or depth.shape != (h, w)):
        raise ValueError(f"pack takes uint8 (h, w, 3) + (h, w), got "
                         f"{rgb.dtype} {rgb.shape} + {depth.dtype} "
                         f"{depth.shape}")
    if (out.dtype != np.uint8 or out.ndim != 3 or out.shape[-1] != 4
            or out.shape[0] < h or out.shape[1] < w
            or out.strides[1:] != (4, 1)):
        raise ValueError(f"pack writes a uint8 (>= {h}, >= {w}, 4) canvas "
                         f"with contiguous rows, got {out.dtype} "
                         f"{out.shape} strides {out.strides}")
    rgb = np.ascontiguousarray(rgb)
    depth = np.ascontiguousarray(depth)
    _lib().pack_rgbd_u8(_ptr(rgb), _ptr(depth), h, w,
                        out.ctypes.data_as(_U8P), out.strides[0])
