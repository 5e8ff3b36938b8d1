"""Photometric and cropping clip augmentations on the host (counterpart
of ``dfvod_tpu/data/photometric.py``): ``MinIoURandomCrop`` and the
contrast / brightness / saturation / hue / lighting-noise stack of the
reference's ``datasets/transforms_multi.py:254-398``, which
``--strong_aug`` puts before the flip and resize.

Every op takes a list of ``Sample`` frames and one
``np.random.Generator``; one draw is shared by the clip, and the draws
are the JAX package's calls in its order, so one seed gives the same clip.

The JAX package converts RGB to HSV and back with OpenCV
(``cv2.COLOR_RGB2HSV_FULL`` / ``COLOR_HSV2RGB_FULL`` on uint8). The card
machine has no OpenCV, so the port carries its own integer versions in host
C++ (``csrc/photometric.cpp``, built at first use like the JPEG decoder):

- RGB -> HSV is OpenCV's fixed-point algorithm (12-bit reciprocal tables
  of the saturation and the 256-step hue).
- HSV -> RGB: OpenCV 5 computes it in float32 with the hue scaled by
  6/255, which rounds the exact value to the nearest integer except at
  92 of the 2^24 inputs, whose exact value lies within 1.2e-4 of a half
  and whose float32 sum lands on the other side. The exact value is
  computed in integers (rounded half up) and those 92 inputs are
  tabulated here (``_HSV2RGB_TIES``).

``tests/test_torch_photometric.py`` holds both conversions bitwise against
cv2 over all 2^24 inputs.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Sequence

import numpy as np

from dfvod_tpu_torch.data.transforms import Sample
from dfvod_tpu_torch.ops import build

# h << 16 | s << 8 | v -> r << 16 | g << 8 | b where OpenCV's float32
# rounding of an exact near-half differs from rounding half up
_HSV2RGB_TIES = {
    0x45d1b5: 0x58b521, 0x51a7c1: 0x4ec143, 0x51c1a7: 0x34a729,
    0x76f6d3: 0x07d3a6, 0x8080fe: 0x7ffcfe, 0x80fe80: 0x017e80,
    0x8bc7ce: 0x2da2ce, 0x8bcec7: 0x269bc7, 0x8e9ab6: 0x4890b6,
    0x8eb69a: 0x2c749a, 0x8ec48f: 0x21698f, 0x94c56a: 0x18426a,
    0x9798df: 0x5a95df, 0x97df98: 0x134e98, 0x9ab5d1: 0x3d74d1,
    0x9ad1b5: 0x2158b5, 0xa2c7ce: 0x2d4bce, 0xa2cec7: 0x2644c7,
    0xa4f2f6: 0x0d2df6, 0xa4f6f2: 0x0929f2, 0xa6a7c1: 0x434ec1,
    0xa6c1a7: 0x2934a7, 0xabbcd8: 0x3d39d8, 0xabcece: 0x2c28ce,
    0xabd8bc: 0x211dbc, 0xb3dbf3: 0x4f22f3, 0xb3f3db: 0x370adb,
    0xc072d3: 0xa675d3, 0xc089a4: 0x7a4ca4, 0xc0a489: 0x5f3189,
    0xc476e7: 0xbe7ce7, 0xc49ab1: 0x8846b1, 0xc4b19a: 0x712f9a,
    0xc4e776: 0x4d0b76, 0xc65ea3: 0x8f67a3, 0xc6a35e: 0x4a225e,
    0xcab1f2: 0xc94af2, 0xcaf2b1: 0x8809b1, 0xcbd3f6: 0xc92af6,
    0xcbf6d3: 0xa607d3, 0xcec9fd: 0xdf36fd, 0xcefdc9: 0xab02c9,
    0xd3b3de: 0xd942de, 0xd3deb3: 0xae17b3, 0xd4dff3: 0xf11ef3,
    0xd4f3df: 0xdd0adf, 0xd580fe: 0xfe7ffc, 0xd5fe80: 0x80017e,
    0xdfeff4: 0xf40fbb, 0xdff4ef: 0xef0ab6, 0xe0c7ce: 0xce2da2,
    0xe0cec7: 0xc7269b, 0xe38fc4: 0xc4569e, 0xe39ab6: 0xb64890,
    0xe3b69a: 0x9a2c74, 0xe3badb: 0xdb3ba4, 0xe3c48f: 0x8f2169,
    0xe3dbba: 0xba1a83, 0xe4aedb: 0xdb46a4, 0xe4dbae: 0xae1977,
    0xe7b0e4: 0xe4479f, 0xe7c0d1: 0xd1348c, 0xe7d1c0: 0xc0237b,
    0xe7e4b0: 0xb0136b, 0xe96ac5: 0xc5739d, 0xe9c56a: 0x6a1842,
    0xec6579: 0x79495e, 0xec7965: 0x65354a, 0xec98df: 0xdf5a95,
    0xecdf98: 0x98134e, 0xed748f: 0x8f4e69, 0xed8f74: 0x74334e,
    0xedb9d6: 0xd63b7c, 0xedd6b9: 0xb91e5f, 0xefb5d1: 0xd13d74,
    0xefc552: 0x52132a, 0xefc5f6: 0xf6387f, 0xefd1b5: 0xb52158,
    0xeff6c5: 0xc5074e, 0xf194b0: 0xb04a6b, 0xf1b094: 0x942e4f,
    0xf1e4f1: 0xf11a60, 0xf1f1e4: 0xe40d53, 0xf4b89e: 0x9e2c49,
    0xf7c7ce: 0xce2d4b, 0xf7cec7: 0xc72644, 0xf9beda: 0xda384e,
    0xf9dabe: 0xbe1c32, 0xf9f2f6: 0xf60d2d, 0xf9f6f2: 0xf20929,
    0xfba7c1: 0xc1434e, 0xfbc1a7: 0xa72934,
}
_TIE_KEYS = np.array(sorted(_HSV2RGB_TIES), np.int32)
_TIE_VALUES = np.array([_HSV2RGB_TIES[k] for k in sorted(_HSV2RGB_TIES)],
                       np.int32)


_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load_host("photometric")
    lib.rgb_to_hsv_u8.argtypes = [_U8P, ctypes.c_int64, _U8P]
    lib.rgb_to_hsv_u8.restype = None
    lib.hsv_to_rgb_u8.argtypes = [_U8P, ctypes.c_int64, _I32P, _I32P,
                                  ctypes.c_int, _U8P]
    lib.hsv_to_rgb_u8.restype = None
    return lib


def _pixels(x: np.ndarray, what: str) -> np.ndarray:
    if x.dtype != np.uint8 or x.shape[-1:] != (3,):
        raise ValueError(f"{what} takes uint8 (..., 3), got {x.dtype} "
                         f"{x.shape}")
    return np.ascontiguousarray(x)


def rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """uint8 (..., 3) RGB -> uint8 (..., 3) HSV with hue over 0..255, as
    ``cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV_FULL)``."""
    x = _pixels(rgb, "rgb_to_hsv_u8")
    out = np.empty_like(x)
    _lib().rgb_to_hsv_u8(x.ctypes.data_as(_U8P), x.size // 3,
                         out.ctypes.data_as(_U8P))
    return out


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """uint8 (..., 3) HSV with hue over 0..255 -> uint8 (..., 3) RGB, as
    ``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB_FULL)``."""
    x = _pixels(hsv, "hsv_to_rgb_u8")
    out = np.empty_like(x)
    _lib().hsv_to_rgb_u8(x.ctypes.data_as(_U8P), x.size // 3,
                         _TIE_KEYS.ctypes.data_as(_I32P),
                         _TIE_VALUES.ctypes.data_as(_I32P), len(_TIE_KEYS),
                         out.ctypes.data_as(_U8P))
    return out


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ix = (np.minimum(a[:, None, 2], b[None, :, 2])
          - np.maximum(a[:, None, 0], b[None, :, 0])).clip(0)
    iy = (np.minimum(a[:, None, 3], b[None, :, 3])
          - np.maximum(a[:, None, 1], b[None, :, 1])).clip(0)
    inter = ix * iy
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter,
                              1e-9)


@dataclasses.dataclass
class MinIoURandomCrop:
    """``transforms_multi.py:254-312``: a crop whose IoU with every box
    reaches a threshold drawn from ``min_ious`` and that holds every box
    centre; boxes are clipped and shifted, and instance masks cropped (the
    JAX package leaves them whole, ROADMAP.md known differences). The
    first frame's boxes decide the crop of the whole clip."""
    min_ious: Sequence[float] = (0.1, 0.3, 0.5, 0.7, 0.9)
    min_crop_size: float = 0.3
    max_tries: int = 50

    def __call__(self, frames: List[Sample], rng: np.random.Generator
                 ) -> List[Sample]:
        h, w = frames[0].rgb.shape[:2]
        mode = rng.choice((1.0, *self.min_ious, 0.0))
        if mode == 1.0:
            return frames
        boxes = frames[0].boxes
        for _ in range(self.max_tries):
            nw = rng.uniform(self.min_crop_size * w, w)
            nh = rng.uniform(self.min_crop_size * h, h)
            if nh / nw < 0.5 or nh / nw > 2:
                continue
            left = rng.uniform(0, w - nw)
            top = rng.uniform(0, h - nh)
            patch = np.array([int(left), int(top), int(left + nw),
                              int(top + nh)], np.float32)
            if patch[2] <= patch[0] or patch[3] <= patch[1]:
                continue
            if len(boxes):
                if _iou_xyxy(patch[None], boxes).min() < mode:
                    continue
                centers = (boxes[:, :2] + boxes[:, 2:]) / 2
                if not ((centers > patch[:2]) & (centers < patch[2:])
                        ).all():
                    continue
            x0, y0, x1, y1 = patch.astype(int)
            out = []
            for f in frames:
                b = f.boxes.copy()
                if len(b):
                    b[:, 2:] = b[:, 2:].clip(max=patch[2:])
                    b[:, :2] = b[:, :2].clip(min=patch[:2])
                    b -= np.tile(patch[:2], 2)
                out.append(dataclasses.replace(
                    f, rgb=f.rgb[y0:y1, x0:x1],
                    depth=(f.depth[y0:y1, x0:x1]
                           if f.depth is not None else None),
                    masks=(f.masks[:, y0:y1, x0:x1]
                           if f.masks is not None else None),
                    boxes=b, orig_size=(y1 - y0, x1 - x0)))
            return out
        return frames


def _apply_rgb(frames, fn):
    """``fn`` on each frame's RGB as float32, clipped to 0..255 and
    truncated to uint8."""
    return [dataclasses.replace(
        f, rgb=np.clip(fn(f.rgb.astype(np.float32)), 0, 255
                       ).astype(np.uint8)) for f in frames]


def _hsv_op(x, fn):
    """float32 RGB -> HSV (as float32) -> ``fn`` in place -> RGB float32,
    each conversion on uint8 as the JAX package's cv2 calls take it."""
    hsv = rgb_to_hsv_u8(x.astype(np.uint8)).astype(np.float32)
    fn(hsv)
    return hsv_to_rgb_u8(np.clip(hsv, 0, 255).astype(np.uint8)
                         ).astype(np.float32)


@dataclasses.dataclass
class RandomContrast:
    lower: float = 0.5
    upper: float = 1.5

    def __call__(self, frames, rng):
        if rng.integers(2):
            alpha = rng.uniform(self.lower, self.upper)
            return _apply_rgb(frames, lambda x: x * alpha)
        return frames


@dataclasses.dataclass
class RandomBrightness:
    delta: float = 32.0

    def __call__(self, frames, rng):
        if rng.integers(2):
            d = rng.uniform(-self.delta, self.delta)
            return _apply_rgb(frames, lambda x: x + d)
        return frames


@dataclasses.dataclass
class RandomSaturation:
    """Scales the HSV saturation channel (``:340-351``)."""
    lower: float = 0.5
    upper: float = 1.5

    def __call__(self, frames, rng):
        if rng.integers(2):
            alpha = rng.uniform(self.lower, self.upper)

            def scale(hsv):
                hsv[..., 1] = np.clip(hsv[..., 1] * alpha, 0, 255)

            return _apply_rgb(frames, lambda x: _hsv_op(x, scale))
        return frames


@dataclasses.dataclass
class RandomHue:
    """Shifts the HSV hue channel (``:353-367``)."""
    delta: float = 18.0

    def __call__(self, frames, rng):
        if rng.integers(2):
            d = rng.uniform(-self.delta, self.delta) * 255.0 / 360.0

            def shift(hsv):
                hsv[..., 0] = (hsv[..., 0] + d) % 255.0

            return _apply_rgb(frames, lambda x: _hsv_op(x, shift))
        return frames


_PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1),
          (2, 1, 0))


@dataclasses.dataclass
class RandomLightingNoise:
    """Random RGB channel permutation (``:369-380``)."""

    def __call__(self, frames, rng):
        if rng.integers(2):
            perm = _PERMS[rng.integers(len(_PERMS))]
            return _apply_rgb(frames, lambda x: x[..., list(perm)])
        return frames


@dataclasses.dataclass
class PhotometricDistortion:
    """The distortion stack in the reference's order."""
    ops: tuple = (RandomBrightness(), RandomContrast(), RandomSaturation(),
                  RandomHue(), RandomLightingNoise())

    def __call__(self, frames, rng):
        for op in self.ops:
            frames = op(frames, rng)
        return frames
