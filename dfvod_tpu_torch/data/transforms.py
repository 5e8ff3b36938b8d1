"""Paired RGB-D geometric transforms on the host (counterpart of
``dfvod_tpu/data/transforms.py``), with the reference's semantics
(``datasets/transforms_single.py``, ``transforms_multi.py``):

- train: RandomHorizontalFlip(0.5) + RandomResize (short side drawn from
  ``short_sides``, long side capped at ``max_size``), one draw per clip
  (``vid_single.py:144-151``);
- eval: Resize(short side, max size) (``vid_single.py:152-157``);
- boxes become cxcywh normalized by the unpadded size.

Frames stay uint8: ``pad_u8`` writes them into the batch's canvas and the
train step and ``eval_forward`` normalize on the device
(``data/device_pipeline.py``), whether or not ``--device_preprocess`` is
set. Every resize goes through the port's host library
(``data/native.py``). The photometric ``strong_aug`` and the segmentation
masks wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dfvod_tpu_torch.data import native

# normalization statistics: RGB ImageNet and the DFormer depth statistics
# (``vid_single.py:133-142`` of the reference)
RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)
DEPTH_MEAN, DEPTH_STD = 0.48, 0.28


@dataclasses.dataclass
class Sample:
    """One frame and its targets, boxes in absolute xyxy."""
    rgb: np.ndarray                     # (H, W, 3) uint8
    depth: Optional[np.ndarray]         # (H, W) uint8 or None
    boxes: np.ndarray                   # (T, 4) xyxy float32
    labels: np.ndarray                  # (T,) int64
    image_id: int = 0
    orig_size: Tuple[int, int] = (0, 0)  # (H, W)


def resize_short_side(h: int, w: int, short: int, max_size: int
                      ) -> Tuple[int, int]:
    """torchvision ``RandomResize`` target size: scale so the short side is
    ``short`` unless the long side would exceed ``max_size``."""
    mn, mx = min(h, w), max(h, w)
    if mx / mn * short > max_size:
        short = int(round(max_size * mn / mx))
    if (h <= w and h == short) or (w <= h and w == short):
        return h, w
    if h < w:
        return short, int(short * w / h)
    return int(short * h / w), short


def _resize(sample: Sample, short: int, max_size: int) -> Sample:
    h, w = sample.rgb.shape[:2]
    nh, nw = resize_short_side(h, w, short, max_size)
    if (nh, nw) == (h, w):
        return sample
    depth = sample.depth
    if depth is not None:
        depth = native.resize_bilinear_u8(depth, nh, nw)
    boxes = sample.boxes * np.array([nw / w, nh / h, nw / w, nh / h],
                                    np.float32)
    return dataclasses.replace(
        sample, rgb=native.resize_bilinear_u8(sample.rgb, nh, nw),
        depth=depth, boxes=boxes)


def _hflip(sample: Sample) -> Sample:
    w = sample.rgb.shape[1]
    depth = sample.depth[:, ::-1] if sample.depth is not None else None
    boxes = sample.boxes.copy()
    boxes[:, [0, 2]] = w - sample.boxes[:, [2, 0]]
    return dataclasses.replace(sample, rgb=sample.rgb[:, ::-1], depth=depth,
                               boxes=boxes)


def bucket_shape(h: int, w: int, bucket_step: int = 128,
                 max_size: int = 1344) -> Tuple[int, int]:
    """(h, w) rounded up to multiples of ``bucket_step``, capped at
    ``max_size``: the batch canvas's shape."""
    def up(v):
        return min(int(np.ceil(v / bucket_step)) * bucket_step, max_size)
    return up(h), up(w)


def pad_u8(sample: Sample, pad_hw: Tuple[int, int], use_depth: bool,
           max_boxes: int, out_img: Optional[np.ndarray] = None) -> dict:
    """The frame written into the top-left of a zeroed (ph, pw, C) uint8
    canvas (``out_img``, a slice of the batch canvas, or a new one), and
    its targets: labels (T,), boxes (T, 4) cxcywh normalized by the
    unpadded size, valid (T,), image_id, size and orig_size (h, w)."""
    h, w = sample.rgb.shape[:2]
    ph, pw = pad_hw
    if ph < h or pw < w:
        raise ValueError(f"frame {(h, w)} does not fit the canvas {pad_hw}")
    C = 4 if use_depth else 3
    out = np.zeros((ph, pw, C), np.uint8) if out_img is None else out_img
    if use_depth:
        if sample.depth is None:
            raise ValueError("use_depth without a depth map")
        native.pack_rgbd_u8(sample.rgb, sample.depth, out)
    else:
        out[:h, :w, :] = sample.rgb

    boxes = np.zeros((max_boxes, 4), np.float32)
    labels = np.zeros((max_boxes,), np.int64)
    valid = np.zeros((max_boxes,), bool)
    n = min(len(sample.boxes), max_boxes)
    if n:
        b = sample.boxes[:n]
        cxcywh = np.stack([(b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2,
                           b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], -1)
        boxes[:n] = cxcywh / np.array([w, h, w, h], np.float32)
        labels[:n] = sample.labels[:n]
        valid[:n] = True
    return {"image": out, "labels": labels, "boxes": boxes, "valid": valid,
            "image_id": sample.image_id,
            "size": np.array([h, w], np.int64),
            "orig_size": np.array(sample.orig_size, np.int64)}


def _no_strong_aug():
    raise NotImplementedError(
        "strong_aug (photometric distortion + MinIoURandomCrop) waits for "
        "the photometric slice (data/photometric.py)")


@dataclasses.dataclass
class TrainTransform:
    """HFlip + multi-scale resize; one draw shared across a clip, from the
    same ``rng`` calls in the same order as the JAX package."""
    short_sides: Sequence[int] = tuple(range(480, 801, 32))
    max_size: int = 1333
    strong_aug: bool = False

    def __post_init__(self):
        if self.strong_aug:
            _no_strong_aug()

    def __call__(self, frames: List[Sample], rng: np.random.Generator
                 ) -> List[Sample]:
        flip = rng.random() < 0.5
        short = int(rng.choice(np.asarray(self.short_sides)))
        return [_resize(_hflip(s) if flip else s, short, self.max_size)
                for s in frames]


@dataclasses.dataclass
class EvalTransform:
    short_side: int = 600
    max_size: int = 1333

    def __call__(self, frames: List[Sample],
                 rng: Optional[np.random.Generator] = None) -> List[Sample]:
        return [_resize(s, self.short_side, self.max_size) for s in frames]
