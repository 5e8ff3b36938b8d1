"""On-device preprocessing: uint8 frames in, normalized image and padding
mask out (counterpart of ``dfvod_tpu/data/device_pipeline.py``).

The host ships uint8 frames, 4x fewer bytes than f32, and the [0, 1] scale,
mean/std normalization and padding mask run on the device. The s2d packing
(``pack_s2d``) waits for a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from dfvod_tpu_torch.data.transforms import (
    DEPTH_MEAN,
    DEPTH_STD,
    RGB_MEAN,
    RGB_STD,
)


def device_normalize(images_u8: torch.Tensor, sizes: torch.Tensor):
    """uint8 (B, H, W, C) + content sizes (B, 2) as (h, w) -> (f32
    normalized image (B, H, W, C), bool padding mask (B, H, W), True = pad).
    The padded region is zeroed."""
    B, H, W, C = images_u8.shape
    dev = images_u8.device
    mean = np.concatenate([RGB_MEAN, [DEPTH_MEAN]])[:C].astype(np.float32)
    std = np.concatenate([RGB_STD, [DEPTH_STD]])[:C].astype(np.float32)
    x = images_u8.to(torch.float32) * (1.0 / 255.0)
    x = (x - torch.from_numpy(mean).to(dev)) / torch.from_numpy(std).to(dev)
    sizes = sizes.to(dev)
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    mask = (ys >= sizes[:, 0, None, None]) | (xs >= sizes[:, 1, None, None])
    x = x.masked_fill(mask[..., None], 0.0)
    return x, mask
