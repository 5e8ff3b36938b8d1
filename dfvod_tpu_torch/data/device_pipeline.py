"""On-device preprocessing: uint8 frames in, normalized image and padding
mask out (counterpart of ``dfvod_tpu/data/device_pipeline.py``).

The host ships uint8 frames, 4x fewer bytes than f32, and the [0, 1] scale,
mean/std normalization and padding mask run on the device. With
``--pack_s2d`` the host ships them 2x2 space-to-depth packed
(``pack_s2d``, the JAX package's channel order); ``normalize_frames``
dispatches on the 12 / 16 packed channels, and the model unpacks them
(``unpack_s2d``) before its stems.
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


# (dy, dx) of the four pixels of a 2x2 block, in packed channel order
S2D_OFFSETS = ((0, 0), (0, 1), (1, 0), (1, 1))


def pack_s2d(images_u8: np.ndarray) -> np.ndarray:
    """Host 2x2 space-to-depth of a uint8 batch: (B, H, W, C) ->
    (B, H/2, W/2, 4C) with C = 3 (RGB) or 4 (RGB-D), channels
    ``[R00 G00 B00 R01 ... B11 | D00 D01 D10 D11]``: the four RGB blocks
    in (dy, dx) order, then the four depth samples, so that the model
    splits RGB from depth by slicing (not ``F.pixel_unshuffle``'s order,
    which keeps a channel's four samples together)."""
    B, H, W, C = images_u8.shape
    if H % 2 or W % 2 or C not in (3, 4):
        raise ValueError(f"s2d packing takes (B, even H, even W, 3|4), got "
                         f"{images_u8.shape}")
    out = np.empty((B, H // 2, W // 2, 4 * C), images_u8.dtype)
    for k, (dy, dx) in enumerate(S2D_OFFSETS):
        part = images_u8[:, dy::2, dx::2, :]
        out[..., 3 * k:3 * k + 3] = part[..., :3]
        if C == 4:
            out[..., 12 + k] = part[..., 3]
    return out


def unpack_s2d(packed: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_s2d`` on any device and dtype: (B, H/2, W/2,
    12|16) -> (B, H, W, 3|4)."""
    B, H2, W2, C4 = packed.shape
    if C4 not in (12, 16):
        raise ValueError(f"s2d-packed frames have 12 or 16 channels, got "
                         f"{C4}")
    rgb = packed[..., :12].reshape(B, H2, W2, 2, 2, 3)
    if C4 == 16:
        rgb = torch.cat([rgb, packed[..., 12:].reshape(B, H2, W2, 2, 2, 1)],
                        -1)
    # (B, H2, dy, W2, dx, C) -> (B, H, W, C)
    return rgb.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H2, 2 * W2, -1)


def device_normalize_s2d(packed_u8: torch.Tensor, sizes: torch.Tensor):
    """``device_normalize`` of s2d-packed frames (``pack_s2d``): uint8
    (B, H/2, W/2, 12|16) + full-resolution content sizes (B, 2) -> (f32
    normalized packed image, bool padding mask (B, H, W) at full
    resolution). Each block's pixel is zeroed by its own (dy, dx)-shifted
    validity test, so unpacking gives ``device_normalize``'s image."""
    B, H2, W2, C4 = packed_u8.shape
    if C4 not in (12, 16):
        raise ValueError(f"s2d-packed frames have 12 or 16 channels, got "
                         f"{C4}")
    dev = packed_u8.device
    mean = np.concatenate([np.tile(RGB_MEAN, 4), [DEPTH_MEAN] * 4]
                          )[:C4].astype(np.float32)
    std = np.concatenate([np.tile(RGB_STD, 4), [DEPTH_STD] * 4]
                         )[:C4].astype(np.float32)
    x = packed_u8.to(torch.float32) * (1.0 / 255.0)
    x = (x - torch.from_numpy(mean).to(dev)) / torch.from_numpy(std).to(dev)
    sizes = sizes.to(dev)
    sh, sw = sizes[:, 0, None, None], sizes[:, 1, None, None]
    ys = torch.arange(H2, device=dev)[None, :, None]
    xs = torch.arange(W2, device=dev)[None, None, :]
    pad = torch.zeros(B, H2, W2, C4, dtype=torch.bool, device=dev)
    for k, (dy, dx) in enumerate(S2D_OFFSETS):
        blk = ((2 * ys + dy >= sh) | (2 * xs + dx >= sw))[..., None]
        pad[..., 3 * k:3 * k + 3] = blk
        if C4 == 16:
            pad[..., 12 + k:13 + k] = blk
    x = x.masked_fill(pad, 0.0)
    ys = torch.arange(2 * H2, device=dev)[None, :, None]
    xs = torch.arange(2 * W2, device=dev)[None, None, :]
    return x, (ys >= sh) | (xs >= sw)


def normalize_frames(images_u8: torch.Tensor, sizes: torch.Tensor):
    """The train step's, ``eval_forward``'s and ``Server``'s dispatch
    (``maybe_device_normalize`` of the JAX package): 12 or 16 channels are
    the s2d-packed form, anything else plain frames."""
    if images_u8.shape[-1] in (12, 16):
        return device_normalize_s2d(images_u8, sizes)
    return device_normalize(images_u8, sizes)
