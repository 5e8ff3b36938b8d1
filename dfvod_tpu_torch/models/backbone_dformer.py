"""DFormer depth backbone, the 1-channel downsample path (counterpart of
``dfvod_tpu/models/backbone_dformer.py``).

stem = Conv3x3 s2 -> BN -> exact GELU -> Conv3x3 s2 -> BN (dims[0] = 32),
then per stage BN -> Conv3x3 s2; output stride 16, 128 channels. The BNs use
their running statistics (eval mode, eps 1e-5); training-mode BN waits for
the training slice, and the space-to-depth stem (``Conv3x3S2D``, off by
default in the JAX package) for a later one.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dfvod_tpu_torch.models.backbone_resnet import downsample_mask


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm (NCHW, eps 1e-5): affine parameters plus
    running statistics, the flax ``params`` + ``batch_stats`` pair."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _conv(in_features: int, features: int) -> nn.Conv2d:
    return nn.Conv2d(in_features, features, 3, 2, 1, bias=True)


class DFormerDownsamplePath(nn.Module):
    """Depth feature extractor; returns the stride-16 feature map."""

    def __init__(self, dims: Sequence[int] = (32, 64, 128)):
        super().__init__()
        d0 = dims[0]
        self.dims = tuple(dims)
        self.stem_conv1 = _conv(1, d0 // 2)
        self.stem_bn1 = BatchNorm(d0 // 2)
        self.stem_conv2 = _conv(d0 // 2, d0)
        self.stem_bn2 = BatchNorm(d0)
        for i in range(len(dims) - 1):
            self.add_module(f"stage{i + 1}_bn", BatchNorm(dims[i]))
            self.add_module(f"stage{i + 1}_conv", _conv(dims[i], dims[i + 1]))

    def forward(self, x):
        """x: (B, H, W, 1) depth. Returns (B, H/16, W/16, dims[-1])."""
        x = x.permute(0, 3, 1, 2)
        x = self.stem_bn1(self.stem_conv1(x))
        x = F.gelu(x)                                   # exact (erf) form
        x = self.stem_bn2(self.stem_conv2(x))
        for i in range(len(self.dims) - 1):
            x = getattr(self, f"stage{i + 1}_bn")(x)
            x = getattr(self, f"stage{i + 1}_conv")(x)
        return x.permute(0, 2, 3, 1)


class DFormerBackbone(nn.Module):
    """Depth backbone producing a single stride-16 level + its mask."""

    def __init__(self, dims: Sequence[int] = (32, 64, 128)):
        super().__init__()
        self.downsample_path = DFormerDownsamplePath(dims)

    def forward(self, depth, mask):
        feat = self.downsample_path(depth)
        return feat, downsample_mask(mask, tuple(feat.shape[1:3]))
