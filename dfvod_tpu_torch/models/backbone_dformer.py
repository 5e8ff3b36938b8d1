"""DFormer depth backbone, the 1-channel downsample path (counterpart of
``dfvod_tpu/models/backbone_dformer.py``).

stem = Conv3x3 s2 -> BN -> exact GELU -> Conv3x3 s2 -> BN (dims[0] = 32),
then per stage BN -> Conv3x3 s2; output stride 16, 128 channels. The BNs
are trainable: in ``train()`` mode they normalize with the batch's
statistics and update their running statistics as flax does, in
``eval()`` mode they use the running statistics (eps 1e-5). The JAX
package's space-to-depth stem (``Conv3x3S2D``, off by default and reached
by no configuration) is an exact reparameterization of the 3x3/s2 conv
that keeps its parameter; the port runs that conv as it is (a host-packed
s2d frame is unpacked on the device first).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dfvod_tpu_torch.models.backbone_resnet import downsample_mask
from dfvod_tpu_torch.parallel.dist import all_reduce_sum, world


class BatchNorm(nn.Module):
    """BatchNorm (NCHW, eps 1e-5): affine parameters plus running
    statistics, the flax ``params`` + ``batch_stats`` pair
    (``dfvod_tpu/models/backbone_dformer.py:25-27``).

    In ``train()`` mode it normalizes with the batch mean and the *biased*
    batch variance, both in f32, and updates ``running = (1 - momentum) *
    running + momentum * batch`` with that same biased variance, as flax's
    ``nn.BatchNorm(momentum=0.9)`` does. ``F.batch_norm(training=True)``
    would update ``running_var`` with the unbiased variance instead. The
    running statistics stay f32 whatever dtype the activations have.

    With a process group of more than one rank in ``group``
    (``set_batchnorm_group``), the statistics in training are the global
    batch's, as in the JAX package's one program over the global batch:
    the sum, the sum of squares and the count are all-reduced over the
    group by an all-reduce that carries gradients (``all_reduce_sum``),
    and the variance is flax's ``E[x^2] - E[x]^2`` (clamped at 0). Every
    rank's running statistics then take the same update. The reference's
    plain BN under DDP uses each card's own batch instead."""

    group = None

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        xf = x.float()
        if self.group is not None and world(self.group) > 1:
            var, mean = _global_var_mean(xf, self.group)
        else:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean.to(self.running_mean.dtype),
                                    self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype),
                                   self.momentum)
        scale = self.weight.float() * torch.rsqrt(var + self.eps)
        y = ((xf - mean[None, :, None, None]) * scale[None, :, None, None]
             + self.bias.float()[None, :, None, None])
        return y.to(x.dtype)


def _global_var_mean(xf, group):
    """(biased variance, mean) per channel of NCHW ``xf`` over every rank
    of ``group``, differentiable through the all-reduce."""
    C = xf.shape[1]
    count = torch.full((1,), float(xf.numel() // C), device=xf.device)
    stats = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)),
                                      xf.square().sum((0, 2, 3)), count]),
                           group=group)
    n = stats[-1]
    mean = stats[:C] / n
    var = (stats[C:2 * C] / n - mean.square()).clamp(min=0.0)
    return var, mean


def set_batchnorm_group(model: nn.Module, group):
    """Let every DFormer ``BatchNorm`` of ``model`` take its training
    statistics over ``group`` (None: this process's batch only)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


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
