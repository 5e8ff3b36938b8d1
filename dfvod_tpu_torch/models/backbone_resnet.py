"""ResNet-50 with FrozenBatchNorm (counterpart of
``dfvod_tpu/models/backbone_resnet.py``).

The public layout is channels-last: ``ResNet50`` takes ``(B, H, W, 3)`` and
returns ``(B, h, w, C)`` stage outputs. Inside, the convolutions run NCHW;
a channels-last input permuted to NCHW is already in
``torch.channels_last`` memory order, which cuDNN prefers.

Submodules carry the flax module names (``layer1.block_0.conv1``, ...) so
that ``utils/convert.py`` maps weights mechanically. The JAX package's
``StemConvS2D`` is an exact reparameterization of the 7x7/s2/p3 stem that
keeps the ``(7, 7, 3, 64)`` parameter; the port runs that conv as it is.

Each FrozenBN runs with what follows it as one epilogue pass over its
conv's output (``ops/frozen_bn_act.py``, a hand-written kernel on the
card): ``act(x * s + b + R)``, with the ReLU and, at a bottleneck's last
FrozenBN, the identity or the downsample's FrozenBN'd conv as R. The
constants are ``FrozenBatchNorm.fold`` cast to the input's dtype, kept
until a FrozenBN buffer changes (``FrozenBatchNorm.folded``); the sum is
f32, rounded once. The stem and each ``Bottleneck`` make 49 such passes a
ResNet-50 forward.

``ResNet50.fused_stages`` (False by default, as in the JAX package) runs
layer1 in bf16 eval through the fused bottleneck stage
(``ops/fused_bottleneck.py``, K6 on the card), with FrozenBN folded into
the weights (``Bottleneck.folded_weights``).

Under ``ops/quant.int8_mode`` each ``Bottleneck`` runs the JAX package's
W8A8 path (``Bottleneck._int8_call``): FrozenBN folded into each conv's
weights, the bias added after dequantization, one seam tag
``conv{K}x{K}_c{Cin}`` per conv; a conv the seam allowlist leaves out
runs ``bn(conv(x))``. With ``fused_stages``, layer1 stays on the fused
stage, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dfvod_tpu_torch.ops import quant
from dfvod_tpu_torch.ops.frozen_bn_act import acc_dtype, frozen_bn_act
from dfvod_tpu_torch.ops.fused_bottleneck import fused_bottleneck_stage
from dfvod_tpu_torch.utils.weight_cache import WeightCache


class FrozenBatchNorm(nn.Module):
    """BN with fixed statistics and affine parameters, all buffers."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self._folded = WeightCache()

    def fold(self):
        """(scale, bias) of the equivalent affine map, in the stored
        dtype."""
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        return scale, self.bias - self.running_mean * scale

    def folded(self, dtype):
        """(scale, bias) for an input of ``dtype``: ``fold()`` cast to
        ``dtype`` (as the JAX package casts it), then held in f32 (f64 for
        f64), the form ``frozen_bn_act`` takes. Kept until a buffer is
        replaced or written in place, ``dtype`` changes or inference mode
        is entered or left (autograd cannot save a tensor made in it):
        ``WeightCache``, no fold per call."""
        def make():
            return tuple(t.to(dtype).to(acc_dtype(dtype))
                         for t in self.fold())
        return self._folded.get(
            (self.weight, self.bias, self.running_mean, self.running_var),
            make, (dtype, torch.is_inference_mode_enabled()))

    def forward(self, x, relu=False, residual=None, residual_bn=None):
        """``act(bn(x) + R)`` in one pass (NCHW): ``act`` ReLU where
        ``relu``; R the ``residual`` itself or, with ``residual_bn``,
        ``residual_bn(residual)``; nothing by default."""
        scale, bias = self.folded(x.dtype)
        res_scale = res_bias = None
        if residual_bn is not None:
            res_scale, res_bias = residual_bn.folded(x.dtype)
        return frozen_bn_act(x, scale, bias, residual, res_scale, res_bias,
                             relu)


def conv(in_features: int, features: int, kernel: int, stride: int = 1,
         dilation: int = 1) -> nn.Conv2d:
    """Bias-free conv with torch-style symmetric padding."""
    return nn.Conv2d(in_features, features, kernel, stride,
                     padding=dilation * (kernel - 1) // 2, dilation=dilation,
                     bias=False)


class Bottleneck(nn.Module):
    """torchvision Bottleneck block (1x1 -> 3x3 -> 1x1, expansion 4)."""

    def __init__(self, in_features: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        p = planes
        self.conv1 = conv(in_features, p, 1)
        self.bn1 = FrozenBatchNorm(p)
        self.conv2 = conv(p, p, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(p)
        self.conv3 = conv(p, p * 4, 1)
        self.bn3 = FrozenBatchNorm(p * 4)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = conv(in_features, p * 4, 1, stride)
            self.downsample_bn = FrozenBatchNorm(p * 4)
        self._quantized = {}

    def forward(self, x):
        if quant.enabled():
            return self._int8_forward(x)
        out = self.bn1(self.conv1(x), relu=True)
        out = self.bn2(self.conv2(out), relu=True)
        if self.downsample:
            return self.bn3(self.conv3(out), relu=True,
                            residual=self.downsample_conv(x),
                            residual_bn=self.downsample_bn)
        return self.bn3(self.conv3(out), relu=True, residual=x)

    def _int8_conv(self, x, conv_name, bn_name):
        """``bn(conv(x))`` in W8A8 when the conv's seam tag is allowed:
        ``weight.float() * scale`` quantized per output channel (kept
        until a weight or FrozenBN constant changes), the folded bias
        added after dequantization in the output's dtype."""
        cv, bn = getattr(self, conv_name), getattr(self, bn_name)
        k = cv.kernel_size[0]
        if not quant.enabled(f"conv{k}x{k}_c{x.shape[1]}"):
            return bn(cv(x))
        quant.refuse_autograd(cv.weight)

        def make():
            s, b = bn.fold()
            return (*quant.quantize_conv_weight(
                cv.weight.float() * s[:, None, None, None]), b)
        cache = self._quantized.setdefault(conv_name, WeightCache())
        wq, sw, b = cache.get((cv.weight, bn.weight, bn.bias,
                               bn.running_mean, bn.running_var), make)
        p = cv.padding[0]
        y = quant.conv_q(x, wq, sw, cv.stride, ((p, p), (p, p)), cv.dilation)
        return y + b.to(y.dtype)[None, :, None, None]

    def _int8_forward(self, x):
        """``dfvod_tpu/models/backbone_resnet.py::Bottleneck._int8_call``."""
        identity = x
        out = F.relu(self._int8_conv(x, "conv1", "bn1"))
        out = F.relu(self._int8_conv(out, "conv2", "bn2"))
        out = self._int8_conv(out, "conv3", "bn3")
        if self.downsample:
            identity = self._int8_conv(x, "downsample_conv", "downsample_bn")
        return F.relu(out + identity)

    def folded_weights(self, dtype):
        """(w1, b1, w2, b2, w3, b3, wd, bd) with FrozenBN folded in, as
        ``dfvod_tpu/models/backbone_resnet.py::Bottleneck.folded_weights``:
        ``weight.float() * scale`` in matmul layouts ((Cin, Cout) and
        HWIO), cast to ``dtype``; biases f32. The scale and bias come from
        ``FrozenBatchNorm.fold`` in the stored dtype (bf16 after the
        serving cast, as the JAX package folds its bf16-cast constants)."""
        def fold(cv, bn, squeeze):
            s, b = bn.fold()
            w = (cv.weight.float() * s.float()[:, None, None, None]
                 ).permute(2, 3, 1, 0)                    # HWIO
            if squeeze:
                w = w[0, 0]
            return w.to(dtype).contiguous(), b.float()

        w1, b1 = fold(self.conv1, self.bn1, True)
        w2, b2 = fold(self.conv2, self.bn2, False)
        w3, b3 = fold(self.conv3, self.bn3, True)
        wd = bd = None
        if self.downsample:
            wd, bd = fold(self.downsample_conv, self.downsample_bn, True)
        return (w1, b1, w2, b2, w3, b3, wd, bd)


class ResNetStage(nn.Module):
    """A stage of bottlenecks. With ``allow_fused``, in eval mode, at
    stride 1 without dilation, on a bf16 input, the whole stage runs
    through ``fused_bottleneck_stage`` (the JAX package's conditions,
    ``ResNetStage.__call__``)."""

    def __init__(self, planes: int, blocks: int, stride: int = 1,
                 dilate: bool = False, allow_fused: bool = True):
        super().__init__()
        self.stride, self.dilate, self.allow_fused = stride, dilate, allow_fused
        self._fold = WeightCache()
        # torchvision wiring: layer1 reads the 64-ch stem, layerN the
        # previous stage's planes * 2
        in_features = 64 if planes == 64 else planes * 2
        # replace_stride_with_dilation: the stage keeps stride 1 and later
        # blocks dilate; the first block uses the previous dilation (1 for
        # layer4 in DC5 ResNet-50)
        first_stride = 1 if dilate else stride
        dil = stride if dilate else 1
        self.blocks = blocks
        for i in range(blocks):
            if i == 0:
                blk = Bottleneck(in_features, planes, first_stride, 1,
                                 downsample=True)
            else:
                blk = Bottleneck(planes * 4, planes, 1, dil)
            self.add_module(f"block_{i}", blk)

    def forward(self, x):                       # NCHW
        blocks = [getattr(self, f"block_{i}") for i in range(self.blocks)]
        if (self.allow_fused and not self.training and self.stride == 1
                and not self.dilate and x.dtype == torch.bfloat16):
            # channels-last memory: the NHWC view is contiguous, no copy
            y = fused_bottleneck_stage(x.permute(0, 2, 3, 1),
                                       self.folded_weights(x.dtype))
            return y.permute(0, 3, 1, 2)
        for b in blocks:
            x = b(x)
        return x

    def folded_weights(self, dtype):
        """Every block's ``folded_weights(dtype)``. Where autograd records
        nothing (serving), the fold is kept and reused until a weight or
        FrozenBN constant of the stage changes, or ``dtype`` does
        (``WeightCache``)."""
        blocks = [getattr(self, f"block_{i}") for i in range(self.blocks)]
        if torch.is_grad_enabled():
            return [b.folded_weights(dtype) for b in blocks]
        return self._fold.get([*self.parameters(), *self.buffers()],
                              lambda: [b.folded_weights(dtype)
                                       for b in blocks], dtype)


def max_pool_torch(x, window: int, stride: int, pad: int):
    """Max pool with explicit symmetric padding (NCHW)."""
    return F.max_pool2d(x, window, stride, pad)


class ResNet50(nn.Module):
    """ResNet-50 trunk returning the requested stage outputs.

    ``return_stages``: subset of (1, 2, 3, 4). DC5 (``dilation=True``)
    replaces layer4's stride with dilation (stride 32 -> 16).
    """

    def __init__(self, dilation: bool = False,
                 return_stages: Sequence[int] = (4,),
                 fused_stages: bool = False):
        super().__init__()
        self.return_stages = tuple(return_stages)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = ResNetStage(64, 3, 1, allow_fused=fused_stages)
        self.layer2 = ResNetStage(128, 4, 2)
        self.layer3 = ResNetStage(256, 6, 2)
        self.layer4 = ResNetStage(512, 3, 2, dilate=dilation)

    @property
    def fused_stages(self) -> bool:
        """layer1 through the fused bottleneck stage (K6) in bf16 eval."""
        return self.layer1.allow_fused

    @fused_stages.setter
    def fused_stages(self, value: bool):
        self.layer1.allow_fused = bool(value)

    def forward(self, x):
        """x: (B, H, W, 3). Returns {stage: (B, h, w, C)}."""
        x = x.permute(0, 3, 1, 2)
        x = self.bn1(self.conv1(x), relu=True)
        x = max_pool_torch(x, 3, 2, 1)
        outs = {}
        for s in (1, 2, 3, 4):
            x = getattr(self, f"layer{s}")(x)
            if s in self.return_stages:
                outs[s] = x.permute(0, 2, 3, 1)
            if s >= max(self.return_stages):
                break
        return outs


def downsample_mask(mask, shape: Tuple[int, int]):
    """Nearest-resize a (B, H, W) bool padding mask to a feature shape, as
    ``F.interpolate(mask[None].float(), size=...).bool()`` does: output
    index i reads input index ``(i * in) // out``."""
    _, H, W = mask.shape
    ri = torch.arange(shape[0], device=mask.device) * H // shape[0]
    ci = torch.arange(shape[1], device=mask.device) * W // shape[1]
    return mask[:, ri][:, :, ci]
