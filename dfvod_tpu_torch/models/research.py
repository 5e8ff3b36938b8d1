"""The research depth trunk (counterpart of ``dfvod_tpu/models/research.py``):
a ResNet-18 over the depth channel, the fallback that the reference builds
when the DFormer flags are off (``deformable_detr_single.py:653,661``), and
so the CLI's default depth backbone for LateFusion and Encoder_CrossFusion
without ``--dformer_backbone``.

``ResNet18DepthBackbone``: a 1-channel 7x7 stride-2 stem with FrozenBN and
max pool, then torchvision's BasicBlock layers 1-3, giving the stride-16
``layer3`` feature with 256 channels (``research_scripts/depth_backbone.py
:59-91``) and its padding mask. Every convolution is bias-free and every
BN frozen, as in the JAX package; the convolutions run through cuDNN.
Submodules carry the flax module names (``layer1.block_0.conv1``,
``downsample_conv``, ...), so ``utils/convert.py`` maps weights
mechanically. Select it with ``ModelConfig.depth_backbone_type =
"resnet18"``.
"""
from __future__ import annotations

from torch import nn

from dfvod_tpu_torch.models.backbone_resnet import (
    FrozenBatchNorm,
    conv,
    downsample_mask,
    max_pool_torch,
)

RESNET18_CHANNELS = 256            # layer3's output


class BasicBlock(nn.Module):
    """torchvision BasicBlock (3x3 -> 3x3, expansion 1), NCHW."""

    def __init__(self, in_features: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv(in_features, planes, 3, stride)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv(planes, planes, 3)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = conv(in_features, planes, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes)

    def forward(self, x):
        out = self.bn1(self.conv1(x), relu=True)
        if self.downsample:
            return self.bn2(self.conv2(out), relu=True,
                            residual=self.downsample_conv(x),
                            residual_bn=self.downsample_bn)
        return self.bn2(self.conv2(out), relu=True, residual=x)


class ResNet18Stage(nn.Module):
    """``blocks`` BasicBlocks; the first strides and, where the stride or
    the width changes, projects its shortcut."""

    def __init__(self, in_features: int, planes: int, blocks: int = 2,
                 stride: int = 1):
        super().__init__()
        self.blocks = blocks
        self.block_0 = BasicBlock(
            in_features, planes, stride,
            downsample=stride != 1 or in_features != planes)
        for i in range(1, blocks):
            self.add_module(f"block_{i}", BasicBlock(planes, planes))

    def forward(self, x):
        for i in range(self.blocks):
            x = getattr(self, f"block_{i}")(x)
        return x


class ResNet18DepthBackbone(nn.Module):
    """Depth trunk: (B, H, W, 1) depth and its (B, H, W) padding mask in,
    the (B, H/16, W/16, 256) ``layer3`` feature and its mask out."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(1, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = ResNet18Stage(64, 64, 2, 1)
        self.layer2 = ResNet18Stage(64, 128, 2, 2)
        self.layer3 = ResNet18Stage(128, RESNET18_CHANNELS, 2, 2)

    def forward(self, depth, mask):
        x = depth.permute(0, 3, 1, 2)
        x = self.bn1(self.conv1(x), relu=True)
        x = max_pool_torch(x, 3, 2, 1)
        x = self.layer3(self.layer2(self.layer1(x)))
        feat = x.permute(0, 2, 3, 1)
        return feat, downsample_mask(mask, tuple(feat.shape[1:3]))
