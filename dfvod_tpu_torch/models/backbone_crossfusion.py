"""Backbone Cross-Fusion: ResNet-50 RGB x DFormer depth, fused per stage
(counterpart of ``dfvod_tpu/models/backbone_crossfusion.py``).

The two streams run in lockstep. After RGB stages 2, 3 and 4 (paired with
the depth stem, depth stage 1 and depth stage 2) both are 1x1-projected to
``d_model`` with a GroupNorm, the RGB tokens deformably cross-attend onto
the depth tokens (``d2r_fusion{s}``), and the result is projected back to
the stage's width and added to the RGB stream. With ``bidirectional`` the
depth stream gets the mirrored update (``r2d_fusion{s}``).

Kept from the JAX module:

- ``output_rgb_proj{s}`` projects back to the stage's true width (512,
  1024, 2048) with 32 groups, the documented deviation from the reference;
  the depth projections use {2: 4, 3: 8, 4: 16} groups;
- the RGB reference points are the RGB pixel-centre grid scaled by the
  *depth* stream's valid ratio, and the reverse for ``r2d``;
- the fusion layers' FFN uses ReLU; the depth BNs are trainable
  ``BatchNorm``s (batch statistics in ``train()``, running ones in
  ``eval()``); layer1 never takes the fused bottleneck stage.

Submodules carry the flax names directly under the module (``conv1``,
``bn1``, ``layer1``-``layer4``, ``stem_conv1`` ..., ``stage2_conv``,
``input_rgb_proj2`` ...), so ``utils/convert.py`` maps the weights
mechanically. The streams run NCHW, channels-last in memory under
``Server``: a site's NHWC token view of a channels-last map is a view, not
a copy.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from dfvod_tpu_torch.models.backbone_dformer import BatchNorm, _conv
from dfvod_tpu_torch.models.backbone_resnet import (
    FrozenBatchNorm,
    ResNetStage,
    downsample_mask,
    max_pool_torch,
)
from dfvod_tpu_torch.models.position_encoding import (
    sine_position_embedding_rect as sine_position_embedding,
)
from dfvod_tpu_torch.models.transformer import (
    DepthFusionLayer,
    encoder_reference_points,
    get_valid_ratio,
)

FUSION_STAGES = (2, 3, 4)
RGB_CHANNELS = {2: 512, 3: 1024, 4: 2048}
# the depth map's width at each fusion site: stem, stage 1, stage 2
DEPTH_CHANNELS = {2: 32, 3: 64, 4: 128}
# depth input-projection GroupNorm groups (the reference's)
DEPTH_GROUPS = {2: 4, 3: 8, 4: 16}
FUSION_N_POINTS = 4


class _ProjGN(nn.Module):
    """1x1 conv + GroupNorm projection around each fusion site (NCHW)."""

    def __init__(self, in_features: int, features: int, groups: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, 1, bias=True)
        self.gn = nn.GroupNorm(groups, features, eps=1e-5)

    def forward(self, x):
        return self.gn(self.conv(x))


def _tokens(x):
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.permute(0, 2, 3, 1).flatten(1, 2)


def _map(tokens, h: int, w: int):
    """(B, h*w, C) -> (B, C, h, w), a view."""
    return tokens.unflatten(1, (h, w)).permute(0, 3, 1, 2)


class CrossFusionBackbone(nn.Module):
    """RGB ResNet-50 + DFormer depth with per-stage deformable fusion.

    ``forward(rgb, depth, mask)`` returns ``(rgb_feats, rgb_masks,
    depth_feat, depth_mask)``: the RGB stages of ``return_stages``
    channels-last ``(B, h, w, C)``, their masks, and the last depth map
    ``(B, h, w, 128)`` with its mask."""

    def __init__(self, d_model: int = 256, dilation: bool = True,
                 return_stages: Sequence[int] = (4,),
                 bidirectional: bool = False, n_heads: int = 8,
                 dropout: float = 0.1):
        super().__init__()
        self.d_model = d_model
        self.return_stages = tuple(return_stages)
        self.bidirectional = bidirectional
        d0, d1, d2 = (DEPTH_CHANNELS[s] for s in FUSION_STAGES)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = ResNetStage(64, 3, 1, allow_fused=False)
        self.layer2 = ResNetStage(128, 4, 2)
        self.layer3 = ResNetStage(256, 6, 2)
        self.layer4 = ResNetStage(512, 3, 2, dilate=dilation)
        self.stem_conv1 = _conv(1, d0 // 2)
        self.stem_bn1 = BatchNorm(d0 // 2)
        self.stem_conv2 = _conv(d0 // 2, d0)
        self.stem_bn2 = BatchNorm(d0)
        self.stage1_bn = BatchNorm(d0)
        self.stage1_conv = _conv(d0, d1)
        self.stage2_bn = BatchNorm(d1)
        self.stage2_conv = _conv(d1, d2)
        for s in FUSION_STAGES:
            cr, cd, g = RGB_CHANNELS[s], DEPTH_CHANNELS[s], DEPTH_GROUPS[s]
            self.add_module(f"input_rgb_proj{s}", _ProjGN(cr, d_model, 32))
            self.add_module(f"input_d_proj{s}", _ProjGN(cd, d_model, g))
            self.add_module(f"d2r_fusion{s}", DepthFusionLayer(
                d_model, 1, n_heads, FUSION_N_POINTS, ffn_activation="relu",
                dropout=dropout))
            self.add_module(f"output_rgb_proj{s}", _ProjGN(d_model, cr, 32))
            if bidirectional:
                self.add_module(f"r2d_fusion{s}", DepthFusionLayer(
                    d_model, 1, n_heads, FUSION_N_POINTS,
                    ffn_activation="relu", dropout=dropout))
                self.add_module(f"output_d_proj{s}", _ProjGN(d_model, cd, g))

    def _fuse(self, x_rgb, x_d, mask_rgb, mask_d, stage: int):
        """One fusion site on NCHW maps: project -> cross-attend ->
        project back, residual."""
        _, _, hr, wr = x_rgb.shape
        _, _, hd, wd = x_d.shape
        rgb_tokens = _tokens(getattr(self, f"input_rgb_proj{stage}")(x_rgb))
        d_tokens = _tokens(getattr(self, f"input_d_proj{stage}")(x_d))
        # the sine embedding is f32; the tokens keep their dtype
        pos_rgb = sine_position_embedding(~mask_rgb, self.d_model // 2
                                          ).flatten(1, 2).to(rgb_tokens.dtype)
        ref_rgb = encoder_reference_points(
            ((hr, wr),), get_valid_ratio(mask_d)[:, None, :])
        fused = getattr(self, f"d2r_fusion{stage}")(
            rgb_tokens, pos_rgb, ref_rgb, d_tokens, ((hd, wd),),
            mask_d.flatten(1))
        x_rgb_new = x_rgb + getattr(self, f"output_rgb_proj{stage}")(
            _map(fused, hr, wr))
        if self.bidirectional:
            pos_d = sine_position_embedding(~mask_d, self.d_model // 2
                                            ).flatten(1, 2).to(d_tokens.dtype)
            ref_d = encoder_reference_points(
                ((hd, wd),), get_valid_ratio(mask_rgb)[:, None, :])
            fused_d = getattr(self, f"r2d_fusion{stage}")(
                d_tokens, pos_d, ref_d, rgb_tokens, ((hr, wr),),
                mask_rgb.flatten(1))
            x_d = x_d + getattr(self, f"output_d_proj{stage}")(
                _map(fused_d, hd, wd))
        return x_rgb_new, x_d

    def _site(self, x_rgb, x_d, mask, stage, outs):
        """The masks at both streams' strides and the fusion of ``stage``;
        the RGB output and its mask go to ``outs``."""
        mask_rgb = downsample_mask(mask, tuple(x_rgb.shape[2:]))
        mask_d = downsample_mask(mask, tuple(x_d.shape[2:]))
        x_rgb, x_d = self._fuse(x_rgb, x_d, mask_rgb, mask_d, stage)
        outs[stage] = (x_rgb.permute(0, 2, 3, 1), mask_rgb)
        return x_rgb, x_d, mask_d

    def forward(self, rgb, depth, mask):
        """rgb: (B, H, W, 3); depth: (B, H, W, 1); mask: (B, H, W),
        True = pad."""
        x = self.bn1(self.conv1(rgb.permute(0, 3, 1, 2)), relu=True)
        x = max_pool_torch(x, 3, 2, 1)
        x_rgb = self.layer2(self.layer1(x))
        x_d = F.gelu(self.stem_bn1(self.stem_conv1(
            depth.permute(0, 3, 1, 2))))                # exact (erf) form
        x_d = self.stem_bn2(self.stem_conv2(x_d))
        outs = {}
        x_rgb, x_d, _ = self._site(x_rgb, x_d, mask, 2, outs)
        x_rgb = self.layer3(x_rgb)
        x_d = self.stage1_conv(self.stage1_bn(x_d))
        x_rgb, x_d, _ = self._site(x_rgb, x_d, mask, 3, outs)
        x_rgb = self.layer4(x_rgb)
        x_d = self.stage2_conv(self.stage2_bn(x_d))
        x_rgb, x_d, mask_d = self._site(x_rgb, x_d, mask, 4, outs)
        feats = [outs[s][0] for s in self.return_stages]
        masks = [outs[s][1] for s in self.return_stages]
        return feats, masks, x_d.permute(0, 2, 3, 1), mask_d
