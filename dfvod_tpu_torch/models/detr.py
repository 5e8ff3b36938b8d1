"""DeformableDETR, the single-frame RGB-D detection model (counterpart of
``dfvod_tpu/models/detr.py``), with the fusion routing of the JAX model:

- Baseline             : ResNet-50 RGB only
- LateFusion           : ResNet-50 + DFormer depth stem; one depth
                         cross-attention before the encoder
- Backbone_CrossFusion : ``CrossFusionBackbone`` (fusion between the conv
                         stages); no depth input to the transformer
- Encoder_CrossFusion  : ResNet-50 + DFormer; fusion layers after the
                         first four encoder layers

LateFusion and Encoder_CrossFusion take the ResNet-18 depth trunk
(``models/research.py``) in place of DFormer with
``depth_backbone_type="resnet18"``, the CLI's default without
``--dformer_backbone``. With ``two_stage`` the output also holds
``enc_outputs``, every encoder token's proposal.

Inputs are channels-last ``(B, H, W, 4)`` RGB-D (or ``(B, H, W, 3)`` RGB),
or their 2x2 space-to-depth packing ``(B, H/2, W/2, 16|12)``
(``data/device_pipeline.py::pack_s2d``), with a full-resolution
``(B, H, W)`` padding mask, True = pad. The JAX stems convolve the packed
form directly (``StemConvS2D``, ``Conv3x3S2D``: the same taps reordered);
here it is unpacked on the device and the plain stems run, which gives the
unpacked input's result. The ResNet-18 depth trunk has no s2d stem in the
JAX package, and packed input is refused with it, as there.

With ``num_feature_levels`` L > 1 the levels are ResNet stages 2-4 and
L - 3 more, each a 3x3 stride-2 ``InputProj`` of the level before
(``deformable_detr_single.py:271-281`` of the reference); the depth stream
stays one level.

With ``masks`` the output also holds ``pred_masks`` (B, Q, H/4, W/4), the
mask branch's logits (``models/segmentation.py``); the backbone then also
returns ResNet stages 1-3, its laterals. Backbone_CrossFusion fuses those
stages and refuses masks (``ModelConfig``).
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from dfvod_tpu_torch.data.device_pipeline import unpack_s2d
from dfvod_tpu_torch.models.backbone_crossfusion import CrossFusionBackbone
from dfvod_tpu_torch.models.backbone_dformer import DFormerBackbone
from dfvod_tpu_torch.models.backbone_resnet import ResNet50, downsample_mask
from dfvod_tpu_torch.models.position_encoding import (
    sine_position_embedding_rect as sine_position_embedding,
)
from dfvod_tpu_torch.models.research import (
    RESNET18_CHANNELS,
    ResNet18DepthBackbone,
)
from dfvod_tpu_torch.models.segmentation import LATERAL_STAGES, MaskBranch
from dfvod_tpu_torch.models.transformer import DeformableTransformer
from dfvod_tpu_torch.utils.config import ModelConfig, check_supported
from dfvod_tpu_torch.utils.trace import span

RESNET50_STAGE_CHANNELS = {1: 256, 2: 512, 3: 1024, 4: 2048}
DFORMER_CHANNELS = 128


class InputProj(nn.Module):
    """Conv (1x1, or 3x3 stride 2 for an extra level) + GroupNorm(32) level
    projection; (B, H, W, C) in and out."""

    def __init__(self, in_features: int, d_model: int, kernel: int = 1,
                 stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_features, d_model, kernel, stride=stride,
                              padding=(kernel - 1) // 2, bias=True)
        self.gn = nn.GroupNorm(32, d_model, eps=1e-5)

    def forward(self, x):
        x = self.gn(self.conv(x.permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1)


class DeformableDETR(nn.Module):
    """Single-frame model; returns the reference's output dict."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d = cfg.hidden_dim
        self.cross_fusion_backbone = cfg.fusion_type == "Backbone_CrossFusion"
        # the transformer's depth input: LateFusion and Encoder_CrossFusion
        self.depth_tokens = cfg.transformer_fusion != "none"
        if self.cross_fusion_backbone:
            self.backbone = CrossFusionBackbone(
                d_model=d, dilation=cfg.dilation,
                return_stages=cfg.backbone_stages, dropout=cfg.dropout)
        else:
            self.backbone = ResNet50(dilation=cfg.dilation,
                                     return_stages=cfg.all_backbone_stages)
        self.resnet18_depth = (self.depth_tokens
                               and cfg.depth_backbone_type == "resnet18")
        if self.resnet18_depth:
            self.depth_backbone = ResNet18DepthBackbone()
            self.input_proj_depth_0 = InputProj(RESNET18_CHANNELS, d)
        elif self.depth_tokens:
            self.depth_backbone = DFormerBackbone()
            self.input_proj_depth_0 = InputProj(DFORMER_CHANNELS, d)
        n_stages = len(cfg.backbone_stages)
        for i, stage in enumerate(cfg.backbone_stages):
            self.add_module(f"input_proj_{i}",
                            InputProj(RESNET50_STAGE_CHANNELS[stage], d))
        # extra levels: 3x3 stride-2 convs, the first on the last stage
        for i in range(n_stages, cfg.num_feature_levels):
            cin = (RESNET50_STAGE_CHANNELS[cfg.backbone_stages[-1]]
                   if i == n_stages else d)
            self.add_module(f"input_proj_{i}",
                            InputProj(cin, d, kernel=3, stride=2))
        self.transformer = DeformableTransformer(
            d_model=d, n_heads=cfg.nheads,
            num_encoder_layers=cfg.enc_layers,
            num_decoder_layers=cfg.dec_layers,
            dim_feedforward=cfg.dim_feedforward,
            dropout=cfg.dropout,
            num_feature_levels=cfg.num_feature_levels,
            dec_n_points=cfg.dec_n_points,
            enc_n_points=cfg.enc_n_points,
            num_queries=cfg.num_queries,
            with_box_refine=cfg.with_box_refine,
            num_classes=cfg.num_classes,
            fusion=cfg.transformer_fusion,
            dpth_n_points=cfg.dpth_n_points,
            remat=cfg.remat,
            two_stage=cfg.two_stage)
        if cfg.masks:
            self.mask_branch = MaskBranch(hidden_dim=d, num_heads=cfg.nheads)

    def forward(self, images, mask):
        """images: (B, H, W, 3|4), or s2d-packed (B, H/2, W/2, 12|16);
        mask: (B, H, W) bool, True = pad."""
        cfg = self.cfg
        if images.shape[-1] in (12, 16):
            if self.cross_fusion_backbone or self.resnet18_depth:
                raise ValueError("s2d-packed input needs the s2d stems "
                                 "(ResNet50 / DFormer); Backbone_CrossFusion "
                                 "and the ResNet-18 depth trunk take "
                                 "unpacked frames")
            images = unpack_s2d(images)
        channels = 4 if cfg.use_depth else 3
        if images.shape[-1] != channels:
            raise ValueError(f"{cfg.fusion_type} takes {channels}-channel "
                             f"images, not {images.shape[-1]}")
        if self.cross_fusion_backbone:
            with span("backbone"):
                feats, masks, _, _ = self.backbone(images[..., :3],
                                                   images[..., 3:4], mask)
        else:
            with span("backbone"):
                stage_outs = self.backbone(images[..., :3])
            feats = [stage_outs[s] for s in cfg.backbone_stages]
            masks = [downsample_mask(mask, tuple(f.shape[1:3]))
                     for f in feats]
        srcs = [getattr(self, f"input_proj_{i}")(f)
                for i, f in enumerate(feats)]
        masks = list(masks)
        for i in range(len(feats), cfg.num_feature_levels):
            srcs.append(getattr(self, f"input_proj_{i}")(
                feats[-1] if i == len(feats) else srcs[-1]))
            masks.append(downsample_mask(mask, tuple(srcs[-1].shape[1:3])))
        pos = [sine_position_embedding(~m, cfg.hidden_dim // 2)
               for m in masks]

        depth_feats = depth_masks = depth_pos = None
        if self.depth_tokens:
            with span("depth_backbone"):
                dfeat, dmask = self.depth_backbone(images[..., 3:4], mask)
            depth_feats = [self.input_proj_depth_0(dfeat)]
            depth_masks = [dmask]
            depth_pos = [sine_position_embedding(~dmask, cfg.hidden_dim // 2)]

        t_out = self.transformer(srcs, masks, pos, depth_feats, depth_masks,
                                 depth_pos)
        out = {
            "pred_logits": t_out["outputs_class"][-1],
            "pred_boxes": t_out["outputs_coord"][-1],
        }
        if cfg.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": c, "pred_boxes": b}
                for c, b in zip(t_out["outputs_class"][:-1],
                                t_out["outputs_coord"][:-1])]
        if cfg.two_stage:
            out["enc_outputs"] = {"pred_logits": t_out["enc_outputs_class"],
                                  "pred_boxes": t_out["enc_outputs_coord"]}
        if cfg.masks:
            # the DETRsegm branch (``deformable_detr_single.py:680-681`` of
            # the reference) on the trunk: each query's attention over the
            # level-0 memory map, upsampled through ResNet layers 3, 2, 1
            H1, W1 = t_out["spatial_shapes"][0]
            mem_map = t_out["memory"][:, :H1 * W1].reshape(
                -1, H1, W1, cfg.hidden_dim)
            out["pred_masks"] = self.mask_branch(
                t_out["hs_last"], mem_map, masks[0],
                [stage_outs[s] for s in LATERAL_STAGES])
        out["_trunk"] = {k: t_out[k] for k in
                         ("memory", "mask_flat", "spatial_shapes",
                          "valid_ratios", "query_pos", "pos_flat",
                          "hs_last", "init_reference", "last_reference",
                          "last_deltas")}
        return out
