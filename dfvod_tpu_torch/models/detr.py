"""DeformableDETR, the single-frame RGB-D detection model (counterpart of
``dfvod_tpu/models/detr.py``), with the fusion routing of the JAX model:

- Baseline             : ResNet-50 RGB only
- LateFusion           : ResNet-50 + DFormer depth stem; one depth
                         cross-attention before the encoder
- Backbone_CrossFusion : ``CrossFusionBackbone`` (fusion between the conv
                         stages); no depth input to the transformer
- Encoder_CrossFusion  : ResNet-50 + DFormer; fusion layers after the
                         first four encoder layers

Inputs are channels-last ``(B, H, W, 4)`` RGB-D (or ``(B, H, W, 3)`` RGB)
with a ``(B, H, W)`` padding mask, True = pad.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from dfvod_tpu_torch.models.backbone_crossfusion import CrossFusionBackbone
from dfvod_tpu_torch.models.backbone_dformer import DFormerBackbone
from dfvod_tpu_torch.models.backbone_resnet import ResNet50, downsample_mask
from dfvod_tpu_torch.models.position_encoding import (
    sine_position_embedding_rect as sine_position_embedding,
)
from dfvod_tpu_torch.models.transformer import DeformableTransformer
from dfvod_tpu_torch.utils.config import ModelConfig, check_supported

RESNET50_STAGE_CHANNELS = {1: 256, 2: 512, 3: 1024, 4: 2048}
DFORMER_CHANNELS = 128


class InputProj(nn.Module):
    """1x1 conv + GroupNorm(32) level projection; (B, H, W, C) in and
    out."""

    def __init__(self, in_features: int, d_model: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, d_model, 1, bias=True)
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
                                     return_stages=cfg.backbone_stages)
        if self.depth_tokens:
            self.depth_backbone = DFormerBackbone()
            self.input_proj_depth_0 = InputProj(DFORMER_CHANNELS, d)
        for i, stage in enumerate(cfg.backbone_stages):
            self.add_module(f"input_proj_{i}",
                            InputProj(RESNET50_STAGE_CHANNELS[stage], d))
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
            remat=cfg.remat)

    def forward(self, images, mask):
        """images: (B, H, W, 3|4); mask: (B, H, W) bool, True = pad."""
        cfg = self.cfg
        channels = 4 if cfg.use_depth else 3
        if images.shape[-1] != channels:
            raise ValueError(f"{cfg.fusion_type} takes {channels}-channel "
                             f"images, not {images.shape[-1]}")
        if self.cross_fusion_backbone:
            feats, masks, _, _ = self.backbone(images[..., :3],
                                               images[..., 3:4], mask)
        else:
            stage_outs = self.backbone(images[..., :3])
            feats = [stage_outs[s] for s in cfg.backbone_stages]
            masks = [downsample_mask(mask, tuple(f.shape[1:3]))
                     for f in feats]
        srcs = [getattr(self, f"input_proj_{i}")(f)
                for i, f in enumerate(feats)]
        pos = [sine_position_embedding(~m, cfg.hidden_dim // 2)
               for m in masks]

        depth_feats = depth_masks = depth_pos = None
        if self.depth_tokens:
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
        out["_trunk"] = {k: t_out[k] for k in
                         ("memory", "mask_flat", "spatial_shapes",
                          "valid_ratios", "query_pos", "pos_flat",
                          "hs_last", "init_reference", "last_reference",
                          "last_deltas")}
        return out
