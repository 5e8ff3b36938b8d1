"""Deformable-DETR transformer trunk with the LateFusion adapter
(counterpart of ``dfvod_tpu/models/transformer.py``).

- encoder: self-MSDeformAttn layers
- decoder: MHA self-attn + cross-MSDeformAttn layers with iterative box
  refinement; detection heads owned here so refinement and outputs share
  weights
- LateFusion: one depth cross-attention layer over the flattened RGB tokens
  before the encoder, residual add

Tokens are ``(B, S, C)``; ``spatial_shapes`` is a Python tuple. Single-stage
only: the two-stage proposal path and the Encoder-CrossFusion layers wait
for a later slice (``utils/config.check_supported``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from dfvod_tpu_torch.models.layers import (
    FFN,
    Dropout,
    MSDeformAttn,
    MultiHeadAttention,
    SingleLinearFFN,
    fixed_linear,
    with_pos,
)
from dfvod_tpu_torch.utils.box_ops import inverse_sigmoid

SpatialShapes = Tuple[Tuple[int, int], ...]


def get_valid_ratio(mask):
    """Fraction of unpadded rows/cols per image. mask: (B, H, W) True=pad.
    Returns (B, 2) as (ratio_w, ratio_h)."""
    not_mask = ~mask
    _, H, W = mask.shape
    valid_h = not_mask[:, :, 0].to(torch.float32).sum(1)
    valid_w = not_mask[:, 0, :].to(torch.float32).sum(1)
    return torch.stack([valid_w / W, valid_h / H], dim=-1)


def encoder_reference_points(spatial_shapes: SpatialShapes, valid_ratios):
    """Per-token reference points: pixel centers normalized by the valid
    region, then scaled by every level's valid ratio. Returns (B, S, L, 2).
    """
    dev = valid_ratios.device
    refs = []
    for lvl, (H, W) in enumerate(spatial_shapes):
        ys = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
        xs = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
        ref_y = ys[:, None].expand(H, W).reshape(-1)
        ref_x = xs[None, :].expand(H, W).reshape(-1)
        ref_y = ref_y[None] / (valid_ratios[:, None, lvl, 1] * H)
        ref_x = ref_x[None] / (valid_ratios[:, None, lvl, 0] * W)
        refs.append(torch.stack([ref_x, ref_y], dim=-1))  # (B, H*W, 2)
    ref = torch.cat(refs, dim=1)                           # (B, S, 2)
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


def flatten_levels(srcs, masks, pos_embeds, level_embed=None):
    """Flatten per-level (B, H, W, C) maps into (B, S, C) tokens.

    Returns (src_flat, mask_flat, pos_flat, spatial_shapes). ``pos_flat`` is
    cast to the token dtype: the sine embedding is f32, and letting it
    promote every pos-add would run a bf16 model in f32.
    """
    spatial_shapes = tuple((int(s.shape[1]), int(s.shape[2])) for s in srcs)
    src_flat = torch.cat([s.reshape(s.shape[0], -1, s.shape[-1])
                          for s in srcs], dim=1)
    mask_flat = torch.cat([m.reshape(m.shape[0], -1) for m in masks], dim=1)
    pos_list = []
    for lvl, p in enumerate(pos_embeds):
        p = p.reshape(p.shape[0], -1, p.shape[-1])
        if level_embed is not None:
            p = p + level_embed[lvl][None, None, :]
        pos_list.append(p)
    pos_flat = torch.cat(pos_list, dim=1).to(src_flat.dtype)
    return src_flat, mask_flat, pos_flat, spatial_shapes


class DeformableTransformerEncoderLayer(nn.Module):
    """Self-MSDeformAttn + dropout + FFN."""

    def __init__(self, d_model=256, d_ffn=1024, activation="relu",
                 n_levels=4, n_heads=8, n_points=4, dropout=0.1):
        super().__init__()
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn, activation, dropout)

    def forward(self, src, pos, reference_points, spatial_shapes,
                padding_mask=None):
        src2 = self.self_attn(with_pos(src, pos), reference_points, src,
                              spatial_shapes, padding_mask)
        return self.ffn(self.norm1(src + self.dropout1(src2)))


class DeformableTransformerDecoderLayer(nn.Module):
    """MHA self-attn + dropout + cross-MSDeformAttn + dropout + FFN."""

    def __init__(self, d_model=256, d_ffn=1024, activation="relu",
                 n_levels=4, n_heads=8, n_points=4, dropout=0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.dropout2 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn, activation, dropout)

    def forward(self, tgt, query_pos, reference_points, src, spatial_shapes,
                src_padding_mask=None):
        q = with_pos(tgt, query_pos)
        tgt = self.norm2(tgt + self.dropout2(self.self_attn(q, q, tgt)))
        tgt2 = self.cross_attn(with_pos(tgt, query_pos), reference_points,
                               src, spatial_shapes, src_padding_mask)
        return self.ffn(self.norm1(tgt + self.dropout1(tgt2)))


class DepthFusionLayer(nn.Module):
    """Deformable cross-attention from a token stream onto depth tokens
    (the LateFusion layer): depth_scale_adapt -> LayerNorm ->
    cross-MSDeformAttn -> cross_scale_adapt -> residual + LN ->
    single-linear GELU FFN, with dropout after the cross-attention."""

    def __init__(self, d_model=256, n_levels=1, n_heads=8, n_points=4,
                 ffn_activation="gelu", dropout=0.1):
        super().__init__()
        self.n_levels = n_levels
        self.depth_scale_adapt = nn.Linear(d_model, d_model)
        self.norm_depth_scale = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.cross_scale_adapt = nn.Linear(d_model, d_model)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn = SingleLinearFFN(d_model, ffn_activation, dropout)

    def forward(self, tgt, query_pos, reference_points, src,
                src_spatial_shapes, src_padding_mask=None):
        src = self.norm_depth_scale(self.depth_scale_adapt(src))
        # reference points may carry more levels than the depth stream
        ref = reference_points[:, :, :self.n_levels, :]
        tgt2 = self.cross_attn(with_pos(tgt, query_pos), ref, src,
                               src_spatial_shapes, src_padding_mask)
        tgt = self.norm1(tgt + self.dropout1(self.cross_scale_adapt(tgt2)))
        return self.ffn(tgt)


PRIOR_PROB = 0.01      # focal-loss prior of the class bias
WH_BIAS = -2.0         # single-stage box-size bias (two-stage uses 0)


class DetectionHead(nn.Module):
    """Per-layer classification Linear + 3-layer box MLP."""

    def __init__(self, d_model: int, num_classes: int):
        super().__init__()
        self.class_embed = nn.Linear(d_model, num_classes)
        with torch.no_grad():
            self.class_embed.bias.fill_(
                -math.log((1 - PRIOR_PROB) / PRIOR_PROB))
        self.class_embed.keep_bias = True
        self.bbox_layers_0 = nn.Linear(d_model, d_model)
        self.bbox_layers_1 = nn.Linear(d_model, d_model)
        # zero kernel + (0, 0, wh, wh) bias: boxes start near the reference
        self.bbox_layers_2 = fixed_linear(d_model, 4,
                                          [0.0, 0.0, WH_BIAS, WH_BIAS])

    def forward(self, x):
        h = torch.relu(self.bbox_layers_0(x))
        h = torch.relu(self.bbox_layers_1(h))
        return self.class_embed(x), self.bbox_layers_2(h)


def refine_reference(deltas, reference):
    """Iterative box refinement update; 2-coord refs grow into 4-coord
    boxes after the first refinement."""
    if reference.shape[-1] == 4:
        new_ref = torch.sigmoid(deltas + inverse_sigmoid(reference))
    else:
        xy = deltas[..., :2] + inverse_sigmoid(reference)
        new_ref = torch.sigmoid(torch.cat([xy, deltas[..., 2:]], dim=-1))
    return new_ref.detach()


class DeformableTransformer(nn.Module):
    """Full single-stage trunk. ``fusion``: 'none' | 'late'."""

    def __init__(self, d_model=256, n_heads=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=1024,
                 activation="relu", num_feature_levels=4, dec_n_points=4,
                 enc_n_points=4, num_queries=300, with_box_refine=False,
                 num_classes=3, fusion="none", dpth_n_points=4,
                 dpth_feature_levels=1, dropout=0.1):
        super().__init__()
        if fusion not in ("none", "late"):
            raise NotImplementedError(
                f"fusion={fusion!r} waits for the other-fusion-modes slice")
        self.fusion = fusion
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.with_box_refine = with_box_refine
        self.level_embed = nn.Parameter(
            torch.zeros(num_feature_levels, d_model))
        self.query_embed = nn.Parameter(torch.zeros(num_queries,
                                                    d_model * 2))
        self.reference_points = nn.Linear(d_model, 2)
        if fusion == "late":
            self.depth_encoder_layer = DepthFusionLayer(
                d_model, dpth_feature_levels, n_heads, dpth_n_points,
                dropout=dropout)
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layers_{i}",
                            DeformableTransformerEncoderLayer(
                                d_model, dim_feedforward, activation,
                                num_feature_levels, n_heads, enc_n_points,
                                dropout))
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layers_{i}",
                            DeformableTransformerDecoderLayer(
                                d_model, dim_feedforward, activation,
                                num_feature_levels, n_heads, dec_n_points,
                                dropout))
        if with_box_refine:
            for i in range(num_decoder_layers):
                self.add_module(f"head_{i}",
                                DetectionHead(d_model, num_classes))
        else:
            self.head_shared = DetectionHead(d_model, num_classes)

    def _head(self, i):
        return (getattr(self, f"head_{i}") if self.with_box_refine
                else self.head_shared)

    def forward(self, srcs, masks, pos_embeds, depth_srcs=None,
                depth_masks=None, depth_pos_embeds=None):
        """srcs/masks/pos_embeds: lists of (B,H,W,C)/(B,H,W)/(B,H,W,C).

        Returns dict: outputs_class (num_layers, B, Q, K), outputs_coord
        (num_layers, B, Q, 4), plus the trunk state.
        """
        src_flat, mask_flat, pos_flat, spatial_shapes = flatten_levels(
            srcs, masks, pos_embeds, self.level_embed)
        valid_ratios = torch.stack([get_valid_ratio(m) for m in masks],
                                   dim=1)
        B = src_flat.shape[0]
        ref_points_enc = encoder_reference_points(spatial_shapes,
                                                  valid_ratios)

        if self.fusion == "late":
            if depth_srcs is None:
                raise ValueError("LateFusion needs depth features")
            # depth has no level embedding
            depth_flat, depth_mask_flat, depth_pos_flat, depth_shapes = (
                flatten_levels(depth_srcs, depth_masks, depth_pos_embeds))
            src_flat = src_flat + self.depth_encoder_layer(
                src_flat, pos_flat, ref_points_enc, depth_flat,
                depth_shapes, depth_mask_flat)

        output = src_flat
        for i in range(self.num_encoder_layers):
            output = getattr(self, f"encoder_layers_{i}")(
                output, pos_flat, ref_points_enc, spatial_shapes, mask_flat)
        memory = output

        # query_embed splits as (query_pos, tgt)
        query_pos, tgt = torch.split(self.query_embed,
                                     self.query_embed.shape[1] // 2, dim=-1)
        query_pos = query_pos[None].expand(B, -1, -1)
        tgt = tgt[None].expand(B, -1, -1)
        reference_points = torch.sigmoid(self.reference_points(query_pos))
        init_reference = reference_points

        outputs_classes, outputs_coords = [], []
        output = tgt
        for lid in range(self.num_decoder_layers):
            if reference_points.shape[-1] == 4:
                ref_input = (reference_points[:, :, None]
                             * torch.cat([valid_ratios, valid_ratios],
                                         dim=-1)[:, None])
            else:
                ref_input = reference_points[:, :, None] * valid_ratios[:,
                                                                        None]
            output = getattr(self, f"decoder_layers_{lid}")(
                output, query_pos, ref_input, memory, spatial_shapes,
                mask_flat)

            # per-layer outputs, computed against the layer's *input*
            # reference
            logits, deltas = self._head(lid)(output)
            ref_unact = inverse_sigmoid(reference_points)
            if reference_points.shape[-1] == 4:
                coord = torch.sigmoid(deltas + ref_unact)
            else:
                coord = torch.sigmoid(torch.cat(
                    [deltas[..., :2] + ref_unact, deltas[..., 2:]], dim=-1))
            outputs_classes.append(logits)
            outputs_coords.append(coord)

            if self.with_box_refine:
                reference_points = refine_reference(deltas, reference_points)

        return {
            "outputs_class": torch.stack(outputs_classes),
            "outputs_coord": torch.stack(outputs_coords),
            "init_reference": init_reference,
            "memory": memory,
            "mask_flat": mask_flat,
            "spatial_shapes": spatial_shapes,
            "valid_ratios": valid_ratios,
            "query_pos": query_pos,
            "pos_flat": pos_flat,
            "hs_last": output,
            "last_reference": reference_points,
            "last_deltas": deltas,
        }
