"""Plain reference of the benchmarked models, in float32 PyTorch.

A frozen, trimmed copy of the port's LateFusion Deformable DETR and its
TransVOD++ head, with plain sampling in place of every hand-written kernel:
multi-scale deformable attention through ``F.grid_sample`` (the original
Deformable DETR's ``ms_deform_attn_core_pytorch``) and RoIAlign through
``F.grid_sample`` on mmcv's clamped sample points. It imports nothing of
the port and nothing of the JAX package. Its submodule names are the
port's, so one state dict fills both.

What is kept: LateFusion (ResNet-50 with FrozenBN, DC5 by ``dilation``; the
DFormer depth path with trainable BatchNorm; one depth cross-attention
before the encoder), one feature level, single-stage queries, box
refinement, aux outputs, and ``temporal_mode="transvod_pp"``. Dropout draws
its masks from a ``torch.Generator`` as the port's does
(``torch.rand(shape) < keep``), so a train step given the same seed draws
the same masks in the same order.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)
DEPTH_MEAN, DEPTH_STD = 0.48, 0.28
PRIOR_PROB = 0.01
WH_BIAS = -2.0


# ------------------------------------------------------------ preprocessing
def normalize(images_u8, sizes):
    """uint8 (B, H, W, C) frames padded bottom/right and their content
    (h, w) -> (normalized f32 image with the padding zeroed, bool padding
    mask, True = pad)."""
    B, H, W, C = images_u8.shape
    dev = images_u8.device
    mean = torch.tensor((*RGB_MEAN, DEPTH_MEAN)[:C], device=dev)
    std = torch.tensor((*RGB_STD, DEPTH_STD)[:C], device=dev)
    x = (images_u8.float() / 255.0 - mean) / std
    sizes = sizes.to(dev)
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    mask = (ys >= sizes[:, 0, None, None]) | (xs >= sizes[:, 1, None, None])
    return x.masked_fill(mask[..., None], 0.0), mask


def inverse_sigmoid(x, eps: float = 1e-5):
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def box_cxcywh_to_xyxy(x):
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w,
                        cy + 0.5 * h], dim=-1)


def sine_position_embedding(mask, num_pos_feats: int = 128,
                            temperature: float = 10000.0):
    """DETR's normalized sine embedding from cumulative sums of the valid
    pixels. mask: (B, H, W) True = pad. Returns (B, H, W, 2F)."""
    not_mask = (~mask).float()
    y = not_mask.cumsum(1)
    x = not_mask.cumsum(2)
    eps, scale = 1e-6, 2 * math.pi
    y = (y - 0.5) / (y[:, -1:, :] + eps) * scale
    x = (x - 0.5) / (x[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=mask.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)

    def embed(v):
        p = v[..., None] / dim_t
        return torch.stack([p[..., 0::2].sin(), p[..., 1::2].cos()],
                           dim=-1).flatten(-2)
    return torch.cat([embed(y), embed(x)], dim=-1)


def downsample_mask(mask, shape):
    """Nearest resize of a (B, H, W) padding mask: index i reads
    ``(i * in) // out``, as ``F.interpolate(mode="nearest")`` does."""
    return F.interpolate(mask[None].float(), size=tuple(shape))[0].bool()


# ------------------------------------------------------------------ layers
class Dropout(nn.Module):
    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def with_pos(x, pos):
    return x if pos is None else x + pos


def msda_grid_sample(value, shapes, loc, attw):
    """``ms_deform_attn_core_pytorch`` of Deformable DETR: bilinear samples
    by ``F.grid_sample`` (zeros outside, align_corners False), weighted and
    summed. value (B, S, M, D), loc (B, Lq, M, L, P, 2) in [0, 1], attw
    (B, Lq, M, L, P). Returns (B, Lq, M*D)."""
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    values = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    samples = []
    for lid, (h, w) in enumerate(shapes):
        v = values[lid].flatten(2).transpose(1, 2).reshape(B * M, D, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        samples.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    attw = attw.transpose(1, 2).reshape(B * M, 1, Lq, L * P)
    out = (torch.stack(samples, dim=-2).flatten(-2) * attw).sum(-1)
    return out.view(B, M * D, Lq).transpose(1, 2)


class MSDeformAttn(nn.Module):
    def __init__(self, d_model=256, n_levels=1, n_heads=8, n_points=4):
        super().__init__()
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        M, L, P = n_heads, n_levels, n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = nn.Linear(d_model, M * L * P * 2)
        self.attention_weights = nn.Linear(d_model, M * L * P)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, reference_points, input_flatten, shapes,
                padding_mask=None):
        M, L, P = self.n_heads, self.n_levels, self.n_points
        B, Lq, _ = query.shape
        S = input_flatten.shape[1]
        value = self.value_proj(input_flatten)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.view(B, S, M, self.d_model // M)
        off = self.sampling_offsets(query).view(B, Lq, M, L, P, 2)
        attw = self.attention_weights(query).view(B, Lq, M, L * P)
        attw = attw.softmax(-1).view(B, Lq, M, L, P)
        if reference_points.shape[-1] == 2:
            wh = torch.tensor([[w, h] for h, w in shapes],
                              dtype=off.dtype, device=off.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + off / wh[None, None, None, :, None, :])
        else:
            loc = (reference_points[:, :, None, :, None, :2]
                   + off / P * reference_points[:, :, None, :, None, 2:]
                   * 0.5)
        return self.output_proj(msda_grid_sample(value, shapes, loc, attw))


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model, n_heads, dropout=0.0):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.dropout = Dropout(dropout)

    def forward(self, q, k, v):
        M = self.n_heads
        D = self.d_model // M
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        qp = self.q_proj(q).view(B, Lq, M, D)
        kp = self.k_proj(k).view(B, Lk, M, D)
        vp = self.v_proj(v).view(B, Lk, M, D)
        att = torch.einsum("bqmd,bkmd->bmqk", qp, kp) / math.sqrt(D)
        probs = self.dropout(att.softmax(-1))
        out = torch.einsum("bmqk,bkmd->bqmd", probs, vp)
        return self.out_proj(out.reshape(B, Lq, self.d_model))


class FFN(nn.Module):
    def __init__(self, d_model, d_ffn, dropout=0.1):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, x):
        h = self.dropout1(F.relu(self.linear1(x)))
        return self.norm(x + self.dropout2(self.linear2(h)))


class SingleLinearFFN(nn.Module):
    def __init__(self, d_model, dropout=0.1):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.norm(x + self.dropout(F.gelu(self.linear1(x))))


class MLPHead(nn.Module):
    """Class Linear + 3-layer box MLP, the port's ``DetectionHead``."""

    def __init__(self, d_model, num_classes):
        super().__init__()
        self.class_embed = nn.Linear(d_model, num_classes)
        self.bbox_layers_0 = nn.Linear(d_model, d_model)
        self.bbox_layers_1 = nn.Linear(d_model, d_model)
        self.bbox_layers_2 = nn.Linear(d_model, 4)

    def forward(self, x):
        h = F.relu(self.bbox_layers_0(x))
        h = F.relu(self.bbox_layers_1(h))
        return self.class_embed(x), self.bbox_layers_2(h)


# --------------------------------------------------------------- backbones
class FrozenBatchNorm(nn.Module):
    def __init__(self, n, eps=1e-5):
        super().__init__()
        self.eps = eps
        for k, v in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                     ("running_var", 1.0)):
            self.register_buffer(k, torch.full((n,), v))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        bias = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + bias[None, :, None, None]


def conv(cin, cout, k, stride=1, dilation=1):
    return nn.Conv2d(cin, cout, k, stride, padding=dilation * (k - 1) // 2,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin, planes, stride=1, dilation=1, downsample=False):
        super().__init__()
        self.conv1 = conv(cin, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = conv(cin, planes * 4, 1, stride)
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        idt = self.downsample_bn(self.downsample_conv(x)) \
            if self.downsample else x
        return F.relu(out + idt)


class ResNetStage(nn.Module):
    def __init__(self, planes, blocks, stride=1, dilate=False):
        super().__init__()
        cin = 64 if planes == 64 else planes * 2
        self.blocks = blocks
        for i in range(blocks):
            blk = (Bottleneck(cin, planes, 1 if dilate else stride, 1, True)
                   if i == 0 else
                   Bottleneck(planes * 4, planes, 1, stride if dilate else 1))
            self.add_module(f"block_{i}", blk)

    def forward(self, x):
        for i in range(self.blocks):
            x = getattr(self, f"block_{i}")(x)
        return x


class ResNet50(nn.Module):
    """Stage 4 only (one feature level); DC5 with ``dilation``."""

    def __init__(self, dilation=True):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1 = ResNetStage(64, 3, 1)
        self.layer2 = ResNetStage(128, 4, 2)
        self.layer3 = ResNetStage(256, 6, 2)
        self.layer4 = ResNetStage(512, 3, 2, dilate=dilation)

    def forward(self, x):                               # (B, H, W, 3)
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for s in (1, 2, 3, 4):
            x = getattr(self, f"layer{s}")(x)
        return x.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Trainable BN: batch statistics (biased variance) in train mode,
    updating running = lerp(running, batch, momentum); running statistics
    in eval mode."""

    def __init__(self, n, eps=1e-5, momentum=0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return ((x - mean[None, :, None, None])
                * torch.rsqrt(var + self.eps)[None, :, None, None]
                * self.weight[None, :, None, None]
                + self.bias[None, :, None, None])


class DFormerDownsamplePath(nn.Module):
    def __init__(self, dims=(32, 64, 128)):
        super().__init__()
        self.dims = dims
        self.stem_conv1 = nn.Conv2d(1, dims[0] // 2, 3, 2, 1)
        self.stem_bn1 = BatchNorm(dims[0] // 2)
        self.stem_conv2 = nn.Conv2d(dims[0] // 2, dims[0], 3, 2, 1)
        self.stem_bn2 = BatchNorm(dims[0])
        for i in range(len(dims) - 1):
            self.add_module(f"stage{i + 1}_bn", BatchNorm(dims[i]))
            self.add_module(f"stage{i + 1}_conv",
                            nn.Conv2d(dims[i], dims[i + 1], 3, 2, 1))

    def forward(self, x):                               # (B, H, W, 1)
        x = x.permute(0, 3, 1, 2)
        x = F.gelu(self.stem_bn1(self.stem_conv1(x)))
        x = self.stem_bn2(self.stem_conv2(x))
        for i in range(len(self.dims) - 1):
            x = getattr(self, f"stage{i + 1}_conv")(
                getattr(self, f"stage{i + 1}_bn")(x))
        return x.permute(0, 2, 3, 1)


class DFormerBackbone(nn.Module):
    def __init__(self):
        super().__init__()
        self.downsample_path = DFormerDownsamplePath()

    def forward(self, depth, mask):
        feat = self.downsample_path(depth)
        return feat, downsample_mask(mask, feat.shape[1:3])


class InputProj(nn.Module):
    def __init__(self, cin, d):
        super().__init__()
        self.conv = nn.Conv2d(cin, d, 1)
        self.gn = nn.GroupNorm(32, d, eps=1e-5)

    def forward(self, x):
        return self.gn(self.conv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)


# ------------------------------------------------------------- transformer
class EncoderLayer(nn.Module):
    def __init__(self, d, d_ffn, n_heads, n_points, dropout):
        super().__init__()
        self.self_attn = MSDeformAttn(d, 1, n_heads, n_points)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.ffn = FFN(d, d_ffn, dropout)

    def forward(self, src, pos, ref, shapes, mask):
        src2 = self.self_attn(with_pos(src, pos), ref, src, shapes, mask)
        return self.ffn(self.norm1(src + self.dropout1(src2)))


class DecoderLayer(nn.Module):
    def __init__(self, d, d_ffn, n_heads, n_points, dropout):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, n_heads, dropout)
        self.dropout2 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn = MSDeformAttn(d, 1, n_heads, n_points)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.ffn = FFN(d, d_ffn, dropout)

    def forward(self, tgt, query_pos, ref, src, shapes, mask=None):
        q = with_pos(tgt, query_pos)
        tgt = self.norm2(tgt + self.dropout2(self.self_attn(q, q, tgt)))
        tgt2 = self.cross_attn(with_pos(tgt, query_pos), ref, src, shapes,
                               mask)
        return self.ffn(self.norm1(tgt + self.dropout1(tgt2)))


class DepthFusionLayer(nn.Module):
    def __init__(self, d, n_heads, n_points, dropout):
        super().__init__()
        self.depth_scale_adapt = nn.Linear(d, d)
        self.norm_depth_scale = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn = MSDeformAttn(d, 1, n_heads, n_points)
        self.cross_scale_adapt = nn.Linear(d, d)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.ffn = SingleLinearFFN(d, dropout)

    def forward(self, tgt, pos, ref, src, shapes, mask):
        src = self.norm_depth_scale(self.depth_scale_adapt(src))
        tgt2 = self.cross_attn(with_pos(tgt, pos), ref[:, :, :1], src,
                               shapes, mask)
        return self.ffn(self.norm1(tgt + self.dropout1(
            self.cross_scale_adapt(tgt2))))


def valid_ratio(mask):
    """(B, 2) as (w, h): the unpadded share of the columns and rows."""
    not_mask = ~mask
    _, H, W = mask.shape
    return torch.stack([not_mask[:, 0, :].float().sum(1) / W,
                        not_mask[:, :, 0].float().sum(1) / H], -1)


def encoder_reference_points(shape, vr):
    """(B, H*W, 1, 2): pixel centres over the valid region, times the
    level's valid ratio. vr: (B, 1, 2)."""
    H, W = shape
    dev = vr.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev) + 0.5,
                            torch.arange(W, device=dev) + 0.5,
                            indexing="ij")
    ref_y = ys.reshape(-1)[None] / (vr[:, None, 0, 1] * H)
    ref_x = xs.reshape(-1)[None] / (vr[:, None, 0, 0] * W)
    ref = torch.stack([ref_x, ref_y], -1)
    return ref[:, :, None] * vr[:, None]


class Transformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d = cfg["hidden_dim"]
        self.num_encoder_layers = cfg["enc_layers"]
        self.num_decoder_layers = cfg["dec_layers"]
        self.level_embed = nn.Parameter(torch.zeros(1, d))
        self.query_embed = nn.Parameter(torch.zeros(cfg["num_queries"],
                                                    2 * d))
        self.reference_points = nn.Linear(d, 2)
        self.depth_encoder_layer = DepthFusionLayer(
            d, cfg["nheads"], cfg["dpth_n_points"], cfg["dropout"])
        for i in range(self.num_encoder_layers):
            self.add_module(f"encoder_layers_{i}", EncoderLayer(
                d, cfg["dim_feedforward"], cfg["nheads"],
                cfg["enc_n_points"], cfg["dropout"]))
        for i in range(self.num_decoder_layers):
            self.add_module(f"decoder_layers_{i}", DecoderLayer(
                d, cfg["dim_feedforward"], cfg["nheads"],
                cfg["dec_n_points"], cfg["dropout"]))
            self.add_module(f"head_{i}", MLPHead(d, cfg["num_classes"]))

    def forward(self, src, mask, pos, dsrc, dmask):
        B, H, W, d = src.shape
        shapes = ((H, W),)
        src_flat = src.reshape(B, H * W, d)
        mask_flat = mask.reshape(B, -1)
        pos_flat = pos.reshape(B, H * W, d) + self.level_embed[0]
        vr = valid_ratio(mask)[:, None]                     # (B, 1, 2)
        ref_enc = encoder_reference_points((H, W), vr)
        dh, dw = dsrc.shape[1:3]
        depth_flat = dsrc.reshape(B, dh * dw, d)
        src_flat = src_flat + self.depth_encoder_layer(
            src_flat, pos_flat, ref_enc, depth_flat, ((dh, dw),),
            dmask.reshape(B, -1))
        out = src_flat
        for i in range(self.num_encoder_layers):
            out = getattr(self, f"encoder_layers_{i}")(
                out, pos_flat, ref_enc, shapes, mask_flat)
        t = self.decode(out, mask_flat, vr, shapes)
        t["pos_flat"] = pos_flat
        return t

    def decode(self, memory, mask_flat, vr, shapes):
        """The decoder and its heads over the encoder's ``memory``."""
        B, d = memory.shape[0], memory.shape[-1]
        query_pos, tgt = self.query_embed.split(d, dim=-1)
        query_pos = query_pos[None].expand(B, -1, -1)
        tgt = tgt[None].expand(B, -1, -1)
        ref = torch.sigmoid(self.reference_points(query_pos))
        classes, coords = [], []
        out = tgt
        for lid in range(self.num_decoder_layers):
            if ref.shape[-1] == 4:
                ref_in = ref[:, :, None] * torch.cat([vr, vr], -1)[:, None]
            else:
                ref_in = ref[:, :, None] * vr[:, None]
            out = getattr(self, f"decoder_layers_{lid}")(
                out, query_pos, ref_in, memory, shapes, mask_flat)
            logits, deltas = getattr(self, f"head_{lid}")(out)
            coord = apply_box_deltas(deltas, ref)
            classes.append(logits)
            coords.append(coord)
            ref = (torch.sigmoid(deltas + inverse_sigmoid(ref))
                   if ref.shape[-1] == 4 else coord).detach()
        return {"classes": classes, "coords": coords, "memory": memory,
                "hs_last": out, "valid_ratios": vr, "shapes": shapes,
                "last_reference": ref, "last_deltas": deltas}


def apply_box_deltas(deltas, ref):
    """sigmoid(deltas + logit(ref)); a 2-d reference moves the centre and
    the deltas' own size is taken as the box's."""
    if ref.shape[-1] == 4:
        return torch.sigmoid(deltas + inverse_sigmoid(ref))
    return torch.sigmoid(torch.cat([deltas[..., :2] + inverse_sigmoid(ref),
                                    deltas[..., 2:]], -1))


class DeformableDETR(nn.Module):
    """LateFusion single-frame detector. forward(images (B, H, W, 4),
    mask (B, H, W)) -> the port's output dict (pred_logits, pred_boxes,
    aux_outputs) plus the trunk state the temporal head reads."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg["hidden_dim"]
        self.d = d
        self.stride = 16 if cfg["dilation"] else 32
        self.backbone = ResNet50(cfg["dilation"])
        self.depth_backbone = DFormerBackbone()
        self.input_proj_depth_0 = InputProj(128, d)
        self.input_proj_0 = InputProj(2048, d)
        self.transformer = Transformer(cfg)

    def forward(self, images, mask):
        feat = self.backbone(images[..., :3])
        fmask = downsample_mask(mask, feat.shape[1:3])
        src = self.input_proj_0(feat)
        pos = sine_position_embedding(fmask, self.d // 2)
        dfeat, dmask = self.depth_backbone(images[..., 3:4], mask)
        dsrc = self.input_proj_depth_0(dfeat)
        t = self.transformer(src, fmask, pos, dsrc, dmask)
        return self._outputs(t)

    def decode_from(self, memory, mask):
        """The decoder and its heads over a given encoder ``memory`` of
        frames padded by ``mask`` (B, H, W): the trunk dict of ``forward``
        from the encoder's output on, with the geometry (padding, valid
        ratios, positions) worked out from ``mask``."""
        s = self.stride
        fmask = downsample_mask(mask, (-(-mask.shape[1] // s),
                                       -(-mask.shape[2] // s)))
        B, H, W = fmask.shape
        t = self.transformer.decode(memory, fmask.reshape(B, -1),
                                    valid_ratio(fmask)[:, None], ((H, W),))
        pos = sine_position_embedding(fmask, self.d // 2)
        t["pos_flat"] = (pos.reshape(B, H * W, self.d)
                         + self.transformer.level_embed[0])
        return t

    def _outputs(self, t):
        return {"pred_logits": t["classes"][-1],
                "pred_boxes": t["coords"][-1],
                "aux_outputs": [{"pred_logits": c, "pred_boxes": b}
                                for c, b in zip(t["classes"][:-1],
                                                t["coords"][:-1])],
                "_trunk": t}


# ---------------------------------------------------------------- temporal
class TemporalQueryLayer(nn.Module):
    def __init__(self, d, d_ffn, dropout, n_heads):
        super().__init__()
        self.self_attn = MultiHeadAttention(d, n_heads, dropout)
        self.dropout2 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn = MultiHeadAttention(d, n_heads, dropout)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.ffn = FFN(d, d_ffn, dropout)

    def forward(self, query, ref_query):
        tgt = self.norm2(query + self.dropout2(
            self.self_attn(query, query, query)))
        tgt = self.norm1(tgt + self.dropout1(
            self.cross_attn(tgt, ref_query, ref_query)))
        return self.ffn(tgt)


class DynamicConv(nn.Module):
    def __init__(self, d, dim_dynamic=64, pooler=7):
        super().__init__()
        self.d, self.dd = d, dim_dynamic
        self.dynamic_layer = nn.Linear(d, 2 * d * dim_dynamic)
        self.norm1 = nn.LayerNorm(dim_dynamic, eps=1e-5)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.out_layer = nn.Linear(d * pooler ** 2, d)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, pro, roi):
        B, R = pro.shape[:2]
        params = self.dynamic_layer(pro)
        p1 = params[..., :self.d * self.dd].reshape(B, R, self.d, self.dd)
        p2 = params[..., self.d * self.dd:].reshape(B, R, self.dd, self.d)
        f = F.relu(self.norm1(roi @ p1))
        f = F.relu(self.norm2(f @ p2))
        return F.relu(self.norm3(self.out_layer(f.reshape(B, R, -1))))


class RCNNHead(nn.Module):
    def __init__(self, d, d_ffn, n_heads, dropout):
        super().__init__()
        self.d = d
        self.self_attn = MultiHeadAttention(d, n_heads, dropout)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.inst_interact = DynamicConv(d)
        self.dropout2 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.linear1 = nn.Linear(d, d_ffn)
        self.dropout3 = Dropout(dropout)
        self.linear2 = nn.Linear(d_ffn, d)
        self.dropout4 = Dropout(dropout)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, rois, pro):
        B, R = pro.shape[:2]
        roi = rois.reshape(B, R, -1, self.d)
        pro = self.norm1(pro + self.dropout1(self.self_attn(pro, pro, pro)))
        pro = pro + self.dropout2(self.inst_interact(pro, roi))
        obj = self.norm2(pro)
        obj2 = self.linear2(self.dropout3(F.relu(self.linear1(obj))))
        return self.norm3(obj + self.dropout4(obj2))


class TemporalDecoder(nn.Module):
    def __init__(self, d, d_ffn, dropout, n_heads, n_points, num_layers=1):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layers_{i}", DecoderLayer(d, d_ffn, n_heads,
                                                        n_points, dropout))

    def forward(self, tgt, ref, src, shapes, vr):
        out = tgt
        for i in range(self.num_layers):
            ref_in = (ref[:, :, None] * torch.cat([vr, vr], -1)[:, None]
                      if ref.shape[-1] == 4 else ref[:, :, None] * vr[:, None])
            out = getattr(self, f"layers_{i}")(out, None, ref_in, src, shapes)
        return out


def roi_align(features, boxes, output_size=7, spatial_scale=1.0,
              sampling_ratio=2):
    """mmcv RoIAlign (aligned=True) by ``F.grid_sample``. features (B, H,
    W, C); boxes (B, R, 4) xyxy pixels, box r of row b pooling from row b.
    Each bin averages sr x sr bilinear samples; a sample beyond [-1, H] or
    [-1, W] counts 0, the others are clamped into the map first."""
    B, H, W, C = features.shape
    R, P, sr = boxes.shape[1], output_size, sampling_ratio
    G = P * sr
    b = boxes.detach().float() * spatial_scale - 0.5
    x1, y1, x2, y2 = b.unbind(-1)
    bw = (x2 - x1).clamp(min=1e-6)[..., None] / P
    bh = (y2 - y1).clamp(min=1e-6)[..., None] / P
    frac = (torch.arange(G, device=b.device, dtype=torch.float32)
            + 0.5) / sr
    xs = x1[..., None] + frac * bw                          # (B, R, G)
    ys = y1[..., None] + frac * bh
    yy = ys[..., :, None].expand(B, R, G, G)
    xx = xs[..., None, :].expand(B, R, G, G)
    inside = (yy >= -1) & (yy <= H) & (xx >= -1) & (xx <= W)
    gx = xx.clamp(0, W - 1) / max(W - 1, 1) * 2 - 1
    gy = yy.clamp(0, H - 1) / max(H - 1, 1) * 2 - 1
    grid = torch.stack([gx, gy], -1).reshape(B, R * G, G, 2)
    s = F.grid_sample(features.permute(0, 3, 1, 2).float(), grid,
                      mode="bilinear", align_corners=True)  # (B, C, R*G, G)
    s = s.reshape(B, C, R, G, G) * inside[:, None].float()
    s = s.reshape(B, C, R, P, sr, P, sr).mean((4, 6))
    return s.permute(0, 2, 3, 4, 1)                         # (B, R, P, P, C)


class TransVODPP(nn.Module):
    """TransVOD++ over clips of F = 1 + num_ref_frames frames, key frame
    first. forward(images (B*F, H, W, 4), mask) -> key-frame outputs with
    aux_outputs of rounds 1 and 2."""

    def __init__(self, cfg):
        super().__init__()
        d, ffn = cfg["hidden_dim"], cfg["dim_feedforward"]
        self.cfg = cfg
        self.detr = DeformableDETR(cfg)
        for i in (1, 2, 3):
            self.add_module(f"temporal_query_layer{i}", TemporalQueryLayer(
                d, ffn, cfg["dropout"], cfg["nheads"]))
        self.qrf_dynamic_layer1 = RCNNHead(d, ffn, cfg["nheads"],
                                           cfg["dropout"])
        for i in (1, 2, 3):
            self.add_module(f"temporal_decoder{i}", TemporalDecoder(
                d, ffn, cfg["dropout"], cfg["nheads"], cfg["dec_n_points"],
                cfg["n_temporal_decoder_layers"]))
        for i in (0, 1, 2):
            self.add_module(f"temp_head_{i}", MLPHead(d, cfg["num_classes"]))

    def forward(self, images, mask):
        N = self.cfg["num_ref_frames"]
        Fr = N + 1
        B = images.shape[0] // Fr
        sf = self.detr(images, mask)
        out = self.temporal_head(sf["_trunk"], sf["pred_logits"], mask)
        B = images.shape[0] // (self.cfg["num_ref_frames"] + 1)
        Fr = self.cfg["num_ref_frames"] + 1
        out["_single_frame"] = {
            k: sf[k].reshape(B, Fr, *sf[k].shape[1:])[:, 0]
            for k in ("pred_logits", "pred_boxes")}
        return out

    def temporal_head(self, t, logits, mask):
        """The QRF and the three temporal rounds from the trunk's outputs
        over whole clips: ``t`` holds memory, pos_flat, hs_last,
        last_reference, last_deltas and valid_ratios of every frame,
        ``logits`` every frame's last-layer class logits."""
        N = self.cfg["num_ref_frames"]
        Fr = N + 1
        B = t["memory"].shape[0] // Fr
        d = self.detr.d
        img_h, img_w = mask.shape[1:]
        H1, W1 = -(-img_h // 16), -(-img_w // 16)

        def split(x):
            x = x.reshape(B, Fr, *x.shape[1:])
            return x[:, 0], x[:, 1:]

        cur_memory = split(t["memory"])[0]
        ref_logits = split(logits)[1]
        hand_prob = torch.sigmoid(ref_logits.reshape(B, -1, ref_logits.shape[
            -1]))[..., 1]                                   # (B, N*Q)
        cur_ref = split(t["last_reference"])[0]
        vr = split(t["valid_ratios"])[0]                    # (B, 1, 2)
        whwh = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32,
                            device=mask.device)
        # the port's QRF applies the last deltas to the refined reference
        boxes = apply_box_deltas(t["last_deltas"], t["last_reference"])
        boxes = box_cxcywh_to_xyxy(boxes) * whwh
        mem = t["memory"].reshape(-1, H1, W1, d)
        pos = t["pos_flat"].reshape(-1, H1, W1, d)
        is_ref = (torch.arange(B * Fr, device=mask.device) % Fr) != 0
        mem = torch.where(is_ref[:, None, None, None], mem + pos, mem)
        rois = roi_align(mem, boxes, 7, 1 / 32, 2)
        hs = self.qrf_dynamic_layer1(rois, t["hs_last"])
        Q = hs.shape[1]
        hs = hs.reshape(B, Fr, Q, d)
        cur_hs, ref_hs = hs[:, 0], hs[:, 1:].reshape(B, N * Q, d)
        outs = []
        for i, k_mult in enumerate((80, 50, 30)):
            k = min(k_mult * N, hand_prob.shape[1])
            idx = torch.topk(hand_prob, k, dim=1).indices
            sel = torch.gather(ref_hs, 1, idx[..., None].expand(-1, -1, d))
            cur_hs = getattr(self, f"temporal_query_layer{i + 1}")(cur_hs,
                                                                   sel)
            cur_hs = getattr(self, f"temporal_decoder{i + 1}")(
                cur_hs, cur_ref, cur_memory, ((H1, W1),), vr)
            logits_i, deltas = getattr(self, f"temp_head_{i}")(cur_hs)
            outs.append({"pred_logits": logits_i,
                         "pred_boxes": apply_box_deltas(deltas, cur_ref)})
        return {**outs[2], "aux_outputs": outs[:2], "hs": cur_hs}


def build(cfg):
    """The reference model of a configuration dict (the ``config`` block of
    a ``perfbench/configs`` file), f32, in eval mode, on the current
    default device."""
    if cfg["fusion_type"] != "LateFusion" or cfg["num_feature_levels"] != 1:
        raise ValueError("the reference covers LateFusion at one level")
    if cfg.get("temporal_mode", "none") == "transvod_pp":
        return TransVODPP(cfg).eval()
    if cfg.get("temporal_mode", "none") != "none":
        raise ValueError(f"temporal_mode {cfg['temporal_mode']!r}")
    return DeformableDETR(cfg).eval()


def postprocess(logits, boxes, sizes, top_k=100):
    """Sigmoid, top-k over (query, class) with the 3-class set's no-object
    channel left out, boxes to xyxy pixels of each content size."""
    B, Q, K = logits.shape
    Ke = K - 1 if K == 3 else K
    prob = torch.sigmoid(logits[..., :Ke]).reshape(B, Q * Ke)
    scores, idx = torch.topk(prob, min(top_k, Q * Ke), dim=1)
    xyxy = torch.gather(box_cxcywh_to_xyxy(boxes), 1,
                        (idx // Ke)[..., None].expand(-1, -1, 4))
    h, w = sizes[:, 0].float(), sizes[:, 1].float()
    return scores, idx % Ke, xyxy * torch.stack([w, h, w, h], 1)[:, None]


def ring_bias(n_heads, n_levels, n_points):
    """The sampling-offset bias of Deformable DETR's initialization: head
    m points along angle 2*pi*m/M, point p at distance p+1."""
    th = np.arange(n_heads) * (2 * math.pi / n_heads)
    g = np.stack([np.cos(th), np.sin(th)], -1)
    g = g / np.abs(g).max(-1, keepdims=True)
    g = np.tile(g[:, None, None, :], (1, n_levels, n_points, 1))
    g = g * (np.arange(n_points) + 1)[None, None, :, None]
    return torch.tensor(g.reshape(-1), dtype=torch.float32)
