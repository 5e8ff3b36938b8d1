"""Full-model torch replicas of the reference — test-only parity oracles.

Re-typed, minimal, dropout-free replicas of the reference's composed
models so the *composition* (flatten ordering, valid-ratio scaling,
refine-head chaining, fusion hooks, QRF wiring) can be parity-tested
end-to-end through the checkpoint converter, not just module-by-module.

Sources (reference file:line):
- MSDeformAttn module + grid-sample kernel oracle:
  ``models/ops/modules/ms_deform_attn.py:28-117``,
  ``models/ops/functions/ms_deform_attn_func.py:41-61``
- sine position embedding: ``models/position_encoding.py:20-58``
- ResNet-50 FrozenBN backbone (explicit forward):
  ``models/backbone_scratch.py:95-168``
- DFormer depth stem: ``models/dformer_backbone.py:18-160``
- encoder/decoder layers + transformer:
  ``models/deformable_transformer_single.py:179-785``
- DeformableDETR: ``models/deformable_detr_single.py:44-362``
- Backbone Cross-Fusion: ``models/dformer_crossfusion_backbone.py``
  (with the documented channel-sizing fix, see
  ``dfvod_tpu/models/backbone_crossfusion.py:11-17``)

State-dict names deliberately mirror the reference so
``dfvod_tpu.utils.convert_reference`` consumes them unchanged.
"""
import copy
import math

import torch
import torch.nn as tnn
import torch.nn.functional as F


# --------------------------------------------------------------------------
# kernel oracle + MSDeformAttn module
# --------------------------------------------------------------------------
def grid_sample_msda(value, shapes, loc, attw):
    """``ms_deform_attn_core_pytorch`` (``ms_deform_attn_func.py:41-61``)."""
    N, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    value_list = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    samples = []
    for lid, (h, w) in enumerate(shapes):
        v = value_list[lid].flatten(2).transpose(1, 2).reshape(
            N * M, D, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        samples.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    attw = attw.transpose(1, 2).reshape(N * M, 1, Lq, L * P)
    out = (torch.stack(samples, dim=-2).flatten(-2) * attw).sum(-1)
    return out.view(N, M * D, Lq).transpose(1, 2).contiguous()


class TorchMSDeformAttn(tnn.Module):
    """``ms_deform_attn.py:28-117`` with the grid-sample oracle kernel."""

    def __init__(self, d_model, n_levels, n_heads, n_points):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = (n_levels, n_heads,
                                                      n_points)
        self.d_model = d_model
        self.sampling_offsets = tnn.Linear(
            d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = tnn.Linear(
            d_model, n_heads * n_levels * n_points)
        self.value_proj = tnn.Linear(d_model, d_model)
        self.output_proj = tnn.Linear(d_model, d_model)
        self._reset_parameters()

    def _reset_parameters(self):
        # ring-of-directions bias init (``:62-76``)
        tnn.init.constant_(self.sampling_offsets.weight, 0.0)
        thetas = torch.arange(self.n_heads, dtype=torch.float32) * (
            2.0 * math.pi / self.n_heads)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = (grid / grid.abs().max(-1, keepdim=True)[0]).view(
            self.n_heads, 1, 1, 2).repeat(1, self.n_levels, self.n_points, 1)
        for i in range(self.n_points):
            grid[:, :, i, :] *= i + 1
        with torch.no_grad():
            self.sampling_offsets.bias = tnn.Parameter(grid.reshape(-1))
        tnn.init.constant_(self.attention_weights.weight, 0.0)
        tnn.init.constant_(self.attention_weights.bias, 0.0)
        tnn.init.xavier_uniform_(self.value_proj.weight)
        tnn.init.constant_(self.value_proj.bias, 0.0)
        tnn.init.xavier_uniform_(self.output_proj.weight)
        tnn.init.constant_(self.output_proj.bias, 0.0)

    def forward(self, query, reference_points, value_in, shapes,
                padding_mask=None):
        N, Lq, _ = query.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        D = self.d_model // M
        value = self.value_proj(value_in)
        if padding_mask is not None:
            value = value.masked_fill(padding_mask[..., None], 0.0)
        value = value.view(N, -1, M, D)
        offsets = self.sampling_offsets(query).view(N, Lq, M, L, P, 2)
        attw = self.attention_weights(query).view(N, Lq, M, L * P)
        attw = attw.softmax(-1).view(N, Lq, M, L, P)
        if reference_points.shape[-1] == 2:
            wh = torch.as_tensor([[w, h] for h, w in shapes],
                                 dtype=torch.float32)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / wh[None, None, None, :, None, :])
        else:  # 4-coord refs (``ms_deform_attn.py:107-113``)
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P
                   * reference_points[:, :, None, :, None, 2:] * 0.5)
        out = grid_sample_msda(value, shapes, loc, attw)
        return self.output_proj(out)


# --------------------------------------------------------------------------
# position embedding + mask helper
# --------------------------------------------------------------------------
class TorchPositionEmbeddingSine(tnn.Module):
    """``position_encoding.py:20-58`` (normalize=True build, ``:87-97``)."""

    def __init__(self, num_pos_feats=128, temperature=10000):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.temperature = temperature
        self.scale = 2 * math.pi

    def forward(self, x, mask):
        not_mask = ~mask
        y_embed = not_mask.cumsum(1, dtype=torch.float32)
        x_embed = not_mask.cumsum(2, dtype=torch.float32)
        eps = 1e-6
        y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * self.scale
        x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * self.scale
        dim_t = torch.arange(self.num_pos_feats, dtype=torch.float32)
        dim_t = self.temperature ** (2 * (dim_t // 2) / self.num_pos_feats)
        pos_x = x_embed[:, :, :, None] / dim_t
        pos_y = y_embed[:, :, :, None] / dim_t
        pos_x = torch.stack((pos_x[:, :, :, 0::2].sin(),
                             pos_x[:, :, :, 1::2].cos()), dim=4).flatten(3)
        pos_y = torch.stack((pos_y[:, :, :, 0::2].sin(),
                             pos_y[:, :, :, 1::2].cos()), dim=4).flatten(3)
        return torch.cat((pos_y, pos_x), dim=3).permute(0, 3, 1, 2)


def interp_mask(mask, size):
    """``F.interpolate(m[None].float(), size=...)`` mask downsampling used
    throughout the reference backbones."""
    return F.interpolate(mask[None].float(), size=size).to(torch.bool)[0]


# --------------------------------------------------------------------------
# ResNet-50 (FrozenBN == eval-mode BatchNorm) — ``backbone_scratch.py``
# --------------------------------------------------------------------------
class Bottleneck(tnn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride=1, dilation=1, downsample=None):
        super().__init__()
        self.conv1 = tnn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, stride, dilation,
                                dilation, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.conv3 = tnn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = tnn.BatchNorm2d(planes * 4)
        self.downsample = downsample
        self.relu = tnn.ReLU()

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + idt)


class TorchR50(tnn.Module):
    """torchvision-layout ResNet-50 trunk (stage outputs, no fc)."""

    def __init__(self, dilate_l4=True):
        super().__init__()
        self.conv1 = tnn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = tnn.BatchNorm2d(64)
        self.relu = tnn.ReLU()
        self.maxpool = tnn.MaxPool2d(3, 2, 1)
        cfgs = [(64, 3, 1, False), (128, 4, 2, False),
                (256, 6, 2, False), (512, 3, 2, dilate_l4)]
        cin = 64
        for i, (planes, blocks, stride, dilate) in enumerate(cfgs):
            s = 1 if dilate else stride
            ds = tnn.Sequential(
                tnn.Conv2d(cin, planes * 4, 1, s, bias=False),
                tnn.BatchNorm2d(planes * 4))
            layers = [Bottleneck(cin, planes, s, 1, ds)]
            dil = stride if dilate else 1
            cin = planes * 4
            for _ in range(1, blocks):
                layers.append(Bottleneck(cin, planes, 1, dil))
            setattr(self, f"layer{i + 1}", tnn.Sequential(*layers))

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        outs = []
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
            outs.append(x)
        return outs


class TorchRGBBackbone(tnn.Module):
    """``backbone_scratch.py:95-141``: explicit stage-wise forward; owns
    the ResNet as ``.body`` so state names are ``backbone.0.body.*``."""

    def __init__(self, return_interm_layers: bool, dilation: bool):
        super().__init__()
        self.body = TorchR50(dilate_l4=dilation)
        self.return_interm_layers = return_interm_layers

    def forward(self, x, mask):
        outs = self.body(x)
        feats = outs[1:] if self.return_interm_layers else [outs[-1]]
        masks = [interp_mask(mask, f.shape[-2:]) for f in feats]
        return feats, masks


# --------------------------------------------------------------------------
# DFormer depth stem — ``dformer_backbone.py:18-160``
# --------------------------------------------------------------------------
class TorchDownsamplePath(tnn.Module):
    def __init__(self, in_channels=1, dims=(32, 64, 128, 256)):
        super().__init__()
        self.downsample_layers_e = tnn.ModuleList()
        stem = tnn.Sequential(
            tnn.Conv2d(in_channels, dims[0] // 2, 3, 2, 1),
            tnn.BatchNorm2d(dims[0] // 2),
            tnn.GELU(),
            tnn.Conv2d(dims[0] // 2, dims[0], 3, 2, 1),
            tnn.BatchNorm2d(dims[0]))
        self.downsample_layers_e.append(stem)
        for i in range(len(dims) - 1):
            self.downsample_layers_e.append(tnn.Sequential(
                tnn.BatchNorm2d(dims[i]),
                tnn.Conv2d(dims[i], dims[i + 1], 3, 2, 1)))


class TorchDFormerBackbone(tnn.Module):
    """``dformer_backbone.py:74-160``: only the first 3 stages run —
    single 128-ch stride-16 output. Owns the path as ``.depth_backbone``
    so state names are ``depth_backbone.0.depth_backbone.*``."""

    def __init__(self, dims=(32, 64, 128, 256)):
        super().__init__()
        self.depth_backbone = TorchDownsamplePath(1, dims)

    def forward(self, x, mask):
        for layer in self.depth_backbone.downsample_layers_e[:-1]:
            x = layer(x)
        return [x], [interp_mask(mask, x.shape[-2:])]


# --------------------------------------------------------------------------
# transformer layers — ``deformable_transformer_single.py``
# --------------------------------------------------------------------------
class TorchEncoderLayer(tnn.Module):
    """``DeformableTransformerEncoderLayer`` (``:520-563``)."""

    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points):
        super().__init__()
        self.self_attn = TorchMSDeformAttn(d_model, n_levels, n_heads,
                                           n_points)
        self.norm1 = tnn.LayerNorm(d_model)
        self.linear1 = tnn.Linear(d_model, d_ffn)
        self.linear2 = tnn.Linear(d_ffn, d_model)
        self.norm2 = tnn.LayerNorm(d_model)

    def forward(self, src, pos, ref, shapes, mask=None):
        src2 = self.self_attn(src + pos, ref, src, shapes, mask)
        src = self.norm1(src + src2)
        src2 = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + src2)


class TorchDecoderLayer(tnn.Module):
    """``DeformableTransformerDecoderLayer`` (``:596-648``)."""

    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points):
        super().__init__()
        self.cross_attn = TorchMSDeformAttn(d_model, n_levels, n_heads,
                                            n_points)
        self.norm1 = tnn.LayerNorm(d_model)
        self.self_attn = tnn.MultiheadAttention(d_model, n_heads,
                                                dropout=0.0)
        self.norm2 = tnn.LayerNorm(d_model)
        self.linear1 = tnn.Linear(d_model, d_ffn)
        self.linear2 = tnn.Linear(d_ffn, d_model)
        self.norm3 = tnn.LayerNorm(d_model)

    def forward(self, tgt, query_pos, ref, src, shapes, src_mask=None):
        wp = tgt if query_pos is None else tgt + query_pos
        q = k = wp.transpose(0, 1)
        tgt2 = self.self_attn(q, k, tgt.transpose(0, 1))[0].transpose(0, 1)
        tgt = self.norm2(tgt + tgt2)
        wp = tgt if query_pos is None else tgt + query_pos
        tgt2 = self.cross_attn(wp, ref, src, shapes, src_mask)
        tgt = self.norm1(tgt + tgt2)
        tgt2 = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + tgt2)


class TorchLateFusionLayer(tnn.Module):
    """``DepthDeformableTransformerEncoderLayer``. The transformer-file
    variant hard-codes a GELU FFN (``deformable_transformer_single.py:
    359``); the crossfusion-file copy uses the passed activation — relu
    (``dformer_crossfusion_backbone.py:137-139`` + base default)."""

    def __init__(self, d_model, n_heads, n_points, n_levels=1,
                 activation="gelu"):
        super().__init__()
        self.act = F.gelu if activation == "gelu" else F.relu
        self.cross_attn = TorchMSDeformAttn(d_model, n_levels, n_heads,
                                            n_points)
        self.norm1 = tnn.LayerNorm(d_model)
        self.linear1 = tnn.Linear(d_model, d_model)
        self.norm3 = tnn.LayerNorm(d_model)
        self.depth_scale_adapt = tnn.Linear(d_model, d_model)
        self.norm_depth_scale = tnn.LayerNorm(d_model)
        self.cross_scale_adapt = tnn.Linear(d_model, d_model)

    def forward(self, tgt, query_pos, ref, src, src_shapes, src_mask=None):
        src = self.norm_depth_scale(self.depth_scale_adapt(src))
        # RGB reference points over more levels than the depth stream's:
        # the first ones (the JAX package's reading; the reference's
        # multi-level LateFusion does not broadcast)
        ref = ref[:, :, :self.cross_attn.n_levels]
        tgt2 = self.cross_attn(tgt + query_pos, ref, src, src_shapes,
                               src_mask)
        tgt2 = self.cross_scale_adapt(tgt2)
        tgt = self.norm1(tgt + tgt2)
        tgt2 = self.act(self.linear1(tgt))
        return self.norm3(tgt + tgt2)


class TorchFusionLayerV2(tnn.Module):
    """``DeformableTransformerFusionLayerV2`` (``:406-461``) — same math
    as the LateFusion layer; the FFN norm is named ``norm2``."""

    def __init__(self, d_model, n_levels, n_heads, n_points):
        super().__init__()
        self.cross_attn = TorchMSDeformAttn(d_model, n_levels, n_heads,
                                            n_points)
        self.norm1 = tnn.LayerNorm(d_model)
        self.linear1 = tnn.Linear(d_model, d_model)
        self.norm2 = tnn.LayerNorm(d_model)
        self.depth_scale_adapt = tnn.Linear(d_model, d_model)
        self.norm_depth_scale = tnn.LayerNorm(d_model)
        self.cross_scale_adapt = tnn.Linear(d_model, d_model)

    def forward(self, tgt, query_pos, ref, src, src_shapes, src_mask=None):
        src = self.norm_depth_scale(self.depth_scale_adapt(src))
        tgt2 = self.cross_attn(tgt + query_pos, ref, src, src_shapes,
                               src_mask)
        tgt2 = self.cross_scale_adapt(tgt2)
        tgt = self.norm1(tgt + tgt2)
        tgt2 = F.gelu(self.linear1(tgt))
        return self.norm2(tgt + tgt2)


def get_valid_ratio(mask):
    """``deformable_transformer_single.py:155-162``."""
    _, H, W = mask.shape
    valid_h = torch.sum(~mask[:, :, 0], 1).float()
    valid_w = torch.sum(~mask[:, 0, :], 1).float()
    return torch.stack([valid_w / W, valid_h / H], -1)


def get_reference_points(shapes, valid_ratios):
    """``:164-177``."""
    refs = []
    for lvl, (H, W) in enumerate(shapes):
        ref_y, ref_x = torch.meshgrid(
            torch.linspace(0.5, H - 0.5, H, dtype=torch.float32),
            torch.linspace(0.5, W - 0.5, W, dtype=torch.float32),
            indexing="ij")
        ref_y = ref_y.reshape(-1)[None] / (valid_ratios[:, None, lvl, 1] * H)
        ref_x = ref_x.reshape(-1)[None] / (valid_ratios[:, None, lvl, 0] * W)
        refs.append(torch.stack((ref_x, ref_y), -1))
    ref = torch.cat(refs, 1)
    return ref[:, :, None] * valid_ratios[:, None]


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(min=0, max=1)
    x1 = x.clamp(min=eps)
    x2 = (1 - x).clamp(min=eps)
    return torch.log(x1 / x2)


class TorchEncoder(tnn.Module):
    """``DeformableTransformerEncoder`` (``:566-594``) and the Encoder-CF
    variant ``RGBDDeformableTransformerEncoderV2`` (``:465-518``)."""

    def __init__(self, layer, num_layers, fusion_layer=None,
                 num_fusion_layers=0):
        super().__init__()
        self.layers = tnn.ModuleList(
            [copy.deepcopy(layer) for _ in range(num_layers)])
        if fusion_layer is not None:
            self.fusion_layers = tnn.ModuleList(
                [copy.deepcopy(fusion_layer)
                 for _ in range(num_fusion_layers)])
        self.num_fusion_layers = num_fusion_layers

    def forward(self, src, shapes, valid_ratios, pos, mask,
                depth_src=None, depth_shapes=None, depth_mask=None):
        output = src
        output_fusion = depth_src
        ref = get_reference_points(shapes, valid_ratios)
        for i, layer in enumerate(self.layers):
            output = layer(output, pos, ref, shapes, mask)
            if depth_src is not None and i < self.num_fusion_layers:
                # ``:497-518``: the fusion output becomes the next fusion
                # source, and the RGB padding mask is applied to it
                output_fusion = self.fusion_layers[i](
                    output, pos, ref, output_fusion, depth_shapes, mask)
                output = output + output_fusion
        return output


class TorchMLP(tnn.Module):
    """3-layer box MLP (``deformable_detr_single.py:606-618``)."""

    def __init__(self, d_in, d_hidden, d_out, n_layers=3):
        super().__init__()
        dims = [d_in] + [d_hidden] * (n_layers - 1)
        self.layers = tnn.ModuleList(
            [tnn.Linear(a, b) for a, b in
             zip(dims, dims[1:] + [d_out])])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


class TorchDecoder(tnn.Module):
    """``DeformableTransformerDecoder`` (``:703-760``),
    return_intermediate=True."""

    def __init__(self, layer, num_layers):
        super().__init__()
        self.layers = tnn.ModuleList(
            [copy.deepcopy(layer) for _ in range(num_layers)])
        self.num_layers = num_layers
        self.bbox_embed = None

    def forward(self, tgt, reference_points, src, shapes, valid_ratios,
                query_pos, src_mask):
        output = tgt
        inter, inter_refs = [], []
        for lid, layer in enumerate(self.layers):
            if reference_points.shape[-1] == 4:
                ref_input = (reference_points[:, :, None]
                             * torch.cat([valid_ratios, valid_ratios],
                                         -1)[:, None])
            else:
                ref_input = reference_points[:, :, None] * \
                    valid_ratios[:, None]
            output = layer(output, query_pos, ref_input, src, shapes,
                           src_mask)
            if self.bbox_embed is not None:
                tmp = self.bbox_embed[lid](output)
                if reference_points.shape[-1] == 4:
                    new_ref = (tmp + inverse_sigmoid(reference_points)
                               ).sigmoid()
                else:
                    new_ref = torch.cat(
                        [tmp[..., :2] + inverse_sigmoid(reference_points),
                         tmp[..., 2:]], -1).sigmoid()
                reference_points = new_ref.detach()
            inter.append(output)
            inter_refs.append(reference_points)
        return torch.stack(inter), torch.stack(inter_refs)


class TorchDeformableTransformer(tnn.Module):
    """``DeformableTransformer`` (``:24-338``)."""

    def __init__(self, d_model=256, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=1024,
                 num_feature_levels=4, dec_n_points=4, enc_n_points=4,
                 two_stage=False, two_stage_num_proposals=300,
                 depth_type="Baseline_rgb", dpth_n_points=4):
        super().__init__()
        self.d_model = d_model
        self.depth_type = depth_type
        self.two_stage = two_stage
        self.two_stage_num_proposals = two_stage_num_proposals
        if "latefusion" in depth_type:
            self.depth_encoder_layer = TorchLateFusionLayer(
                d_model, nhead, dpth_n_points, n_levels=1)
        enc_layer = TorchEncoderLayer(d_model, dim_feedforward,
                                      num_feature_levels, nhead,
                                      enc_n_points)
        if "encoder_cf" in depth_type:
            fusion_layer = TorchFusionLayerV2(
                d_model, num_feature_levels, nhead, enc_n_points)
            self.encoder = TorchEncoder(enc_layer, num_encoder_layers,
                                        fusion_layer, 4)
        else:
            self.encoder = TorchEncoder(enc_layer, num_encoder_layers)
        dec_layer = TorchDecoderLayer(d_model, dim_feedforward,
                                      num_feature_levels, nhead,
                                      dec_n_points)
        self.decoder = TorchDecoder(dec_layer, num_decoder_layers)
        self.level_embed = tnn.Parameter(
            torch.randn(num_feature_levels, d_model))
        if two_stage:
            self.enc_output = tnn.Linear(d_model, d_model)
            self.enc_output_norm = tnn.LayerNorm(d_model)
            self.pos_trans = tnn.Linear(d_model * 2, d_model * 2)
            self.pos_trans_norm = tnn.LayerNorm(d_model * 2)
        else:
            self.reference_points = tnn.Linear(d_model, 2)

    def get_proposal_pos_embed(self, proposals):
        """``:111-125``; num_pos_feats scales with d_model (the reference
        hard-codes 128 for d_model=256)."""
        num_pos_feats = self.d_model // 2
        temperature = 10000
        scale = 2 * math.pi
        dim_t = torch.arange(num_pos_feats, dtype=torch.float32)
        dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
        proposals = proposals.sigmoid() * scale
        pos = proposals[:, :, :, None] / dim_t
        pos = torch.stack((pos[:, :, :, 0::2].sin(),
                           pos[:, :, :, 1::2].cos()), dim=4).flatten(2)
        return pos

    def gen_encoder_output_proposals(self, memory, mask_flat, shapes):
        """``:126-153``."""
        N, S, C = memory.shape
        proposals = []
        cur = 0
        for lvl, (H, W) in enumerate(shapes):
            mask_l = mask_flat[:, cur:cur + H * W].view(N, H, W, 1)
            valid_H = torch.sum(~mask_l[:, :, 0, 0], 1)
            valid_W = torch.sum(~mask_l[:, 0, :, 0], 1)
            gy, gx = torch.meshgrid(
                torch.linspace(0, H - 1, H, dtype=torch.float32),
                torch.linspace(0, W - 1, W, dtype=torch.float32),
                indexing="ij")
            grid = torch.cat([gx.unsqueeze(-1), gy.unsqueeze(-1)], -1)
            scale = torch.cat([valid_W.unsqueeze(-1),
                               valid_H.unsqueeze(-1)], 1).view(N, 1, 1, 2)
            grid = (grid.unsqueeze(0).expand(N, -1, -1, -1) + 0.5) / scale
            wh = torch.ones_like(grid) * 0.05 * (2.0 ** lvl)
            proposals.append(torch.cat((grid, wh), -1).view(N, -1, 4))
            cur += H * W
        out_props = torch.cat(proposals, 1)
        valid = ((out_props > 0.01) & (out_props < 0.99)).all(-1,
                                                              keepdim=True)
        out_props = torch.log(out_props / (1 - out_props))
        out_props = out_props.masked_fill(mask_flat.unsqueeze(-1),
                                          float("inf"))
        out_props = out_props.masked_fill(~valid, float("inf"))
        out_mem = memory.masked_fill(mask_flat.unsqueeze(-1), 0.0)
        out_mem = out_mem.masked_fill(~valid, 0.0)
        out_mem = self.enc_output_norm(self.enc_output(out_mem))
        return out_mem, out_props

    def forward(self, srcs, masks, pos_embeds, depth_srcs=None,
                depth_masks=None, depth_pos=None, query_embed=None):
        """``:179-338``. srcs: list of (B,C,H,W)."""
        src_flat, mask_flat, pos_flat, shapes = [], [], [], []
        for lvl, (src, mask, pos) in enumerate(zip(srcs, masks,
                                                   pos_embeds)):
            shapes.append((src.shape[2], src.shape[3]))
            src_flat.append(src.flatten(2).transpose(1, 2))
            mask_flat.append(mask.flatten(1))
            pos_flat.append(pos.flatten(2).transpose(1, 2)
                            + self.level_embed[lvl].view(1, 1, -1))
        src_flat = torch.cat(src_flat, 1)
        mask_flat = torch.cat(mask_flat, 1)
        pos_flat = torch.cat(pos_flat, 1)
        valid_ratios = torch.stack([get_valid_ratio(m) for m in masks], 1)

        d_flat = d_mask_flat = d_pos_flat = None
        d_shapes = None
        if depth_srcs is not None:
            d_shapes = [(d.shape[2], d.shape[3]) for d in depth_srcs]
            d_flat = torch.cat([d.flatten(2).transpose(1, 2)
                                for d in depth_srcs], 1)
            d_mask_flat = torch.cat([m.flatten(1) for m in depth_masks], 1)
            # depth carries no level embed (``:226``)
            d_pos_flat = torch.cat([p.flatten(2).transpose(1, 2)
                                    for p in depth_pos], 1)

        if "latefusion" in self.depth_type:
            rgb_ref = get_reference_points(shapes, valid_ratios)
            fused = self.depth_encoder_layer(
                src_flat, pos_flat, rgb_ref, d_flat, d_shapes, d_mask_flat)
            src_flat = src_flat + fused

        if "encoder_cf" in self.depth_type:
            memory = self.encoder(src_flat, shapes, valid_ratios, pos_flat,
                                  mask_flat, d_flat, d_shapes, d_mask_flat)
        else:
            memory = self.encoder(src_flat, shapes, valid_ratios, pos_flat,
                                  mask_flat)

        bs, _, c = memory.shape
        # expose the flatten-stage tensors for the temporal (video) stage
        # (the reference computes them inline in its multi_plusplus copy)
        self._last_extras = (memory, pos_flat, mask_flat, valid_ratios)
        enc_outputs_class = enc_outputs_coord_unact = None
        if self.two_stage:
            out_mem, out_props = self.gen_encoder_output_proposals(
                memory, mask_flat, shapes)
            enc_outputs_class = self.decoder.class_embed[
                self.decoder.num_layers](out_mem)
            enc_outputs_coord_unact = self.decoder.bbox_embed[
                self.decoder.num_layers](out_mem) + out_props
            topk = self.two_stage_num_proposals
            topk_idx = torch.topk(enc_outputs_class[..., 0], topk, dim=1)[1]
            topk_coords = torch.gather(
                enc_outputs_coord_unact, 1,
                topk_idx.unsqueeze(-1).repeat(1, 1, 4)).detach()
            reference_points = topk_coords.sigmoid()
            pos_trans_out = self.pos_trans_norm(self.pos_trans(
                self.get_proposal_pos_embed(topk_coords)))
            query_pos, tgt = torch.split(pos_trans_out, c, dim=2)
        else:
            query_pos, tgt = torch.split(query_embed, c, dim=1)
            query_pos = query_pos.unsqueeze(0).expand(bs, -1, -1)
            tgt = tgt.unsqueeze(0).expand(bs, -1, -1)
            reference_points = self.reference_points(query_pos).sigmoid()
        init_ref = reference_points

        hs, inter_refs = self.decoder(tgt, reference_points, memory,
                                      shapes, valid_ratios, query_pos,
                                      mask_flat)
        return hs, init_ref, inter_refs, enc_outputs_class, \
            enc_outputs_coord_unact


# --------------------------------------------------------------------------
# full single-frame model — ``deformable_detr_single.py:44-362``
# --------------------------------------------------------------------------
def _proj(cin, d_model, kernel=1, stride=1):
    return tnn.Sequential(tnn.Conv2d(cin, d_model, kernel, stride,
                                     (kernel - 1) // 2),
                          tnn.GroupNorm(32, d_model))


class TorchDeformableDETR(tnn.Module):
    def __init__(self, num_classes=3, num_queries=12, d_model=64, nhead=4,
                 enc_layers=3, dec_layers=3, dim_feedforward=128,
                 with_box_refine=True, two_stage=False,
                 depth_type="Baseline_rgb", dilation=True,
                 num_feature_levels=1):
        super().__init__()
        self.use_depth = depth_type != "Baseline_rgb"
        self.depth_type = depth_type
        self.with_box_refine = with_box_refine
        self.two_stage = two_stage
        # more than one level: layer2-4 and 3x3 stride-2 levels after them
        # (``:101-150``, ``:271-281``); RGB backbones only
        self.num_feature_levels = num_feature_levels

        pos_embed = TorchPositionEmbeddingSine(d_model // 2)
        if "crossfusion" in depth_type:
            self.backbone = tnn.ModuleList([TorchCrossFusionBackbone(
                d_model=d_model, nhead=nhead,
                dim_feedforward=dim_feedforward, dilation=dilation,
                pos_embed=pos_embed)])
        else:
            self.backbone = tnn.ModuleList(
                [TorchRGBBackbone(num_feature_levels > 1, dilation)])
        if "latefusion" in depth_type or "encoder_cf" in depth_type:
            self.depth_backbone = tnn.ModuleList([TorchDFormerBackbone()])
            self.input_proj_depth = tnn.ModuleList([_proj(128, d_model)])
        self.pos_embed = pos_embed

        self.transformer = TorchDeformableTransformer(
            d_model, nhead, enc_layers, dec_layers, dim_feedforward,
            num_feature_levels=num_feature_levels, two_stage=two_stage,
            two_stage_num_proposals=num_queries, depth_type=depth_type)
        if not two_stage:
            self.query_embed = tnn.Embedding(num_queries, d_model * 2)
        if num_feature_levels > 1:
            projs = [_proj(c, d_model) for c in (512, 1024, 2048)]
            for lvl in range(3, num_feature_levels):
                projs.append(_proj(2048 if lvl == 3 else d_model, d_model,
                                   3, 2))
            self.input_proj = tnn.ModuleList(projs)
        else:
            self.input_proj = tnn.ModuleList([_proj(2048, d_model)])

        class_embed = tnn.Linear(d_model, num_classes)
        bbox_embed = TorchMLP(d_model, d_model, 4, 3)
        prior = 0.01
        tnn.init.constant_(class_embed.bias,
                           -math.log((1 - prior) / prior))
        tnn.init.constant_(bbox_embed.layers[-1].weight, 0.0)
        tnn.init.constant_(bbox_embed.layers[-1].bias, 0.0)
        num_pred = dec_layers + 1 if two_stage else dec_layers
        if with_box_refine:
            self.class_embed = tnn.ModuleList(
                [copy.deepcopy(class_embed) for _ in range(num_pred)])
            self.bbox_embed = tnn.ModuleList(
                [copy.deepcopy(bbox_embed) for _ in range(num_pred)])
            with torch.no_grad():
                self.bbox_embed[0].layers[-1].bias[2:] = -2.0
            self.transformer.decoder.bbox_embed = self.bbox_embed
        else:
            with torch.no_grad():
                bbox_embed.layers[-1].bias[2:] = -2.0
            self.class_embed = tnn.ModuleList(
                [class_embed for _ in range(num_pred)])
            self.bbox_embed = tnn.ModuleList(
                [bbox_embed for _ in range(num_pred)])
            self.transformer.decoder.bbox_embed = None
        if two_stage:
            self.transformer.decoder.class_embed = self.class_embed
            with torch.no_grad():
                for be in self.bbox_embed:
                    be.layers[-1].bias[2:] = 0.0

    def randomize(self, gen=None):
        """Give the zero-/ring-initialized projections random weights so
        parity is non-trivial (the tests' standard trick)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, TorchMSDeformAttn):
                    m.sampling_offsets.weight.normal_(0, 0.02)
                    m.attention_weights.weight.normal_(0, 0.2)
                    m.attention_weights.bias.normal_(0, 0.2)
                if isinstance(m, TorchMLP):
                    m.layers[-1].weight.normal_(0, 0.02)
                if isinstance(m, tnn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.1)
                    m.running_var.uniform_(0.5, 1.5)

    def forward(self, tensors, mask):
        """tensors: (B, 3|4, H, W); mask: (B, H, W) True=pad."""
        if self.use_depth and "crossfusion" not in self.depth_type:
            rgb, depth = tensors[:, :3], tensors[:, 3:4]
        else:
            rgb, depth = tensors, None

        depth_srcs = depth_masks = depth_pos = None
        if "crossfusion" in self.depth_type:
            feats, masks, _, _ = self.backbone[0](rgb, mask)
        else:
            feats, masks = self.backbone[0](rgb[:, :3], mask)
            if self.use_depth:
                d_feats, d_masks = self.depth_backbone[0](depth, mask)
                depth_srcs = [self.input_proj_depth[0](d_feats[0])]
                depth_masks = d_masks
                depth_pos = [self.pos_embed(depth_srcs[0], d_masks[0])]

        if self.num_feature_levels > 1:
            srcs = [proj(f) for proj, f in zip(self.input_proj, feats)]
            lvl_masks = list(masks)
            for lvl in range(len(feats), self.num_feature_levels):
                srcs.append(self.input_proj[lvl](
                    feats[-1] if lvl == len(feats) else srcs[-1]))
                lvl_masks.append(interp_mask(mask, srcs[-1].shape[-2:]))
        else:
            srcs = [self.input_proj[0](feats[-1])]
            lvl_masks = [masks[-1]]
        pos = [self.pos_embed(s, m) for s, m in zip(srcs, lvl_masks)]

        query_embeds = None
        if not self.two_stage:
            query_embeds = self.query_embed.weight
        hs, init_ref, inter_refs, enc_cls, enc_coord_unact = \
            self.transformer(srcs, lvl_masks, pos, depth_srcs, depth_masks,
                             depth_pos, query_embeds)

        outputs_classes, outputs_coords = [], []
        for lvl in range(hs.shape[0]):
            reference = init_ref if lvl == 0 else inter_refs[lvl - 1]
            reference = inverse_sigmoid(reference)
            out_cls = self.class_embed[lvl](hs[lvl])
            tmp = self.bbox_embed[lvl](hs[lvl])
            if reference.shape[-1] == 4:
                tmp = tmp + reference
            else:
                tmp = torch.cat([tmp[..., :2] + reference, tmp[..., 2:]],
                                -1)
            outputs_classes.append(out_cls)
            outputs_coords.append(tmp.sigmoid())
        out = {"pred_logits": outputs_classes[-1],
               "pred_boxes": outputs_coords[-1],
               "aux_outputs": [
                   {"pred_logits": c, "pred_boxes": b} for c, b in
                   zip(outputs_classes[:-1], outputs_coords[:-1])]}
        if self.two_stage:
            out["enc_outputs"] = {"pred_logits": enc_cls,
                                  "pred_boxes": enc_coord_unact.sigmoid()}
        return out


# --------------------------------------------------------------------------
# Backbone Cross-Fusion — ``dformer_crossfusion_backbone.py:200-561`` with
# the channel-sizing fix (``dfvod_tpu/models/backbone_crossfusion.py:11-17``)
# --------------------------------------------------------------------------
class TorchCrossFusionBackbone(tnn.Module):
    STAGE_CH = {2: 512, 3: 1024, 4: 2048}   # true channels after layer N
    DEPTH_CH = {2: 32, 3: 64, 4: 128}       # dformer stem/stage1/stage2
    DEPTH_GN = {2: 4, 3: 8, 4: 16}

    def __init__(self, d_model=64, nhead=4, dim_feedforward=128,
                 dilation=True, pos_embed=None, bidirectional=False):
        super().__init__()
        self.body = TorchR50(dilate_l4=dilation)
        self.d_body = TorchDownsamplePath(1)
        self.position_embedding = pos_embed or TorchPositionEmbeddingSine(
            d_model // 2)
        self.bidirectional = bidirectional
        # the reference hard-codes n_head=8 / 4 points / 1 level for the
        # backbone fusion layers regardless of args.nheads
        # (``dformer_crossfusion_backbone.py:195-196`` defaults, never
        # overridden by ``build_dformer_fusion_backbone``)
        nhead = 8
        for layer in (2, 3, 4):
            rgb_ch, d_ch = self.STAGE_CH[layer], self.DEPTH_CH[layer]
            setattr(self, f"input_rgb_proj{layer}",
                    tnn.Sequential(tnn.Conv2d(rgb_ch, d_model, 1),
                                   tnn.GroupNorm(32, d_model)))
            setattr(self, f"output_rgb_proj{layer}",
                    tnn.Sequential(tnn.Conv2d(d_model, rgb_ch, 1),
                                   tnn.GroupNorm(32, rgb_ch)))
            setattr(self, f"input_d_proj{layer}",
                    tnn.Sequential(tnn.Conv2d(d_ch, d_model, 1),
                                   tnn.GroupNorm(self.DEPTH_GN[layer],
                                                 d_model)))
            setattr(self, f"output_d_proj{layer}",
                    tnn.Sequential(tnn.Conv2d(d_model, d_ch, 1),
                                   tnn.GroupNorm(self.DEPTH_GN[layer],
                                                 d_ch)))
            setattr(self, f"d2r_fusion{layer}",
                    TorchLateFusionLayer(d_model, nhead, 4, n_levels=1,
                                         activation="relu"))
            if bidirectional:
                setattr(self, f"r2d_fusion{layer}",
                        TorchLateFusionLayer(d_model, nhead, 4, n_levels=1,
                                             activation="relu"))

    def _fuse(self, src, target, pos_src, pos_target, mask_src,
              mask_target, fusion_layer):
        """``fuse_layers`` (``:388-428``): reference points are the SRC
        pixel grid scaled by the TARGET stream's valid ratios."""
        B = src.shape[0]
        src_flat = src.flatten(2).transpose(1, 2)
        target_flat = target.flatten(2).transpose(1, 2)
        pos_src_flat = pos_src.flatten(2).transpose(1, 2)
        shapes_src = [(src.shape[2], src.shape[3])]
        shapes_target = [(target.shape[2], target.shape[3])]
        vr_target = torch.stack([get_valid_ratio(mask_target)], 1)
        ref = get_reference_points(shapes_src, vr_target)
        fused = fusion_layer(src_flat, pos_src_flat, ref, target_flat,
                             shapes_target, mask_target.flatten(1))
        return fused.transpose(1, 2).view(src.shape)

    def forward(self, tensors, mask):
        rgb, depth = tensors[:, :3], tensors[:, 3:4]
        x = self.body.maxpool(self.body.relu(self.body.bn1(
            self.body.conv1(rgb))))
        x = self.body.layer1(x)
        x = self.body.layer2(x)
        x_d = self.d_body.downsample_layers_e[0](depth)
        for layer_no, (rgb_stage, d_stage) in zip(
                (2, 3, 4),
                ((None, None), (self.body.layer3,
                                self.d_body.downsample_layers_e[1]),
                 (self.body.layer4, self.d_body.downsample_layers_e[2]))):
            if rgb_stage is not None:
                x = rgb_stage(x)
                x_d = d_stage(x_d)
            m_rgb = interp_mask(mask, x.shape[-2:])
            m_d = interp_mask(mask, x_d.shape[-2:])
            src_rgb = getattr(self, f"input_rgb_proj{layer_no}")(x)
            src_d = getattr(self, f"input_d_proj{layer_no}")(x_d)
            pos_rgb = self.position_embedding(src_rgb, m_rgb)
            pos_d = self.position_embedding(src_d, m_d)
            fused = self._fuse(src_rgb, src_d, pos_rgb, pos_d, m_rgb, m_d,
                               getattr(self, f"d2r_fusion{layer_no}"))
            x = x + getattr(self, f"output_rgb_proj{layer_no}")(fused)
            if self.bidirectional:
                fused_d = self._fuse(src_d, src_rgb, pos_d, pos_rgb, m_d,
                                     m_rgb,
                                     getattr(self, f"r2d_fusion{layer_no}"))
                x_d = x_d + getattr(self,
                                    f"output_d_proj{layer_no}")(fused_d)
        m_final = interp_mask(mask, x.shape[-2:])
        return [x], [m_final], [x_d], [interp_mask(mask, x_d.shape[-2:])]


# --------------------------------------------------------------------------
# temporal modules — TransVOD++ (``deformable_transformer_multi_plusplus``)
# --------------------------------------------------------------------------
class TorchTQELayer(tnn.Module):
    """``TemporalQueryEncoderLayer``
    (``deformable_transformer_multi.py:560-610``)."""

    def __init__(self, d_model, d_ffn, n_heads):
        super().__init__()
        self.self_attn = tnn.MultiheadAttention(d_model, n_heads,
                                                dropout=0.0)
        self.norm2 = tnn.LayerNorm(d_model)
        self.cross_attn = tnn.MultiheadAttention(d_model, n_heads,
                                                 dropout=0.0)
        self.norm1 = tnn.LayerNorm(d_model)
        self.linear1 = tnn.Linear(d_model, d_ffn)
        self.linear2 = tnn.Linear(d_ffn, d_model)
        self.norm3 = tnn.LayerNorm(d_model)

    def forward(self, query, ref_query):
        q = k = query.transpose(0, 1)
        t2 = self.self_attn(q, k, query.transpose(0, 1))[0].transpose(0, 1)
        tgt = self.norm2(query + t2)
        t2 = self.cross_attn(tgt.transpose(0, 1),
                             ref_query.transpose(0, 1),
                             ref_query.transpose(0, 1))[0].transpose(0, 1)
        tgt = self.norm1(tgt + t2)
        t2 = self.linear2(F.relu(self.linear1(tgt)))
        return self.norm3(tgt + t2)


class TorchDynamicConv(tnn.Module):
    """``sparse_roi_head/head.py:127-172`` (dim_dynamic=64, 2 kernels)."""

    def __init__(self, d_model, dim_dynamic=64, pooler=7):
        super().__init__()
        self.d, self.dd = d_model, dim_dynamic
        self.num_params = d_model * dim_dynamic
        self.dynamic_layer = tnn.Linear(d_model, 2 * self.num_params)
        self.norm1 = tnn.LayerNorm(dim_dynamic)
        self.norm2 = tnn.LayerNorm(d_model)
        self.out_layer = tnn.Linear(d_model * pooler ** 2, d_model)
        self.norm3 = tnn.LayerNorm(d_model)

    def forward(self, pro, roi):
        # pro (1, NR, C); roi (P*P, NR, C)
        feats = roi.permute(1, 0, 2)
        params = self.dynamic_layer(pro).permute(1, 0, 2)
        p1 = params[:, :, :self.num_params].view(-1, self.d, self.dd)
        p2 = params[:, :, self.num_params:].view(-1, self.dd, self.d)
        feats = F.relu(self.norm1(torch.bmm(feats, p1)))
        feats = F.relu(self.norm2(torch.bmm(feats, p2)))
        feats = self.out_layer(feats.flatten(1))
        return F.relu(self.norm3(feats))


class TorchRCNNHead(tnn.Module):
    """``sparse_roi_head/head.py:31-83``; the reference constructs it with
    the TRANSFORMER's dim_feedforward/nhead
    (``deformable_transformer_multi_plusplus.py:155``)."""

    def __init__(self, d_model, dim_feedforward, n_heads, pooler=7):
        super().__init__()
        self.d_model = d_model
        self.self_attn = tnn.MultiheadAttention(d_model, n_heads,
                                                dropout=0.0)
        self.inst_interact = TorchDynamicConv(d_model, pooler=pooler)
        self.linear1 = tnn.Linear(d_model, dim_feedforward)
        self.linear2 = tnn.Linear(dim_feedforward, d_model)
        self.norm1 = tnn.LayerNorm(d_model)
        self.norm2 = tnn.LayerNorm(d_model)
        self.norm3 = tnn.LayerNorm(d_model)

    def forward(self, roi_features, pro_features):
        # roi_features (R, C, P, P); pro_features (N, R, C)
        N, R = pro_features.shape[:2]
        roi = roi_features.view(N * R, self.d_model, -1).permute(2, 0, 1)
        pro = pro_features.view(N, R, self.d_model).permute(1, 0, 2)
        pro2 = self.self_attn(pro, pro, value=pro)[0]
        pro = self.norm1(pro + pro2)
        pro = pro.view(R, N, self.d_model).permute(1, 0, 2).reshape(
            1, N * R, self.d_model)
        pro2 = self.inst_interact(pro, roi)
        obj = self.norm2(pro + pro2)
        obj2 = self.linear2(F.relu(self.linear1(obj)))
        return self.norm3(obj + obj2).view(N, R, self.d_model)


def torch_roi_align(feat, boxes, P=7, scale=1.0 / 32, sr=2):
    """mmcv ``RoIAlign(output_size=7, sampling_ratio=2, aligned=True)``
    semantics (re-typed spec of ``dfvod_tpu/ops/roi_align.py``).
    feat: (C, H, W); boxes: (R, 4) xyxy image coords -> (R, C, P, P)."""
    C, H, W = feat.shape
    b = boxes * scale - 0.5
    x1, y1, x2, y2 = b.unbind(-1)
    bin_w = (x2 - x1).clamp(min=1e-6)[:, None] / P
    bin_h = (y2 - y1).clamp(min=1e-6)[:, None] / P
    G = P * sr
    frac = (torch.arange(G, dtype=torch.float32) + 0.5) / sr
    xs = x1[:, None] + frac * bin_w
    ys = y1[:, None] + frac * bin_h
    yy = ys[:, :, None].expand(-1, -1, G)
    xx = xs[:, None, :].expand(-1, G, -1)
    oob = (yy < -1) | (yy > H) | (xx < -1) | (xx > W)
    ycl = yy.clamp(0, H - 1)
    xcl = xx.clamp(0, W - 1)
    y0 = ycl.floor()
    x0 = xcl.floor()
    fy, fx = ycl - y0, xcl - x0
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp(max=H - 1)
    x1i = (x0i + 1).clamp(max=W - 1)
    t = feat.reshape(C, -1)

    def g(yi, xi):
        return t[:, (yi * W + xi).reshape(-1)].reshape(C, *yi.shape)

    v = (g(y0i, x0i) * ((1 - fy) * (1 - fx)) + g(y0i, x1i) * ((1 - fy) * fx)
         + g(y1i, x0i) * (fy * (1 - fx)) + g(y1i, x1i) * (fy * fx))
    v = v.masked_fill(oob[None], 0.0)            # (C, R, G, G)
    v = v.reshape(C, -1, P, sr, P, sr).mean((3, 5))
    return v.permute(1, 0, 2, 3)


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h,
                        cx + 0.5 * w, cy + 0.5 * h], -1)


class TorchTransVODPP(TorchDeformableDETR):
    """TransVOD++ video model: single-frame pipeline over the (1+N)-frame
    clip batch + QRF + 3 TQE/temporal-decoder rounds
    (``deformable_transformer_multi_plusplus.py:260-604``,
    ``deformable_detr_multi_plusplus.py:210-341``).

    Documented deviation: the reference feeds the temporal decoders a
    ``valid_ratios[0:1].expand(1, N, 2)`` tensor whose extra N 'levels'
    make the CUDA kernel read interleaved sampling locations for N > 1
    (``:436,539``) — numerically ill-defined; both this replica and the
    flax model use the key frame's single-level valid ratio."""

    def __init__(self, num_ref_frames=2, **kw):
        super().__init__(**kw)
        self.num_ref_frames = num_ref_frames
        d = kw.get("d_model", 64)
        ffn = kw.get("dim_feedforward", 128)
        nhead = kw.get("nhead", 4)
        nc = kw.get("num_classes", 3)
        dec = TorchDecoderLayer(d, ffn, 1, nhead, 4)
        t = self.transformer
        t.temporal_query_layer1 = TorchTQELayer(d, ffn, nhead)
        t.temporal_query_layer2 = TorchTQELayer(d, ffn, nhead)
        t.temporal_query_layer3 = TorchTQELayer(d, ffn, nhead)
        t.temporal_decoder1 = TorchDecoder(dec, 1)
        t.temporal_decoder2 = TorchDecoder(dec, 1)
        t.temporal_decoder3 = TorchDecoder(dec, 1)
        t.dynamic_layer_for_current_query1 = TorchRCNNHead(d, ffn, nhead)
        self.temp_class_embed_list = tnn.ModuleList(
            [tnn.Linear(d, nc) for _ in range(3)])
        self.temp_bbox_embed_list = tnn.ModuleList(
            [TorchMLP(d, d, 4, 3) for _ in range(3)])
        with torch.no_grad():
            for mlp in self.temp_bbox_embed_list:
                mlp.layers[-1].weight.normal_(0, 0.02)

    def forward(self, tensors, mask):
        F_frames = self.num_ref_frames + 1
        BF, _, img_h, img_w = tensors.shape
        assert BF == F_frames, "replica assumes one clip (B=1)"
        if self.use_depth:
            rgb, depth = tensors[:, :3], tensors[:, 3:4]
        else:
            rgb, depth = tensors, None
        depth_srcs = depth_masks = depth_pos = None
        feats, masks = self.backbone[0](rgb[:, :3], mask)
        if self.use_depth:
            d_feats, d_masks = self.depth_backbone[0](depth, mask)
            depth_srcs = [self.input_proj_depth[0](d_feats[0])]
            depth_masks = d_masks
            depth_pos = [self.pos_embed(depth_srcs[0], d_masks[0])]
        srcs = [self.input_proj[0](feats[-1])]
        lvl_masks = [masks[-1]]
        pos = [self.pos_embed(srcs[0], lvl_masks[0])]

        t = self.transformer
        # -- single-frame trunk (frames ride the batch dim)
        hs, init_ref, inter_refs, _, _ = t(
            srcs, lvl_masks, pos, depth_srcs, depth_masks, depth_pos,
            self.query_embed.weight)
        # flatten bookkeeping recomputed for the temporal stage
        H1, W1 = srcs[0].shape[2], srcs[0].shape[3]
        shapes = [(H1, W1)]
        memory_like = None  # recompute memory exactly as t.forward did
        # NOTE: rerun of the encoder would double work; instead expose it:
        memory, pos_flat, mask_flat, valid_ratios = t._last_extras

        N = self.num_ref_frames
        cur_memory = memory[0:1]
        ref_memory_list = list(torch.chunk(memory, F_frames, 0))[1:]
        ref_pos_list = list(torch.chunk(pos_flat, F_frames, 0))[1:]
        ref_memory_pos = [m + p for m, p in zip(ref_memory_list,
                                                ref_pos_list)]
        last_hs = hs[-1]
        hs_list = list(torch.chunk(last_hs, F_frames, 0))
        cur_hs, ref_hs_list = hs_list[0], hs_list[1:]
        last_ref = inter_refs[-1]
        ref_list = list(torch.chunk(last_ref, F_frames, 0))
        cur_reference_out, ref_ref_list = ref_list[0], ref_list[1:]

        class_embed = self.class_embed[-1]
        bbox_embed = self.bbox_embed[-1]
        ref_logits = torch.cat([class_embed(r) for r in ref_hs_list], 1)
        ref_prob = ref_logits.sigmoid()

        whwh = torch.tensor([img_w, img_h, img_w, img_h],
                            dtype=torch.float32)

        def qrf(hs_frame, ref_out, mem_tokens):
            bb = bbox_embed(hs_frame) + inverse_sigmoid(ref_out)
            boxes = box_cxcywh_to_xyxy(bb.sigmoid()) * whwh
            feat = mem_tokens.permute(0, 2, 1).view(
                1, t.d_model, H1, W1)[0]
            rois = torch_roi_align(feat, boxes[0])
            return t.dynamic_layer_for_current_query1(
                rois, hs_frame)

        cur_hs = qrf(cur_hs, cur_reference_out, cur_memory)
        ref_hs_concat = torch.cat(
            [qrf(r, rr, m) for r, rr, m in
             zip(ref_hs_list, ref_ref_list, ref_memory_pos)], 1)

        vr_cur = valid_ratios[0:1, :1]       # key frame, single level
        out = {"aux_outputs": []}
        final_hs = final_ref = None
        for i, k_mult in enumerate((80, 50, 30)):
            k = min(k_mult * N, ref_prob.shape[1])
            _, idx = torch.topk(ref_prob[:, :, 1], k, dim=1)
            sel = torch.gather(
                ref_hs_concat, 1,
                idx.unsqueeze(-1).repeat(1, 1, ref_hs_concat.shape[-1]))
            tqe = getattr(t, f"temporal_query_layer{i + 1}")
            dec = getattr(t, f"temporal_decoder{i + 1}")
            cur_hs = tqe(cur_hs, sel)
            cur_hs, round_ref = dec(cur_hs, cur_reference_out, cur_memory,
                                    shapes, vr_cur, None, None)
            cur_hs = cur_hs[-1]        # TorchDecoder stacks intermediates
            round_ref = round_ref[-1]
            ref_u = inverse_sigmoid(round_ref)
            logits = self.temp_class_embed_list[i](cur_hs)
            tmp = self.temp_bbox_embed_list[i](cur_hs)
            if ref_u.shape[-1] == 4:
                tmp = tmp + ref_u
            else:
                tmp = torch.cat([tmp[..., :2] + ref_u, tmp[..., 2:]], -1)
            coord = tmp.sigmoid()
            if i < 2:
                out["aux_outputs"].append(
                    {"pred_logits": logits, "pred_boxes": coord})
            else:
                out["pred_logits"] = logits
                out["pred_boxes"] = coord
        return out
