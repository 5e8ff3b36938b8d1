"""Temporal heads: TransVOD and TransVOD++ video detection on top of the
single-frame trunk (counterpart of ``dfvod_tpu/models/temporal.py``).

Frames ride the leading axis: ``(B*F, H, W, C)`` with clips contiguous,
``F = 1 + num_ref_frames``, frame order per clip ``[key, ref_1, ...,
ref_N]``. Every temporal op is batched over the B clips.

Reference quirks kept, as in the JAX package:
- the QRF RoIAlign uses ``spatial_scale=1/32`` even for the stride-16 DC5
  memory;
- rounds 2 and 3 of TransVOD++ decode from the spatial ``cur_ref``, not
  the previous round's output;
- TransVOD takes the top-k over ``prob[..., :K-1]`` flattened over (query,
  class), then ``// (K-1)``, duplicates kept; TransVOD++ over channel 1;
  ``k = min(k_mult * N, N * Q)``;
- the temporal decoder gets no padding mask, ``valid_ratios[:, :1]`` and
  ``query_pos=None``.

Clip-parallel serving and training (the JAX package's
``clip_batch_sharding``): with ``trunk_group`` set to a process group of
more than one rank, each rank runs the trunk on its contiguous rows of the
``B*F`` frames (a clip may straddle two ranks), the trunk outputs the
temporal heads read are gathered over the group in rank order, and every
rank runs the temporal heads on all of them, so that every rank returns
the same key-frame outputs. A forward that records a gradient gathers
through ``parallel.gather_rows``, whose backward sums the heads' gradients
over the group before each rank takes its rows back
(``train/engine.py::create_train_state(clip=...)``).

Submodules carry the flax module names (``detr``,
``temporal_query_layer{1,2,3}``, ``temporal_encoder_layer``,
``temporal_decoder``, ``temporal_decoder{1,2,3}``, ``temp_head``,
``temp_head_{0,1,2}``, ``qrf_dynamic_layer1``) so that
``utils/convert.py`` carries the weights mechanically.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from dfvod_tpu_torch.models.detr import DeformableDETR
from dfvod_tpu_torch.models.layers import (
    FFN,
    Dropout,
    MSDeformAttn,
    MultiHeadAttention,
    with_pos,
)
from dfvod_tpu_torch.models.transformer import (
    DeformableTransformerDecoderLayer,
    DetectionHead,
)
from dfvod_tpu_torch.ops.roi_align import roi_align
from dfvod_tpu_torch.parallel.dist import (
    all_gather_rows,
    gather_rows,
    rank,
    shard_rows,
    world,
)
from dfvod_tpu_torch.utils.box_ops import box_cxcywh_to_xyxy, inverse_sigmoid
from dfvod_tpu_torch.utils.config import ModelConfig, check_supported
from dfvod_tpu_torch.utils.trace import span


# the trunk outputs the temporal heads read, gathered under clip-parallel
# serving (``spatial_shapes`` is the same on every rank)
TRUNK_GATHERED = ("memory", "pos_flat", "hs_last", "last_reference",
                  "last_deltas", "valid_ratios")


class TemporalQueryEncoderLayer(nn.Module):
    """MHA self-attention, then cross-attention onto the selected reference
    queries, then FFN."""

    def __init__(self, d_model=256, d_ffn=1024, dropout=0.1, n_heads=8):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.dropout2 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn, "relu", dropout)

    def forward(self, query, ref_query, query_pos=None, ref_query_pos=None):
        q = with_pos(query, query_pos)
        tgt = self.norm2(query + self.dropout2(self.self_attn(q, q, query)))
        tgt2 = self.cross_attn(with_pos(tgt, query_pos),
                               with_pos(ref_query, ref_query_pos), ref_query)
        tgt = self.norm1(tgt + self.dropout1(tgt2))
        return self.ffn(tgt)


class TDAMLayer(nn.Module):
    """Temporal deformable memory aggregation: the key frame's tokens
    self-attend, then deformably cross-attend into the N reference frames'
    memories taken as N levels."""

    def __init__(self, d_model=256, d_ffn=1024, dropout=0.1,
                 num_ref_frames=3, n_heads=8, n_points=4):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.dropout2 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, num_ref_frames, n_heads,
                                       n_points)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ffn = FFN(d_model, d_ffn, "relu", dropout)

    def forward(self, tgt, query_pos, reference_points, src,
                src_spatial_shapes, src_padding_mask=None):
        q = with_pos(tgt, query_pos)
        tgt = self.norm2(tgt + self.dropout2(self.self_attn(q, q, tgt)))
        tgt2 = self.cross_attn(with_pos(tgt, query_pos), reference_points,
                               src, src_spatial_shapes, src_padding_mask)
        tgt = self.norm1(tgt + self.dropout1(tgt2))
        return self.ffn(tgt)


class DynamicConv(nn.Module):
    """SparseRCNN dynamic instance interaction: per-query generated
    (C -> 64) and (64 -> C) kernels applied to the query's P*P RoI tokens,
    then a flatten + linear to one vector per query."""

    def __init__(self, hidden_dim=256, dim_dynamic=64, num_dynamic=2,
                 pooler_resolution=7):
        super().__init__()
        self.hidden_dim, self.dim_dynamic = hidden_dim, dim_dynamic
        self.dynamic_layer = nn.Linear(hidden_dim,
                                       num_dynamic * hidden_dim * dim_dynamic)
        self.norm1 = nn.LayerNorm(dim_dynamic, eps=1e-5)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.out_layer = nn.Linear(hidden_dim * pooler_resolution ** 2,
                                   hidden_dim)
        self.norm3 = nn.LayerNorm(hidden_dim, eps=1e-5)

    def forward(self, pro_features, roi_features):
        """pro_features: (B, R, C); roi_features: (B, R, P*P, C)."""
        B, R = pro_features.shape[:2]
        C, Dd = self.hidden_dim, self.dim_dynamic
        params = self.dynamic_layer(pro_features)
        p1 = params[..., :C * Dd].reshape(B, R, C, Dd)
        p2 = params[..., C * Dd:].reshape(B, R, Dd, C)
        feats = torch.relu(self.norm1(torch.matmul(roi_features, p1)))
        feats = torch.relu(self.norm2(torch.matmul(feats, p2)))
        feats = self.out_layer(feats.reshape(B, R, -1))
        return torch.relu(self.norm3(feats))


class RCNNHead(nn.Module):
    """QRF head: query self-attention -> DynamicConv with the RoI features
    -> FFN."""

    def __init__(self, d_model=256, dim_feedforward=2048, n_heads=8,
                 dropout=0.0, pooler_resolution=7):
        super().__init__()
        self.d_model = d_model
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.dropout1 = Dropout(dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.inst_interact = DynamicConv(
            d_model, pooler_resolution=pooler_resolution)
        self.dropout2 = Dropout(dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.dropout3 = Dropout(dropout)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.dropout4 = Dropout(dropout)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, roi_features, pro_features):
        """roi_features: (B, R, P, P, C); pro_features: (B, R, C)."""
        B, R = pro_features.shape[:2]
        roi = roi_features.reshape(B, R, -1, self.d_model)
        pro = self.norm1(pro_features + self.dropout1(
            self.self_attn(pro_features, pro_features, pro_features)))
        pro = pro + self.dropout2(self.inst_interact(pro, roi))
        obj = self.norm2(pro)
        obj2 = self.linear2(self.dropout3(torch.relu(self.linear1(obj))))
        return self.norm3(obj + self.dropout4(obj2))


class TemporalDecoder(nn.Module):
    """n-layer deformable decoder over the key frame's memory, without box
    refinement."""

    def __init__(self, d_model=256, d_ffn=1024, dropout=0.1, num_layers=1,
                 n_heads=8, n_points=4):
        super().__init__()
        self.num_layers = num_layers
        for lid in range(num_layers):
            self.add_module(f"layers_{lid}", DeformableTransformerDecoderLayer(
                d_model, d_ffn, "relu", 1, n_heads, n_points, dropout))

    def forward(self, tgt, reference_points, src, spatial_shapes,
                valid_ratios, query_pos=None, src_padding_mask=None):
        output = tgt
        for lid in range(self.num_layers):
            if reference_points.shape[-1] == 4:
                ref_input = (reference_points[:, :, None]
                             * torch.cat([valid_ratios, valid_ratios],
                                         -1)[:, None])
            else:
                ref_input = reference_points[:, :, None] * valid_ratios[:,
                                                                        None]
            output = getattr(self, f"layers_{lid}")(
                output, query_pos, ref_input, src, spatial_shapes,
                src_padding_mask)
        return output, reference_points


def _topk_queries(ref_hs, scores, k: int):
    """The k highest-scoring reference queries. ref_hs: (B, NQ, C); scores:
    (B, NQ). Returns (B, k, C)."""
    idx = torch.topk(scores, k, dim=1).indices
    return torch.gather(ref_hs, 1,
                        idx[..., None].expand(-1, -1, ref_hs.shape[-1]))


class TemporalDeformableDETR(nn.Module):
    """TransVOD / TransVOD++: the single-frame trunk over all frames, then
    temporal aggregation into key-frame outputs.

    Input: images ``(B*F, H, W, C)`` with clips contiguous, mask
    ``(B*F, H, W)``. Output dict of key-frame predictions ``(B, Q, ...)``
    with ``_single_frame``, the trunk's key-frame outputs, and for
    TransVOD++ ``aux_outputs`` of rounds 1 and 2.
    """

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        d, ffn = cfg.hidden_dim, cfg.dim_feedforward
        self.detr = DeformableDETR(cfg)
        for i in (1, 2, 3):
            self.add_module(f"temporal_query_layer{i}",
                            TemporalQueryEncoderLayer(d, ffn, cfg.dropout,
                                                      cfg.nheads))
        if cfg.temporal_mode == "transvod":
            if cfg.use_tdam:
                self.temporal_encoder_layer = TDAMLayer(
                    d, ffn, cfg.dropout, cfg.num_ref_frames, cfg.nheads)
            self.temporal_decoder = TemporalDecoder(
                d, ffn, cfg.dropout, cfg.n_temporal_decoder_layers,
                cfg.nheads, cfg.dec_n_points)
            self.temp_head = DetectionHead(d, cfg.num_classes)
        else:  # transvod_pp
            # the QRF head takes the transformer's ffn width, heads and
            # dropout, not SparseRCNN's defaults, as the reference builds it
            self.qrf_dynamic_layer1 = RCNNHead(d, ffn, cfg.nheads,
                                               cfg.dropout)
            for i in (1, 2, 3):
                self.add_module(f"temporal_decoder{i}", TemporalDecoder(
                    d, ffn, cfg.dropout, cfg.n_temporal_decoder_layers,
                    cfg.nheads, cfg.dec_n_points))
            for i in (0, 1, 2):
                self.add_module(f"temp_head_{i}",
                                DetectionHead(d, cfg.num_classes))

    trunk_group = None

    def _trunk_outputs(self, images, mask):
        """The trunk on every frame; with ``trunk_group`` of more than one
        rank, on this rank's rows, the outputs the heads read gathered."""
        group = self.trunk_group
        n = world(group) if group is not None else 1
        if n == 1:
            return self.detr(images, mask)
        # training gathers with a gradient (summed over the group in the
        # backward); serving without
        gather = gather_rows if torch.is_grad_enabled() else all_gather_rows
        r = rank(group)
        out = self.detr(shard_rows(images, r, n), shard_rows(mask, r, n))
        trunk = {k: gather(out["_trunk"][k], group) for k in TRUNK_GATHERED}
        trunk["spatial_shapes"] = out["_trunk"]["spatial_shapes"]
        res = {k: gather(out[k], group)
               for k in ("pred_logits", "pred_boxes")}
        if "enc_outputs" in out:
            res["enc_outputs"] = {k: gather(v, group)
                                  for k, v in out["enc_outputs"].items()}
        return {**res, "_trunk": trunk}

    def forward(self, images, mask):
        cfg = self.cfg
        F = 1 + cfg.num_ref_frames
        BF = images.shape[0]
        if BF % F:
            raise ValueError(f"{BF} frames are not whole clips of {F}")
        B = BF // F

        out_sf = self._trunk_outputs(images, mask)
        # the span of the temporal head (``utils/trace.py``): from the
        # trunk's outputs to the heads'
        with span("temporal"):
            trunk = out_sf["_trunk"]
            if cfg.fixed_pretrained_model:
                trunk = {k: v if k == "spatial_shapes" else v.detach()
                         for k, v in trunk.items()}
                out_sf = {**out_sf,
                          "pred_logits": out_sf["pred_logits"].detach(),
                          "pred_boxes": out_sf["pred_boxes"].detach()}

            def split(x):
                """(B*F, ...) -> key (B, ...), refs (B, N, ...)."""
                x = x.reshape(B, F, *x.shape[1:])
                return x[:, 0], x[:, 1:]

            memory, pos_flat = trunk["memory"], trunk["pos_flat"]
            hs = trunk["hs_last"]
            N, Q, S = cfg.num_ref_frames, hs.shape[1], memory.shape[1]
            cur_memory, ref_memory = split(memory)
            cur_pos, ref_pos = split(pos_flat)
            ref_memory = (ref_memory + ref_pos).reshape(B, N * S, -1)
            cur_hs, ref_hs = split(hs)
            ref_hs = ref_hs.reshape(B, N * Q, -1)
            cur_ref = split(trunk["last_reference"])[0]
            valid_ratios = split(trunk["valid_ratios"])[0]        # (B, L, 2)
            # per-frame logits of the trunk's last head
            ref_logits = split(out_sf["pred_logits"])[1].reshape(B, N * Q, -1)
            ref_prob = torch.sigmoid(ref_logits)

            if cfg.temporal_mode == "transvod":
                out = self._transvod(cur_memory, cur_pos, ref_memory, cur_hs,
                                     ref_hs, ref_prob, cur_ref,
                                     trunk["spatial_shapes"], valid_ratios)
            else:
                out = self._transvod_pp(trunk, cur_memory, cur_hs, ref_prob,
                                        cur_ref, valid_ratios, mask, B)
            out["_single_frame"] = _key_frame_outputs(out_sf, B, F)
            return out

    def _transvod(self, cur_memory, cur_pos, ref_memory, cur_hs, ref_hs,
                  ref_prob, cur_ref, spatial_shapes, valid_ratios):
        cfg = self.cfg
        N, B, K = cfg.num_ref_frames, ref_prob.shape[0], ref_prob.shape[-1]
        if cfg.use_tdam:
            ref_shapes = tuple(spatial_shapes[:1]) * N
            vr = valid_ratios[:, :1].expand(B, N, 2)
            ref_points = _grid_reference_points(spatial_shapes, vr)
            # the key frame's pos embedding rides the TDAM queries
            cur_memory = self.temporal_encoder_layer(
                cur_memory, cur_pos, ref_points, ref_memory, ref_shapes)

        # top-k over (query, class < K-1) pairs, index // (K-1) -> query
        flat = ref_prob[..., :K - 1].reshape(B, -1)
        for i, k_mult in ((1, 80), (2, 50), (3, 30)):
            idx = torch.topk(flat, min(k_mult * N, flat.shape[1]),
                             dim=1).indices
            qidx = idx // (K - 1)
            sel = torch.gather(ref_hs, 1,
                               qidx[..., None].expand(-1, -1,
                                                      ref_hs.shape[-1]))
            cur_hs = getattr(self, f"temporal_query_layer{i}")(cur_hs, sel)

        final_hs, final_ref = self.temporal_decoder(
            cur_hs, cur_ref, cur_memory, spatial_shapes[:1],
            valid_ratios[:, :1])
        logits, deltas = self.temp_head(final_hs)
        return {"pred_logits": logits,
                "pred_boxes": _apply_box_head(deltas, final_ref)}

    def _transvod_pp(self, trunk, cur_memory, cur_hs, ref_prob, cur_ref,
                     valid_ratios, mask, B):
        cfg = self.cfg
        N = cfg.num_ref_frames
        F = 1 + N
        Q, d = cur_hs.shape[1], cfg.hidden_dim
        spatial_shapes = trunk["spatial_shapes"]
        # the full-resolution size comes from the padding mask, never from
        # the image tensor
        img_h, img_w = mask.shape[1], mask.shape[2]
        whwh = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32,
                            device=mask.device)

        # QRF: boxes from the last layer's deltas and reference (in the
        # model dtype), scaled to pixels in f32; RoIAlign over every
        # frame's memory; DynamicConv fuses them into the queries
        hs_all = trunk["hs_last"]                              # (BF, Q, C)
        boxes = torch.sigmoid(trunk["last_deltas"]
                              + inverse_sigmoid(trunk["last_reference"]))
        boxes_xyxy = box_cxcywh_to_xyxy(boxes) * whwh          # f32

        H1, W1 = (int(s) for s in spatial_shapes[0])
        mem_maps = trunk["memory"][:, :H1 * W1].reshape(-1, H1, W1, d)
        pos_maps = trunk["pos_flat"][:, :H1 * W1].reshape(-1, H1, W1, d)
        # reference frames carry their positional embedding
        frame_is_ref = (torch.arange(B * F, device=mask.device) % F) != 0
        mem_maps = torch.where(frame_is_ref[:, None, None, None],
                               mem_maps + pos_maps, mem_maps)
        rois = roi_align(mem_maps, boxes_xyxy, output_size=7,
                         spatial_scale=1 / 32, sampling_ratio=2)
        hs_enh = self.qrf_dynamic_layer1(rois, hs_all).reshape(B, F, Q, d)
        cur_hs = hs_enh[:, 0]
        ref_hs = hs_enh[:, 1:].reshape(B, N * Q, d)

        # three rounds of (channel-1 top-k -> TQE -> temporal decoder ->
        # head); the decoder's reference stays the spatial cur_ref
        hand_prob = ref_prob[..., 1]                           # (B, N*Q)
        outs = []
        for i, k_mult in enumerate((80, 50, 30)):
            sel = _topk_queries(ref_hs, hand_prob,
                                min(k_mult * N, hand_prob.shape[1]))
            cur_hs = getattr(self, f"temporal_query_layer{i + 1}")(cur_hs,
                                                                   sel)
            cur_hs, round_ref = getattr(self, f"temporal_decoder{i + 1}")(
                cur_hs, cur_ref, cur_memory, spatial_shapes[:1],
                valid_ratios[:, :1])
            logits, deltas = getattr(self, f"temp_head_{i}")(cur_hs)
            outs.append({"pred_logits": logits,
                         "pred_boxes": _apply_box_head(deltas, round_ref)})
        return {**outs[2], "aux_outputs": outs[:2]}


def _apply_box_head(deltas, reference):
    """``tmp += inverse_sigmoid(reference); sigmoid``."""
    ref = inverse_sigmoid(reference)
    if ref.shape[-1] == 4:
        return torch.sigmoid(deltas + ref)
    xy = deltas[..., :2] + ref
    return torch.sigmoid(torch.cat([xy, deltas[..., 2:]], -1))


def _key_frame_outputs(out_sf, B, F):
    def take(x):
        return x.reshape(B, F, *x.shape[1:])[:, 0]
    out = {"pred_logits": take(out_sf["pred_logits"]),
           "pred_boxes": take(out_sf["pred_boxes"])}
    if "enc_outputs" in out_sf:
        # two-stage: the key frame's encoder proposals
        out["enc_outputs"] = {k: take(v)
                              for k, v in out_sf["enc_outputs"].items()}
    return out


def _grid_reference_points(spatial_shapes, valid_ratios):
    """Reference points of the key frame's single level, broadcast over the
    N reference-frame 'levels'. valid_ratios: (B, N, 2). Returns
    (B, H*W, N, 2)."""
    H, W = int(spatial_shapes[0][0]), int(spatial_shapes[0][1])
    ys = np.arange(H, dtype=np.float32) + 0.5
    xs = np.arange(W, dtype=np.float32) + 0.5
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    ref = torch.from_numpy(np.stack([xx.reshape(-1), yy.reshape(-1)], -1)
                           ).to(valid_ratios.device)
    ref = ref / torch.tensor([W, H], dtype=torch.float32,
                             device=valid_ratios.device)
    ref = ref[None, :, None, :] / valid_ratios[:, None]
    return ref * valid_ratios[:, None]
