"""The DETR segmentation branch on the detection trunk (counterpart of
``dfvod_tpu/models/segmentation.py``): ``MHAttentionMap`` (each query's
attention map over the level-0 memory), ``MaskHeadSmallConv`` (3x3 conv +
GroupNorm stages upsampled through the ResNet stage outputs 3, 2 and 1),
``MaskBranch``, ``dice_loss``, ``postprocess_segm`` and
``postprocess_panoptic``.

Submodules carry the flax module names (``bbox_attention`` with
``q_linear`` / ``k_linear``, ``mask_head`` with ``lay{i}_conv`` /
``lay{i}_gn``, ``adapter{i}``, ``out_lay``) so that ``utils/convert.py``
fills the branch mechanically. Feature maps come in channels-last, as the
trunk gives them, and run NCHW inside.

Two steps are computed in another order than the JAX package's, with the
same result: the JAX branch broadcasts the memory map and each ResNet
lateral to the B·Q query rows before ``lay1_conv`` and the 1x1 adapters;
here a convolution, being linear, runs on the B images' maps and its
result is broadcast (at 608x800 with DC5 the broadcast layer4 / layer2
laterals alone are 4.7 GB per image in f32).

Resizes follow ``jax.image.resize``: ``nearest`` takes input index
``floor((i + 0.5) * in / out)`` (half-pixel centres, torch's
``nearest-exact``, not ``nearest``), and ``bilinear`` is its
scale-and-translate with the triangle kernel, widened when downsampling
(antialiased), computed here as one weight matrix per axis.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the ResNet-50 stage outputs the mask head reads, high to low stride
LATERAL_STAGES = (3, 2, 1)
LATERAL_CHANNELS = (1024, 512, 256)
GN_EPS = 1e-6                       # flax GroupNorm's epsilon


def _gn_groups(channels: int, target: int = 8) -> int:
    """The largest group count at most ``target`` that divides
    ``channels`` (the reference's flat 8 divides its 256-based widths)."""
    return next(g for g in range(min(target, channels), 0, -1)
                if channels % g == 0)


def dice_loss(inputs, targets, num_boxes):
    """``segmentation.py:178-193`` of the reference: sigmoid, each mask's
    dice, summed over masks / num_boxes. inputs, targets: (N, H*W)."""
    prob = torch.sigmoid(inputs)
    numerator = 2 * (prob * targets).sum(-1)
    denominator = prob.sum(-1) + targets.sum(-1)
    return (1 - (numerator + 1) / (denominator + 1)).sum() / num_boxes


def resize_nearest(x, size: Tuple[int, int]):
    """``jax.image.resize(..., "nearest")`` of the last two axes: output
    index i reads input index ``floor((i + 0.5) * in / out)``, computed in
    f32 as JAX computes it."""
    idx = []
    for n_in, n_out in zip(x.shape[-2:], size):
        i = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in
             / n_out).floor().long().clamp(max=n_in - 1)
        idx.append(i.to(x.device))
    return x[..., idx[0][:, None], idx[1][None, :]]


def _bilinear_weights(n_in: int, n_out: int, device):
    """(n_in, n_out) weights of ``jax.image.resize(..., "bilinear")``
    along one axis (``compute_weight_mat`` with the triangle kernel and
    antialiasing), in f32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale \
        - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = (1.0 - x).clamp(min=0.0)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None], w, torch.zeros_like(w)).to(device)


def resize_bilinear(x, size: Tuple[int, int]):
    """``jax.image.resize(..., "bilinear")`` of the last two axes, in f32.
    An axis whose size does not change is left alone, as JAX leaves it."""
    x = x.float()
    H, W = x.shape[-2:]
    if W != size[1]:
        x = x @ _bilinear_weights(W, size[1], x.device)
    if H != size[0]:
        x = (x.transpose(-1, -2) @ _bilinear_weights(H, size[0], x.device)
             ).transpose(-1, -2)
    return x


class MHAttentionMap(nn.Module):
    """Each (query, head)'s softmax attention over the map, without a value
    projection (``segmentation.py:146-175`` of the reference)."""

    def __init__(self, hidden_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_linear = nn.Linear(hidden_dim, hidden_dim)
        self.k_linear = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, q, k, mask=None):
        """q (B, Q, C); k (B, H, W, C); mask (B, H, W), True = pad.
        Returns (B, Q, M, H, W)."""
        B, Q, C = q.shape
        _, H, W, _ = k.shape
        M = self.num_heads
        d = C // M
        qh = self.q_linear(q).reshape(B, Q, M, d)
        kh = self.k_linear(k).reshape(B, H, W, M, d)
        logits = torch.einsum("bqmd,bhwmd->bqmhw", qh, kh) / (d ** 0.5)
        if mask is not None:
            logits = logits.masked_fill(mask[:, None, None], -1e9)
        w = torch.softmax(logits.reshape(B, Q, M, H * W), dim=-1)
        return w.reshape(B, Q, M, H, W)


class MaskHeadSmallConv(nn.Module):
    """``segmentation.py:72-144`` of the reference: 3x3 conv + GroupNorm
    stages; each further stage adds a 1x1-adapted lateral after a nearest
    upsampling to the lateral's size."""

    def __init__(self, dim: int, context_dim: int,
                 fpn_dims: Sequence[int] = LATERAL_CHANNELS):
        super().__init__()
        inter = [dim, context_dim // 2, context_dim // 4, context_dim // 8,
                 context_dim // 16]
        self.context_dim = context_dim
        cin = dim
        for i, ch in enumerate(inter[:2], start=1):
            self.add_module(f"lay{i}_conv", nn.Conv2d(cin, ch, 3, padding=1))
            self.add_module(f"lay{i}_gn", nn.GroupNorm(_gn_groups(ch), ch,
                                                       eps=GN_EPS))
            cin = ch
        for i, (fpn, ch) in enumerate(zip(fpn_dims, inter[2:])):
            self.add_module(f"adapter{i + 1}", nn.Conv2d(fpn, ch, 1))
            self.add_module(f"lay{i + 3}_conv",
                            nn.Conv2d(cin, ch, 3, padding=1))
            self.add_module(f"lay{i + 3}_gn",
                            nn.GroupNorm(_gn_groups(ch), ch, eps=GN_EPS))
            cin = ch
        self.out_lay = nn.Conv2d(cin, 1, 3, padding=1)

    def forward(self, context, att, laterals: List[torch.Tensor]):
        """context (B, C, H, W): the memory map, shared by an image's
        queries; att (B, Q, M, H, W): the attention maps; laterals (B, Ci,
        Hi, Wi), high to low stride. Returns (B*Q, 1, H', W') for the
        channels ``[context, att]`` of each query."""
        B, Q, M, H, W = att.shape
        C = self.context_dim
        # lay1_conv over the concatenation, as the context's share on the
        # B maps broadcast to the queries plus the attention maps' share
        w, b = self.lay1_conv.weight, self.lay1_conv.bias
        ctx = F.conv2d(context, w[:, :C], None, padding=1)
        x = F.conv2d(att.reshape(B * Q, M, H, W), w[:, C:], b, padding=1)
        x = (x.reshape(B, Q, *x.shape[1:]) + ctx[:, None]).flatten(0, 1)
        x = F.relu(self.lay1_gn(x))
        x = F.relu(self.lay2_gn(self.lay2_conv(x)))
        for i, lat in enumerate(laterals):
            lat = getattr(self, f"adapter{i + 1}")(lat)
            x = getattr(self, f"lay{i + 3}_conv")(x)
            x = resize_nearest(x, tuple(lat.shape[-2:]))
            x = (x.reshape(B, Q, *x.shape[1:]) + lat[:, None]).flatten(0, 1)
            x = F.relu(getattr(self, f"lay{i + 3}_gn")(x))
        return self.out_lay(x)


class MaskBranch(nn.Module):
    """DETRsegm's mask branch on this trunk: per-query attention maps over
    the level-0 memory map, with the map as context, upsampled through the
    ResNet laterals. Returns (B, Q, Hm, Wm) mask logits at layer1's
    stride."""

    def __init__(self, hidden_dim: int = 256, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.bbox_attention = MHAttentionMap(hidden_dim, num_heads)
        self.mask_head = MaskHeadSmallConv(hidden_dim + num_heads,
                                           hidden_dim)

    def forward(self, queries, memory_map, mask, laterals):
        """queries (B, Q, C); memory_map (B, H, W, C); mask (B, H, W);
        laterals (B, Hi, Wi, Ci) channels-last, high to low stride."""
        B, Q, _ = queries.shape
        att = self.bbox_attention(queries, memory_map, mask)
        seg = self.mask_head(memory_map.permute(0, 3, 1, 2), att,
                             [lat.permute(0, 3, 1, 2) for lat in laterals])
        return seg.reshape(B, Q, *seg.shape[-2:])


def postprocess_segm(mask_logits, target_sizes, threshold: float = 0.5):
    """``PostProcessSegm`` (``segmentation.py:259-280`` of the reference)
    as the JAX package computes it: the mask logits resized bilinearly to
    the first target size (a batch shares one padded size), then
    ``sigmoid > threshold``. Returns (B, Q, H, W) bool."""
    H, W = int(target_sizes[0][0]), int(target_sizes[0][1])
    return torch.sigmoid(resize_bilinear(mask_logits, (H, W))) > threshold


def postprocess_panoptic(pred_logits, mask_logits,
                         is_thing_map: Dict[int, bool],
                         threshold: float = 0.85):
    """The panoptic merge of the JAX package (``PostProcessPanoptic``,
    ``segmentation.py:282+`` of the reference) on the host: the queries
    whose softmax top class is not the last ("no object") and scores above
    ``threshold``; a stuff class's masks summed into one segment; each
    pixel to the segment of the largest mask logit; segments of 4 pixels
    or fewer dropped. Returns per image (segment id map (H, W) int32,
    [{id, category_id, isthing, score, area}])."""
    logits = np.asarray(torch.as_tensor(pred_logits).float().cpu())
    masks = np.asarray(torch.as_tensor(mask_logits).float().cpu())
    B, Q, K = logits.shape
    results = []
    for b in range(B):
        e = np.exp(logits[b] - logits[b].max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        scores, labels = probs.max(-1), probs.argmax(-1)
        keep = (labels != K - 1) & (scores > threshold)
        scores, labels = scores[keep], labels[keep]
        m = masks[b][keep]
        if len(m) == 0:
            results.append((np.zeros(masks.shape[-2:], np.int32), []))
            continue
        merged, seg_labels, seg_scores, stuff_slot = [], [], [], {}
        for k in range(len(m)):
            lab = int(labels[k])
            if not is_thing_map.get(lab, True) and lab in stuff_slot:
                merged[stuff_slot[lab]] = merged[stuff_slot[lab]] + m[k]
                continue
            if not is_thing_map.get(lab, True):
                stuff_slot[lab] = len(merged)
            merged.append(m[k])
            seg_labels.append(lab)
            seg_scores.append(float(scores[k]))
        assign = np.stack(merged).argmax(0)
        seg_map = np.zeros(assign.shape, np.int32)
        infos = []
        for k in range(len(merged)):
            area = int((assign == k).sum())
            if area <= 4:
                continue
            seg_map[assign == k] = len(infos) + 1
            infos.append({"id": len(infos) + 1, "category_id": seg_labels[k],
                          "isthing": bool(is_thing_map.get(seg_labels[k],
                                                           True)),
                          "score": seg_scores[k], "area": area})
        results.append((seg_map, infos))
    return results
