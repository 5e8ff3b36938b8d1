"""PostProcess: model outputs -> detections (counterpart of
``dfvod_tpu/models/postprocess.py``).

Sigmoid over logits, top-k over the flattened (query x class) scores, gather
boxes, cxcywh -> xyxy, scale to the image size. As in the JAX package, with
K == 3 the no-object channel 2 is excluded (the reference's intended,
dead-code behavior; see the JAX module's docstring), and top-k is clamped
to Q * K for small-Q configs.
"""
from __future__ import annotations

import torch

from dfvod_tpu_torch.utils.box_ops import box_cxcywh_to_xyxy


def postprocess(pred_logits, pred_boxes, target_sizes, top_k: int = 100):
    """
    pred_logits: (B, Q, K); pred_boxes: (B, Q, 4) normalized cxcywh;
    target_sizes: (B, 2) image (h, w). Returns dict of scores (B, k),
    labels (B, k), boxes (B, k, 4) in absolute xyxy pixels, scores
    descending.
    """
    B, Q, K = pred_logits.shape
    Ke = K - 1 if K == 3 else K
    prob = torch.sigmoid(pred_logits[..., :Ke]).reshape(B, Q * Ke)
    scores, topk_idx = torch.topk(prob, min(top_k, Q * Ke), dim=1)
    topk_boxes = topk_idx // Ke
    labels = topk_idx % Ke
    boxes = box_cxcywh_to_xyxy(pred_boxes)
    boxes = torch.gather(boxes, 1, topk_boxes[..., None].expand(-1, -1, 4))
    target_sizes = target_sizes.to(boxes.device)
    h, w = target_sizes[:, 0], target_sizes[:, 1]
    scale = torch.stack([w, h, w, h], dim=1).to(boxes.dtype)
    return {"scores": scores, "labels": labels,
            "boxes": boxes * scale[:, None, :]}
