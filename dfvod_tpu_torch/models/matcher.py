"""Hungarian matcher: focal class cost + L1 + GIoU, solved exactly per image
(counterpart of ``dfvod_tpu/models/matcher.py``).

Targets follow the static padding contract: ``labels (B, T)``, ``boxes (B,
T, 4)`` normalized cxcywh, ``valid (B, T)`` bool. The cost matrices run on
the device. The assignment is solved on the host with
``scipy.optimize.linear_sum_assignment``, the JAX package's
``hungarian_scipy`` backend: the same optimum as its default on-device
LAPJV. ``match_layers`` stacks the costs of every decoder layer (the final
one and the aux ones) and copies them to the host in one transfer, so a
train step syncs once for the matcher, not once per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from dfvod_tpu_torch.utils.box_ops import (
    box_cxcywh_to_xyxy,
    generalized_box_iou,
)

BIG_COST = 1e6


def matching_cost(pred_logits, pred_boxes, tgt_labels, tgt_boxes, tgt_valid,
                  cost_class: float = 2.0, cost_bbox: float = 5.0,
                  cost_giou: float = 2.0, alpha: float = 0.25,
                  gamma: float = 2.0):
    """Cost matrices (B, Q, T) of a batch; invalid target columns get
    ``BIG_COST``. The JAX function is per image (``matcher.py:29-48``);
    this one takes the batch dimension in front."""
    prob = torch.sigmoid(pred_logits)                         # (B, Q, K)
    neg = (1 - alpha) * (prob ** gamma) * (-torch.log1p(-prob + 1e-8))
    pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    B, Q, _ = pred_logits.shape
    T = tgt_labels.shape[1]
    cls_cost = torch.gather(pos - neg, 2,
                            tgt_labels.long()[:, None, :].expand(B, Q, T))
    bbox_cost = (pred_boxes[:, :, None, :]
                 - tgt_boxes[:, None, :, :]).abs().sum(-1)
    giou_cost = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes),
                                     box_cxcywh_to_xyxy(tgt_boxes))
    C = cost_bbox * bbox_cost + cost_class * cls_cost + cost_giou * giou_cost
    return torch.where(tgt_valid[:, None, :], C,
                       torch.full_like(C, BIG_COST))


def solve(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Exact assignments on the host. cost: (..., Q, T); valid: (..., T)
    bool, broadcast against cost's leading dims. Returns (..., T) int64:
    the query matched to each valid target slot, 0 for invalid slots."""
    from scipy.optimize import linear_sum_assignment

    lead = cost.shape[:-2]
    valid = np.broadcast_to(valid, lead + valid.shape[-1:])
    out = np.zeros(lead + cost.shape[-1:], np.int64)
    for idx in np.ndindex(*lead):
        cols = np.flatnonzero(valid[idx])
        if cols.size == 0:
            continue
        rows, picked = linear_sum_assignment(cost[idx][:, cols])
        out[idx + (cols[picked],)] = rows
    return out


@torch.no_grad()
def match_layers(outputs_list, targets, loss_cfg):
    """Assignments of several prediction sets against the same targets.

    outputs_list: dicts with pred_logits (B, Q, K) and pred_boxes (B, Q,
    4). Returns (len(outputs_list), B, T) int64 on the predictions' device.
    Non-finite costs (a diverged step) are replaced as the JAX package does
    (``matcher.py:209``), so the solve always ends and the caller sees the
    non-finite loss."""
    cost = torch.stack([
        matching_cost(o["pred_logits"].detach().float(),
                      o["pred_boxes"].detach().float(), targets["labels"],
                      targets["boxes"].float(), targets["valid"],
                      loss_cfg.set_cost_class, loss_cfg.set_cost_bbox,
                      loss_cfg.set_cost_giou)
        for o in outputs_list])                              # (N, B, Q, T)
    cost = torch.nan_to_num(cost, nan=1e9, posinf=1e9, neginf=-1e9)
    # one device-to-host copy for the costs and the valid mask together
    valid = targets["valid"]
    host = torch.cat([cost.reshape(-1),
                      valid.to(cost.dtype).reshape(-1)]).cpu().numpy()
    cost_np = host[:cost.numel()].reshape(cost.shape)
    valid_np = host[cost.numel():].reshape(valid.shape) > 0.5
    assign = solve(cost_np, valid_np[None])
    return torch.from_numpy(assign).to(cost.device)
