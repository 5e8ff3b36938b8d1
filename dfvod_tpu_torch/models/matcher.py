"""Hungarian matcher: focal class cost + L1 + GIoU, solved exactly per image
(counterpart of ``dfvod_tpu/models/matcher.py``).

Targets follow the static padding contract: ``labels (B, T)``, ``boxes (B,
T, 4)`` normalized cxcywh, ``valid (B, T)`` bool. The cost matrices run on
the device. Two solver backends, as in the JAX package:

- ``hungarian_lapjv`` (``"lapjv"``, and ``"auto"``, the default): the JAX
  package's on-device shortest-augmenting-path solver, index for index,
  through ``ops/lapjv.py`` (the kernel ``csrc/lapjv.cu`` on the card). The
  costs never leave the device and the matcher does not synchronise.
- ``solve`` (``"scipy"``): ``scipy.optimize.linear_sum_assignment`` on the
  host, the JAX package's ``hungarian_scipy``, kept as the oracle. It
  copies every layer's costs to the host in one transfer per call.

``match_layers`` matches every decoder layer (the final one and the aux
ones) and the two-stage encoder's proposals (against binary targets)
together: one launch for the decoder layers, one for the proposals.
"""
from __future__ import annotations

import numpy as np
import torch

from dfvod_tpu_torch.ops.lapjv import lapjv
from dfvod_tpu_torch.utils.box_ops import (
    box_cxcywh_to_xyxy,
    generalized_box_iou,
)
from dfvod_tpu_torch.utils.trace import span

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


# the JAX package's name (``matcher.py:79``): cost (B, Q, T) f32, valid (B,
# T) bool; (B, T) int64, the query of every target slot, invalid slots
# included, on the costs' device
hungarian_lapjv = lapjv


@torch.no_grad()
def match_layers(outputs_list, targets, loss_cfg, binary=(), backend="auto"):
    """Assignments of several prediction sets against the same targets.

    outputs_list: dicts with pred_logits (B, Q, K) and pred_boxes (B, Q,
    4); each may hold its own Q (the two-stage encoder's S proposals).
    ``binary``: per entry, whether its targets are binary, every label 0,
    as the criterion holds the encoder's proposals (``criterion.py:201-
    207`` of the JAX package). ``backend``: ``"auto"`` (``"lapjv"``) or
    ``"scipy"``, as ``match`` of the JAX package takes it. Returns
    (len(outputs_list), B, T) int64 on the predictions' device: on the
    lapjv path the query of every slot, on the scipy path 0 in invalid
    slots. The lapjv path stacks the entries of one kind (``binary``) and
    one Q into one launch.
    Non-finite costs (a diverged step) are replaced as the JAX package does
    (``matcher.py:209``), so the solve always ends and the caller sees the
    non-finite loss."""
    if backend == "auto":
        backend = "lapjv"
    if backend not in ("lapjv", "scipy"):
        raise ValueError(f"matcher backend {backend!r}: 'auto', 'lapjv' or "
                         f"'scipy'")
    with span("matcher"):
        labels = targets["labels"]
        valid = targets["valid"]
        binary = list(binary or [False] * len(outputs_list))
        costs = [torch.nan_to_num(
            matching_cost(o["pred_logits"].detach().float(),
                          o["pred_boxes"].detach().float(),
                          torch.zeros_like(labels) if is_bin else labels,
                          targets["boxes"].float(), valid,
                          loss_cfg.set_cost_class, loss_cfg.set_cost_bbox,
                          loss_cfg.set_cost_giou),
            nan=1e9, posinf=1e9, neginf=-1e9)
            for o, is_bin in zip(outputs_list, binary)]
        if backend == "lapjv":
            # one launch per (target kind, Q): the decoder layers, the
            # proposals
            groups = [(is_bin, c.shape[1]) for is_bin, c in zip(binary, costs)]
            assign = [None] * len(costs)
            for key in dict.fromkeys(groups):
                at = [k for k, g in enumerate(groups) if g == key]
                got = hungarian_lapjv(torch.cat([costs[k] for k in at]),
                                      valid.repeat(len(at), 1))
                for k, a in zip(at, got.view(len(at), *valid.shape)):
                    assign[k] = a
            return torch.stack(assign)
        # one device-to-host copy for every cost and the valid mask together
        flat = torch.cat([c.reshape(-1) for c in costs]
                         + [valid.to(costs[0].dtype).reshape(-1)])
        host = flat.cpu().numpy()
        valid_np = host[-valid.numel():].reshape(valid.shape) > 0.5
        assign, at = [], 0
        for c in costs:
            assign.append(solve(host[at:at + c.numel()].reshape(c.shape),
                                valid_np))
            at += c.numel()
        return torch.from_numpy(np.stack(assign)).to(costs[0].device)
