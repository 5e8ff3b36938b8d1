"""SetCriterion: Hungarian-matched detection losses on padded targets
(counterpart of ``dfvod_tpu/models/criterion.py``).

The reference semantics the JAX package keeps are kept here too:

- the modified focal loss for the 3-class hand datasets: per-class alpha
  table ``[0, 1, 0.001]``, gamma 2, and the last class channel overwritten
  with the no-object indicator before the BCE, then ``loss.mean(1).sum() /
  num_boxes`` times the query count;
- the standard sigmoid focal loss (alpha ``focal_alpha``) for other class
  counts;
- L1 and GIoU on matched boxes; the cardinality error is logged only.

The final and aux layers are matched together (``matcher.match_layers``):
one host sync per call. Masks and two-stage ``enc_outputs`` raise.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from dfvod_tpu_torch.models.matcher import match_layers
from dfvod_tpu_torch.utils.box_ops import (
    box_cxcywh_to_xyxy,
    elementwise_generalized_box_iou,
)

ALPHA_TABLE = (0.0, 1.0, 0.001)


def _bce_with_logits(logits, targets):
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def modified_sigmoid_focal_loss(logits, targets_onehot, num_boxes,
                                gamma: float = 2.0, alpha_table=ALPHA_TABLE):
    """The reference's hand-dataset focal loss (``criterion.py:33-52`` of
    the JAX package). targets_onehot: (B, Q, K) with K == 3; its last
    channel is replaced by the no-object indicator."""
    K = logits.shape[-1]
    if K != len(alpha_table):
        raise ValueError(f"{K} classes, alpha table {alpha_table}")
    no_obj = (targets_onehot[..., 1] != 1).to(targets_onehot.dtype)
    targets_onehot = torch.cat([targets_onehot[..., :2], no_obj[..., None]],
                               dim=-1)
    prob = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, targets_onehot)
    p_t = prob * targets_onehot + (1 - prob) * (1 - targets_onehot)
    loss = ce * ((1 - p_t) ** gamma)
    alpha_t = torch.tensor(alpha_table, dtype=loss.dtype,
                           device=loss.device)
    return (alpha_t * loss).mean(1).sum() / num_boxes


def sigmoid_focal_loss(logits, targets, num_boxes, alpha: float = 0.25,
                       gamma: float = 2.0):
    """The standard focal loss (``criterion.py:55-65`` of the JAX
    package)."""
    prob = torch.sigmoid(logits)
    ce = _bce_with_logits(logits, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.mean(1).sum() / num_boxes


class SetCriterion:
    """Call with the model's outputs and padded targets; returns (total
    weighted loss, dict of unweighted components)."""

    def __init__(self, num_classes: int, loss_cfg, dec_layers: int = 6):
        self.num_classes = num_classes
        self.loss_cfg = loss_cfg
        self.weight_dict = self._build_weight_dict(dec_layers)

    def _build_weight_dict(self, dec_layers: int):
        wd = {"loss_ce": self.loss_cfg.cls_loss_coef,
              "loss_bbox": self.loss_cfg.bbox_loss_coef,
              "loss_giou": self.loss_cfg.giou_loss_coef}
        aux = {}
        for i in range(dec_layers - 1):
            aux.update({f"{k}_{i}": v for k, v in wd.items()})
        aux.update({f"{k}_enc": v for k, v in wd.items()})
        wd.update(aux)
        wd["loss_mask"] = self.loss_cfg.mask_loss_coef
        wd["loss_dice"] = self.loss_cfg.dice_loss_coef
        return wd

    def _loss_single(self, outputs, targets, assign, num_boxes):
        """Losses of one prediction set under a given assignment (B, T)."""
        logits = outputs["pred_logits"]                      # (B, Q, K)
        boxes = outputs["pred_boxes"]                        # (B, Q, 4)
        B, Q, K = logits.shape
        valid = targets["valid"]                             # (B, T)

        # matched labels scattered into a (B, Q) class map; invalid slots
        # go to the extra column Q, which is dropped
        a_safe = torch.where(valid, assign, torch.full_like(assign, Q))
        classes = torch.full((B, Q + 1), self.num_classes, dtype=torch.long,
                             device=logits.device)
        classes.scatter_(1, a_safe, targets["labels"].long())
        onehot = F.one_hot(classes[:, :Q], K + 1)[..., :-1].to(logits.dtype)
        if K == 3:
            loss_ce = modified_sigmoid_focal_loss(logits, onehot,
                                                  num_boxes) * Q
        else:
            loss_ce = sigmoid_focal_loss(logits, onehot, num_boxes,
                                         alpha=self.loss_cfg.focal_alpha) * Q

        src_boxes = torch.gather(boxes, 1,
                                 assign[:, :, None].expand(-1, -1, 4))
        vf = valid.to(boxes.dtype)
        tgt_boxes = targets["boxes"].to(boxes.dtype)
        loss_bbox = ((src_boxes - tgt_boxes).abs().sum(-1) * vf).sum() \
            / num_boxes
        giou = elementwise_generalized_box_iou(box_cxcywh_to_xyxy(src_boxes),
                                               box_cxcywh_to_xyxy(tgt_boxes))
        loss_giou = ((1.0 - giou) * vf).sum() / num_boxes

        with torch.no_grad():
            card_pred = (logits.argmax(-1) != K - 1).float().sum(1)
            card_err = (card_pred - valid.float().sum(1)).abs().mean()
        return {"loss_ce": loss_ce, "loss_bbox": loss_bbox,
                "loss_giou": loss_giou, "cardinality_error": card_err}

    def __call__(self, outputs: Dict, targets: Dict):
        if "pred_masks" in outputs or "masks" in targets:
            raise NotImplementedError("mask losses wait for the segmentation "
                                      "slice")
        if "enc_outputs" in outputs:
            raise NotImplementedError("two-stage enc_outputs wait for the "
                                      "other-fusion-modes slice (two-stage "
                                      "proposals)")
        num_boxes = targets["valid"].float().sum().clamp(min=1.0)
        layers = [outputs] + list(outputs.get("aux_outputs", []))
        assign = match_layers(layers, targets, self.loss_cfg)
        losses = self._loss_single(outputs, targets, assign[0], num_boxes)
        for i, aux in enumerate(layers[1:]):
            l_aux = self._loss_single(aux, targets, assign[i + 1], num_boxes)
            losses.update({f"{k}_{i}": v for k, v in l_aux.items()
                           if k != "cardinality_error"})
        total = sum(losses[k] * w for k, w in self.weight_dict.items()
                    if k in losses)
        return total, losses
