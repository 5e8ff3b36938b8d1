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

- two-stage: the encoder's proposals (``enc_outputs``) take the same
  losses against binary targets, every label 0, as ``loss_*_enc``.

- masks (``pred_masks`` in the outputs and ``masks`` in the targets):
  ``loss_mask`` (sigmoid focal, alpha ``focal_alpha``) and ``loss_dice`` on
  the last decoder layer's matched queries only, the predictions resized
  bilinearly to the target masks' size (``criterion.py:92-130`` of the
  JAX package).

The final and aux layers and the encoder's proposals are matched together
(``matcher.match_layers``) by ``matcher_backend``: ``"auto"``, the
on-device LAPJV, as the JAX package's default, or ``"scipy"``, the host
oracle. With the default the detection losses do not synchronise with the
host; the mask losses index the valid slots, which does.

Under data parallelism (a process group of more than one rank) every rank
divides by the global batch's box count over the ranks, all-reduced in
each call, so every rank must call the criterion in the same step.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from dfvod_tpu_torch.models.matcher import match_layers
from dfvod_tpu_torch.models.segmentation import resize_bilinear
from dfvod_tpu_torch.parallel.dist import world
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
    # filled on the device: a copy from the host (``torch.tensor(...,
    # device=...)``, or ``alpha_t[k] = a``) would synchronise the stream
    alpha_t = loss.new_empty(K)
    for k, a in enumerate(alpha_table):
        alpha_t[k].fill_(a)
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

    def __init__(self, num_classes: int, loss_cfg, matcher_backend="auto",
                 dec_layers: int = 6):
        self.num_classes = num_classes
        self.loss_cfg = loss_cfg
        self.matcher_backend = matcher_backend
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

    def _loss_masks(self, pred_masks, targets, assign, num_boxes):
        """Focal and dice on the matched queries' masks, each a pixel mean
        (focal) or a whole-mask ratio (dice), over num_boxes. The JAX
        package computes every target slot and zeroes the invalid ones;
        here only the valid slots are resized and scored (the same sums,
        without the (B, T, H, W) f32 tensors of the empty slots)."""
        valid = targets["valid"]                             # (B, T)
        Hm, Wm = targets["masks"].shape[-2:]
        src = torch.gather(pred_masks, 1, assign[:, :, None, None].expand(
            -1, -1, *pred_masks.shape[-2:]))[valid]          # (N, h, w)
        s = resize_bilinear(src, (Hm, Wm)).flatten(1)
        t = targets["masks"][valid].float().flatten(1)
        p = torch.sigmoid(s)
        ce = _bce_with_logits(s, t)
        p_t = p * t + (1 - p) * (1 - t)
        a = self.loss_cfg.focal_alpha
        a_t = a * t + (1 - a) * (1 - t)
        focal = (a_t * ce * (1 - p_t) ** 2).mean(1)
        num = 2 * (p * t).sum(1)
        den = p.sum(1) + t.sum(1)
        dice = 1 - (num + 1) / (den + 1)
        return {"loss_mask": focal.sum() / num_boxes,
                "loss_dice": dice.sum() / num_boxes}

    def __call__(self, outputs: Dict, targets: Dict):
        num_boxes = targets["valid"].float().sum()
        n = world()
        if n > 1:
            # the global batch's mean boxes per rank (``:520-524`` of the
            # reference): DDP's average of the ranks' gradients is then
            # the gradient of sum(loss) / sum(num_boxes) over the global
            # batch, as the JAX package's one program computes it
            dist.all_reduce(num_boxes)
            num_boxes = num_boxes / n
        num_boxes = num_boxes.clamp(min=1.0)
        aux_list = list(outputs.get("aux_outputs", []))
        enc = outputs.get("enc_outputs")
        layers = [outputs, *aux_list] + ([enc] if enc is not None else [])
        assign = match_layers(layers, targets, self.loss_cfg,
                              binary=[False] * (1 + len(aux_list))
                              + [True] * (enc is not None),
                              backend=self.matcher_backend)
        losses = self._loss_single(outputs, targets, assign[0], num_boxes)
        if "pred_masks" in outputs and "masks" in targets:
            losses.update(self._loss_masks(outputs["pred_masks"], targets,
                                           assign[0], num_boxes))
        for i, aux in enumerate(aux_list):
            l_aux = self._loss_single(aux, targets, assign[i + 1], num_boxes)
            losses.update({f"{k}_{i}": v for k, v in l_aux.items()
                           if k != "cardinality_error"})
        if enc is not None:
            binary = {**targets, "labels": torch.zeros_like(
                targets["labels"])}
            l_enc = self._loss_single(enc, binary, assign[-1], num_boxes)
            losses.update({f"{k}_enc": v for k, v in l_enc.items()
                           if k != "cardinality_error"})
        total = sum(losses[k] * w for k, w in self.weight_dict.items()
                    if k in losses)
        return total, losses
