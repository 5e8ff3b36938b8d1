"""Plain reference of the benchmarked train step, in float32 PyTorch.

A frozen copy of the port's LateFusion training semantics: normalize the
uint8 frames, the forward in train mode (dropout from a generator seeded
``train_seed``), the Hungarian-matched criterion (the 3-class modified
focal loss, L1 and GIoU on every decoder layer) with the assignment solved
by ``scipy.optimize.linear_sum_assignment`` on the host, backward, the
global-norm clip, and AdamW over the LateFusion parameter groups (RGB
backbone frozen, the depth fusion layer at 10x, the sampling offsets and
reference points at 0.1x). ``DataParallelStep`` is the same step over the
global batch of data-parallel ranks. Imports nothing of the port.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from perfbench.reference.model import (
    box_cxcywh_to_xyxy,
    normalize,
    set_dropout_generator,
)

ALPHA_TABLE = (0.0, 1.0, 0.001)
LINEAR_PROJ = ("reference_points", "sampling_offsets")


def group_label(name: str) -> str:
    """LateFusion's parameter policy: frozen RGB backbone, the depth
    encoder layer at 10x (its linear projections at 1x), linear
    projections elsewhere at ``lr_linear_proj_mult``, the rest at 1x."""
    parts = name.split(".")
    proj = any(p in part for part in parts for p in LINEAR_PROJ)
    if parts[0] == "backbone":
        return "frozen"
    if any("depth_encoder_layer" in part for part in parts):
        return "base" if proj else "fusion10x"
    return "linear_proj" if proj else "base"


def build_optimizer(model, tc):
    mults = {"base": 1.0, "linear_proj": tc["lr_linear_proj_mult"],
             "fusion10x": 10.0}
    groups = {}
    for name, p in model.named_parameters():
        label = group_label(name)
        p.requires_grad_(label != "frozen")
        if label != "frozen":
            groups.setdefault(label, []).append(p)
    return torch.optim.AdamW(
        [{"params": ps, "lr": tc["lr"] * mults[k], "label": k}
         for k, ps in groups.items()],
        lr=tc["lr"], betas=(0.9, 0.999), eps=1e-8,
        weight_decay=tc["weight_decay"])


def giou_pairwise(a, b):
    """(N, 4) x (M, 4) xyxy -> (N, M) generalized IoU."""
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = torch.max(a[:, None, :2], b[None, :, :2])
    rb = torch.min(a[:, None, 2:], b[None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area_a[:, None] + area_b[None] - inter
    iou = inter / union.clamp(min=1e-9)
    lt = torch.min(a[:, None, :2], b[None, :, :2])
    rb = torch.max(a[:, None, 2:], b[None, :, 2:])
    hull = (rb - lt).clamp(min=0).prod(-1)
    return iou - (hull - union) / hull.clamp(min=1e-9)


@torch.no_grad()
def match(logits, boxes, labels, tboxes, valid, lc):
    """Per image, the query matched to each valid target slot (others 0):
    the focal class cost, L1 and GIoU costs, solved by scipy."""
    B = logits.shape[0]
    out = np.zeros(valid.shape, np.int64)
    prob = torch.sigmoid(logits.float())
    a, g = 0.25, 2.0
    neg = (1 - a) * prob ** g * -torch.log1p(-prob + 1e-8)
    pos = a * (1 - prob) ** g * -torch.log(prob + 1e-8)
    for b in range(B):
        cols = torch.nonzero(valid[b]).flatten()
        if cols.numel() == 0:
            continue
        lab = labels[b, cols].long()
        tb = tboxes[b, cols].float()
        c = (lc["set_cost_class"] * (pos[b] - neg[b])[:, lab]
             + lc["set_cost_bbox"] * torch.cdist(boxes[b].float(), tb, p=1)
             - lc["set_cost_giou"] * giou_pairwise(
                 box_cxcywh_to_xyxy(boxes[b].float()),
                 box_cxcywh_to_xyxy(tb)))
        rows, picked = linear_sum_assignment(c.cpu().double().numpy())
        out[b, cols.cpu().numpy()[picked]] = rows
    return torch.from_numpy(out).to(logits.device)


def layer_losses(logits, boxes, targets, assign, num_boxes):
    """The weighted-ready parts of one decoder layer: loss_ce (the
    reference's modified focal loss for 3 classes), loss_bbox, loss_giou."""
    B, Q, K = logits.shape
    valid = targets["valid"]
    cls = torch.full((B, Q), K, dtype=torch.long, device=logits.device)
    for b in range(B):
        v = valid[b]
        cls[b, assign[b][v]] = targets["labels"][b][v].long()
    onehot = F.one_hot(cls, K + 1)[..., :K].float()
    onehot[..., K - 1] = (onehot[..., 1] != 1).float()
    prob = torch.sigmoid(logits)
    ce = F.binary_cross_entropy_with_logits(logits, onehot,
                                            reduction="none")
    p_t = prob * onehot + (1 - prob) * (1 - onehot)
    alpha = torch.tensor(ALPHA_TABLE, device=logits.device)
    loss_ce = (alpha * ce * (1 - p_t) ** 2).mean(1).sum() / num_boxes * Q
    src = torch.gather(boxes, 1, assign[..., None].expand(-1, -1, 4))
    tgt = targets["boxes"].float()
    vf = valid.float()
    loss_bbox = ((src - tgt).abs().sum(-1) * vf).sum() / num_boxes
    s, t = box_cxcywh_to_xyxy(src), box_cxcywh_to_xyxy(tgt)
    area_s = (s[..., 2] - s[..., 0]) * (s[..., 3] - s[..., 1])
    area_t = (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])
    inter = (torch.min(s[..., 2:], t[..., 2:])
             - torch.max(s[..., :2], t[..., :2])).clamp(min=0).prod(-1)
    union = area_s + area_t - inter
    hull = (torch.max(s[..., 2:], t[..., 2:])
            - torch.min(s[..., :2], t[..., :2])).clamp(min=0).prod(-1)
    giou = inter / union.clamp(min=1e-9) - (hull - union) / hull.clamp(
        min=1e-9)
    loss_giou = ((1 - giou) * vf).sum() / num_boxes
    return loss_ce, loss_bbox, loss_giou


def criterion(out, targets, lc, num_boxes=None):
    """Total weighted loss over the final and aux decoder layers, each
    part over ``num_boxes`` (by default the valid slots of ``targets``)."""
    if num_boxes is None:
        num_boxes = targets["valid"].float().sum().clamp(min=1.0)
    total = 0.0
    for o in [out, *out["aux_outputs"]]:
        assign = match(o["pred_logits"], o["pred_boxes"], targets["labels"],
                       targets["boxes"], targets["valid"], lc)
        ce, l1, giou = layer_losses(o["pred_logits"], o["pred_boxes"],
                                    targets, assign, num_boxes)
        total = (total + lc["cls_loss_coef"] * ce + lc["bbox_loss_coef"] * l1
                 + lc["giou_loss_coef"] * giou)
    return total


class TrainStep:
    """The reference step over ``model`` (f32, on the caller's device)."""

    def __init__(self, model, tc, lc, train_seed: int):
        self.model, self.tc, self.lc = model, tc, lc
        self.opt = build_optimizer(model, tc)
        self.gen = torch.Generator(device=next(model.parameters()).device)
        self.gen.manual_seed(train_seed)
        set_dropout_generator(model, self.gen)

    def __call__(self, batch):
        """One step; returns the loss as a float."""
        self.opt.zero_grad(set_to_none=True)
        self.model.train()
        images, mask = normalize(batch["images"], batch["sizes"])
        out = self.model(images, mask)
        self.last_out = {k: out[k].detach() for k in ("pred_logits",
                                                      "pred_boxes")}
        # every 16th token of every frame's encoder memory
        self.last_out["memory"] = out["_trunk"]["memory"][:, ::16].detach()
        loss = criterion(out, batch, self.lc)
        loss.backward()
        self.update()
        return float(loss.detach())

    def update(self):
        """The global-norm clip of the gradients and one AdamW step."""
        params = [p for g in self.opt.param_groups for p in g["params"]
                  if p.grad is not None]
        norm = torch.sqrt(sum(p.grad.double().square().sum()
                              for p in params))
        if norm >= self.tc["clip_max_norm"]:
            for p in params:
                p.grad.mul_((self.tc["clip_max_norm"] / norm).float())
        self.opt.step()


class DataParallelStep(TrainStep):
    """The step of ``ranks`` data-parallel ranks over one global batch,
    rank r holding the r-th contiguous block of rows: one step over the
    global batch, as the ranks' gradient all-reduce makes it. The DFormer
    path's BatchNorms take the global batch's statistics (they run once
    over every row); each loss part is over the global box count; rank
    r's dropout masks come from its own generator, seeded ``train_seed +
    r`` and drawn for its block alone. The rest of the model runs a block
    at a time, so that the step fits where one block does."""

    def __init__(self, model, tc, lc, train_seed: int, ranks: int):
        super().__init__(model, tc, lc, train_seed)
        device = next(model.parameters()).device
        self.gens = [torch.Generator(device=device).manual_seed(
            train_seed + r) for r in range(ranks)]

    def __call__(self, batch):
        self.opt.zero_grad(set_to_none=True)
        self.model.train()
        images, mask = normalize(batch["images"], batch["sizes"])
        depth = (self.model.detr if hasattr(self.model, "detr")
                 else self.model).depth_backbone
        feat, dmask = depth(images[..., 3:4], mask)
        feat_grad = torch.zeros_like(feat)
        num_boxes = batch["valid"].float().sum().clamp(min=1.0)
        n = images.shape[0] // len(self.gens)
        total, outs = 0.0, []
        try:
            for r, gen in enumerate(self.gens):
                rows = slice(r * n, (r + 1) * n)
                part = feat[rows].detach().requires_grad_()
                depth.forward = (lambda *a, part=part, m=dmask[rows]:
                                 (part, m))
                set_dropout_generator(self.model, gen)
                out = self.model(images[rows], mask[rows])
                outs.append({"pred_logits": out["pred_logits"].detach(),
                             "pred_boxes": out["pred_boxes"].detach(),
                             "memory": out["_trunk"]["memory"][
                                 :, ::16].detach()})
                loss = criterion(out, {k: v[rows] for k, v in batch.items()},
                                 self.lc, num_boxes)
                loss.backward()
                feat_grad[rows] = part.grad
                total += float(loss.detach())
                del out, loss
        finally:
            depth.__dict__.pop("forward", None)
        feat.backward(feat_grad)
        self.last_out = {k: torch.cat([o[k] for o in outs])
                         for k in outs[0]}
        self.update()
        return total


def first_moment_grads(optimizer, named):
    """{name: the gradient the optimizer took in its first step}, read back
    from AdamW's state: exp_avg = (1 - beta1) * g after one step."""
    out = {}
    for name, p in named:
        st = optimizer.state.get(p)
        if st and "exp_avg" in st:
            beta1 = next(g["betas"][0] for g in optimizer.param_groups
                         if any(q is p for q in g["params"]))
            out[name] = st["exp_avg"].float() / (1 - beta1)
    return out


def leaf_norms(tensors):
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def leaf_gaps(prog, ref, skip=()):
    """{leaf: |prog - ref| / max(ref, median ref)} over the leaves of
    ``ref`` not in ``skip``; ``prog`` and ``ref``: {name: norm}."""
    keys = [k for k in ref if k not in skip]
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys}

