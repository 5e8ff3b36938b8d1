"""Optimizer with the reference's per-fusion-type parameter policies
(counterpart of ``dfvod_tpu/train/optim.py``).

The label rules are the JAX package's (``param_group_label``), applied to
the port's dotted parameter names, which carry the flax module names
(``transformer.depth_encoder_layer.cross_attn.sampling_offsets.weight``).
Each label is one param group of a single ``torch.optim.AdamW`` (or ``SGD``
with momentum 0.9) at learning rate ``lr * mult``; ``frozen`` parameters get
``requires_grad=False`` and join no group, so autograd skips their backward
and they stay out of the clip norm, as ``stop_gradient`` does in
``dfvod_tpu/train/engine.py:127-131``.

Policies (``main.py:310-421``):
- Baseline:    backbone 0.1x lr, linear-proj 0.1x, rest 1x
- LateFusion:  RGB backbone frozen; depth encoder 10x (1x if linear-proj
               inside it); depth_backbone 1x; linear-proj 0.1x; rest 1x
- CrossFusion: fusion modules 10x (1x if linear-proj); backbone 1x;
               linear-proj 0.1x; rest 1x
- Encoder CF:  RGB backbone frozen; encoder fusion layers 10x (1x if
               linear-proj); depth_backbone 1x; linear-proj 0.1x; rest 1x

Schedule: CosineAnnealingLR(T_max=epochs, eta_min=0.1*lr) stepped per
epoch, as a multiplier on every group's base rate.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn

LINEAR_PROJ_NAMES = ("reference_points", "sampling_offsets")
CROSSFUSION_NAMES = ("d2r_fusion", "r2d_fusion", "rgb_proj", "d_proj")
TEMPORAL_NAMES = ("temporal", "temp_head", "dynamic", "qrf")


def _contains(path: Tuple[str, ...], *subs: str) -> bool:
    return any(s in part for part in path for s in subs)


def param_group_label(path: Tuple[str, ...], fusion_type: str,
                      fixed_pretrained_model: bool = False,
                      temporal: bool = False,
                      freeze_detr: bool = False) -> str:
    """Label one parameter path. Labels: base | backbone | linear_proj |
    fusion10x | frozen. A copy of the JAX package's rules."""
    if freeze_detr and not _contains(path, "mask_branch"):
        return "frozen"
    if fixed_pretrained_model and not _contains(path, *TEMPORAL_NAMES):
        return "frozen"
    is_proj = _contains(path, *LINEAR_PROJ_NAMES)
    if temporal:
        return "linear_proj" if is_proj else "base"
    rgb_backbone = (path[0] == "backbone"
                    or (len(path) > 1 and path[0] == "detr"
                        and path[1] == "backbone"))

    if fusion_type == "LateFusion":
        if rgb_backbone:
            return "frozen"
        if _contains(path, "depth_encoder_layer"):
            return "base" if is_proj else "fusion10x"
        return "linear_proj" if is_proj else "base"
    if fusion_type == "Backbone_CrossFusion":
        if _contains(path, *CROSSFUSION_NAMES):
            return "base" if is_proj else "fusion10x"
        if rgb_backbone:
            return "base"
        return "linear_proj" if is_proj else "base"
    if fusion_type == "Encoder_CrossFusion":
        if rgb_backbone:
            return "frozen"
        if _contains(path, "fusion_layers"):
            return "base" if is_proj else "fusion10x"
        return "linear_proj" if is_proj else "base"
    # Baseline (``main.py:404-421``)
    if rgb_backbone:
        return "backbone"
    return "linear_proj" if is_proj else "base"


def label_params(model: nn.Module, fusion_type: str,
                 fixed_pretrained_model: bool = False,
                 temporal: bool = False,
                 freeze_detr: bool = False) -> Dict[str, str]:
    """{parameter name: group label} over ``model.named_parameters()``."""
    return {name: param_group_label(tuple(name.split(".")), fusion_type,
                                    fixed_pretrained_model, temporal,
                                    freeze_detr)
            for name, _ in model.named_parameters()}


def cosine_epoch_multiplier(step: int, epochs: int, steps_per_epoch: int,
                            eta_min_mult: float) -> float:
    """CosineAnnealingLR(T_max=epochs) stepped per epoch, as a multiplier
    of the base rate at optimizer step ``step`` (0 for the first)."""
    epoch = min(step // max(steps_per_epoch, 1), epochs)
    cos = 0.5 * (1 + math.cos(math.pi * epoch / max(epochs, 1)))
    return eta_min_mult + (1.0 - eta_min_mult) * cos


def build_optimizer(model: nn.Module, model_cfg, train_cfg):
    """(optimizer, labels). One param group per trainable label, each with
    its ``base_lr`` (``lr * mult``) and its ``label``; ``frozen``
    parameters get ``requires_grad=False``."""
    mults = {"base": 1.0, "backbone": train_cfg.lr_backbone / train_cfg.lr,
             "linear_proj": train_cfg.lr_linear_proj_mult,
             "fusion10x": 10.0, "frozen": 0.0}
    labels = label_params(model, model_cfg.fusion_type,
                          model_cfg.fixed_pretrained_model,
                          temporal=model_cfg.temporal_mode != "none",
                          freeze_detr=bool(model_cfg.frozen_weights))
    members: Dict[str, List[nn.Parameter]] = {}
    for name, p in model.named_parameters():
        label = labels[name]
        p.requires_grad_(mults[label] != 0.0)
        if mults[label] != 0.0:
            members.setdefault(label, []).append(p)
    groups = [{"params": ps, "label": label,
               "base_lr": train_cfg.lr * mults[label],
               "lr": train_cfg.lr * mults[label]}
              for label, ps in members.items()]
    if train_cfg.sgd:
        opt = torch.optim.SGD(groups, lr=train_cfg.lr, momentum=0.9)
    else:
        # optax.adamw's defaults; decoupled decay scaled by the rate
        opt = torch.optim.AdamW(groups, lr=train_cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=train_cfg.weight_decay)
    return opt, labels


def set_learning_rates(optimizer, mult: float):
    """Every group's rate becomes ``base_lr * mult``."""
    for group in optimizer.param_groups:
        group["lr"] = group["base_lr"] * mult


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float):
    """optax's ``clip_by_global_norm`` in place on ``.grad``: ``g`` is kept
    when the global norm is below ``max_norm`` and becomes ``g / norm *
    max_norm`` otherwise. Parameters without a gradient are skipped. Unlike
    ``torch.nn.utils.clip_grad_norm_`` no epsilon is added to the norm.
    Returns the norm before clipping, as a tensor (no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    # one sum over all entries: torch's norm kernels accumulate serially in
    # f32 on the CPU (~4e-5 relative error at ResNet-50 sizes)
    norm = torch.cat([g.reshape(-1) for g in grads]).square().sum().sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm
