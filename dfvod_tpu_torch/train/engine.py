"""The train step (counterpart of ``dfvod_tpu/train/engine.py``):
``create_train_state`` + ``train_step``.

One step: ``device_normalize`` on uint8 frames -> the forward in
``model.train()`` (under ``torch.autocast`` to bf16 when
``train_dtype="bfloat16"``, with f32 master parameters and optimizer state)
-> the criterion in f32 -> ``backward`` -> optax-style global-norm clip ->
one step of the grouped optimizer. The only host sync is the matcher's one
copy of the cost matrices; the metrics come back as device tensors. A
non-finite loss is reported in the metrics, not raised.

The batch is the dict of ``dfvod_tpu/cli/main.py::to_batch``: ``images``
uint8 (B, H, W, C) with ``sizes`` (B, 2), ``labels`` (B, T), ``boxes``
(B, T, 4) normalized cxcywh, ``valid`` (B, T). For a TransVOD / TransVOD++
model the rows are frames, B = clips * F with F = 1 + num_ref_frames, clips
contiguous and key frame first; the model predicts for the key frames only,
so the criterion reads the key frames' target rows, as
``make_train_step(frames=F)`` does (``dfvod_tpu/train/engine.py:93-96``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch import nn

from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models.layers import set_dropout_generator
from dfvod_tpu_torch.train.optim import (
    build_optimizer,
    clip_by_global_norm_,
    cosine_epoch_multiplier,
    set_learning_rates,
)
from dfvod_tpu_torch.utils.config import Config, check_supported

TRAIN_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass
class TrainState:
    """What a train step carries from one step to the next. The model
    holds the parameters and the DFormer BN running statistics; dropout
    draws from ``generator``."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    labels: Dict[str, str]
    generator: torch.Generator
    cfg: Config
    steps_per_epoch: int
    step: int = 0


def create_train_state(model: nn.Module, cfg: Config,
                       steps_per_epoch: int = 1000) -> TrainState:
    """The optimizer over ``model``'s parameters (frozen ones get
    ``requires_grad=False``), its labels, and a dropout generator on the
    model's device seeded from ``cfg.train.seed``."""
    check_supported(cfg.model, training=True)
    if cfg.train.train_dtype not in TRAIN_DTYPES:
        raise ValueError(f"train_dtype {cfg.train.train_dtype!r} not in "
                         f"{TRAIN_DTYPES}")
    optimizer, labels = build_optimizer(model, cfg.model, cfg.train)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed)
    set_dropout_generator(model, generator)
    return TrainState(model, optimizer, labels, generator, cfg,
                      steps_per_epoch)


def _as_tensor(x, device):
    return (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            ).to(device)


def _f32(out):
    """The criterion's inputs cast to f32 (``engine.py:148-152``)."""
    res = {k: out[k].float() for k in ("pred_logits", "pred_boxes")}
    if "aux_outputs" in out:
        res["aux_outputs"] = [{k: a[k].float() for k in a}
                              for a in out["aux_outputs"]]
    return res


def forward(state: TrainState, batch):
    """The forward in train mode: (the outputs cast to f32, the key rows'
    targets), ready for the criterion."""
    model = state.model
    device = next(model.parameters()).device
    images = _as_tensor(batch["images"], device)
    if images.dtype != torch.uint8:
        raise TypeError(f"images must be uint8 frames, got {images.dtype}")
    images, mask = device_normalize(images, _as_tensor(batch["sizes"], device))
    m = state.cfg.model
    # batch rows per prediction: the clip's frames, key frame first
    F = 1 if m.temporal_mode == "none" else 1 + m.num_ref_frames
    targets = {}
    for k in ("labels", "boxes", "valid"):
        x = _as_tensor(batch[k], device)
        targets[k] = x.reshape(x.shape[0] // F, F, *x.shape[1:])[:, 0]
    model.train()
    bf16 = state.cfg.train.train_dtype == "bfloat16"
    with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
        out = model(images, mask)
    return _f32(out), targets


def apply_gradients(state: TrainState) -> torch.Tensor:
    """The update from the ``.grad`` of the trainable parameters: the
    global-norm clip, this step's cosine multiplier on every group's rate,
    one optimizer step. Returns the norm before clipping."""
    tc = state.cfg.train
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    grad_norm = clip_by_global_norm_(params, tc.clip_max_norm)
    set_learning_rates(state.optimizer, cosine_epoch_multiplier(
        state.step, tc.epochs, state.steps_per_epoch,
        tc.cosine_eta_min_mult))
    state.optimizer.step()
    state.step += 1
    return grad_norm


def train_step(state: TrainState, criterion, batch) -> Dict[str,
                                                              torch.Tensor]:
    """One optimizer step. Returns {loss, grad_norm, loss_ce, loss_bbox,
    loss_giou, cardinality_error, loss_ce_0, ...} as device tensors;
    ``grad_norm`` is the global norm before clipping."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, parts = criterion(*forward(state, batch))
    loss.backward()
    grad_norm = apply_gradients(state)
    metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
    metrics.update({k: v.detach() for k, v in parts.items()})
    return metrics
