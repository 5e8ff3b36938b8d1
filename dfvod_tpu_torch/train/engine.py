"""The train step (counterpart of ``dfvod_tpu/train/engine.py``):
``create_train_state`` + ``train_step``.

One step: ``normalize_frames`` on uint8 frames -> the forward in
``model.train()`` (under ``torch.autocast`` to bf16 when
``train_dtype="bfloat16"``, with f32 master parameters and optimizer state)
-> the criterion in f32 -> ``backward`` -> optax-style global-norm clip ->
one step of the grouped optimizer. The criterion (the matcher runs on the
device), the backward and the update do not synchronise; the forward does
where it copies the batch and small constants to the card (the ``sync.*``
counters of ``utils/trace.py`` count them); the metrics come back as
device tensors. A non-finite loss is reported in the metrics, not raised.

The batch is the dict of ``dfvod_tpu/cli/main.py::to_batch``: ``images``
uint8 (B, H, W, C) with ``sizes`` (B, 2), ``labels`` (B, T), ``boxes``
(B, T, 4) normalized cxcywh, ``valid`` (B, T). For a TransVOD / TransVOD++
model the rows are frames, B = clips * F with F = 1 + num_ref_frames, clips
contiguous and key frame first; the model predicts for the key frames only,
so the criterion reads the key frames' target rows, as
``make_train_step(frames=F)`` does (``dfvod_tpu/train/engine.py:93-96``).

Data parallelism: when a process group exists (``parallel.init_distributed``)
each process passes its own rows of the global batch, and the step is the
JAX package's one step over the global batch: the model runs wrapped in
``DistributedDataParallel`` (the reference's mechanism, ``main.py:439-443``),
which averages the gradients over the ranks before the clip; the criterion
divides by the global box count (``models/criterion.py``); with more than
one rank the DFormer BatchNorms take the global batch's statistics
(``models/backbone_dformer.py``); the returned metrics are the ranks'
means, the global batch's; and dropout draws from ``seed + rank``. Without
a process group nothing of this runs.

Clip-parallel training of a TransVOD / TransVOD++ model
(``create_train_state(..., clip=C)``, the JAX package's
``make_train_step(frames=F)`` on a ``('clip', 'data')`` mesh under
``clip_batch_sharding``): the C·D ranks form D clip groups of C ranks
(``parallel.make_groups``; rank = c·D + d). Every rank of clip group d
passes the same rows, the group's share of the global batch
(``parallel.clip_group_rows(batch, C)``: whole clips), and its trunk runs
its c-th share of them; the temporal heads run on the gathered trunk
outputs on every rank of the group. DDP averages over all C·D ranks, the
gather's backward sums the heads' gradients over the clip group, and the
step equals the one-process step over the global batch. The heads'
dropout draws from ``seed + d``, the same masks on every rank of a clip
group (the C replicas stay one model); the trunk's from ``seed + rank``.
With ``--masks`` (``ModelConfig.masks``) the batch carries ``masks`` (B,
T, H, W) and the criterion adds ``loss_mask`` / ``loss_dice``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from dfvod_tpu_torch import parallel
from dfvod_tpu_torch.data.device_pipeline import normalize_frames
from dfvod_tpu_torch.models.backbone_dformer import set_batchnorm_group
from dfvod_tpu_torch.models.layers import set_dropout_generator
from dfvod_tpu_torch.train.optim import (
    build_optimizer,
    clip_by_global_norm_,
    cosine_epoch_multiplier,
    set_learning_rates,
)
from dfvod_tpu_torch.utils.config import Config, check_supported
from dfvod_tpu_torch.utils.device import as_tensor
from dfvod_tpu_torch.utils.trace import span

TRAIN_DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass
class TrainState:
    """What a train step carries from one step to the next. The model
    holds the parameters and the DFormer BN running statistics; dropout
    draws from ``generator``. Under data parallelism ``ddp`` is the
    ``DistributedDataParallel`` wrapper the forward runs through, and
    ``model`` stays the unwrapped module, whose names the optimizer and
    the checkpoints use."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    labels: Dict[str, str]
    generator: torch.Generator
    cfg: Config
    steps_per_epoch: int
    step: int = 0
    ddp: Optional[nn.Module] = None
    # clip-parallel training: the temporal heads' dropout generator,
    # seeded ``head_seed`` (``seed + d``)
    head_generator: Optional[torch.Generator] = None
    head_seed: Optional[int] = None


def unused_parameters_expected(model_cfg) -> bool:
    """Whether a train step of this configuration leaves some trainable
    parameter without a gradient, which DDP must then search for
    (``find_unused_parameters``). A TransVOD / TransVOD++ step does: the
    trunk's heads feed only the top-k of the reference frames' queries
    (and, two-stage, the proposals' top-k), through which no gradient
    passes. Frozen parameters (``requires_grad=False``) do not count."""
    return model_cfg.temporal_mode != "none"


def create_train_state(model: nn.Module, cfg: Config,
                       steps_per_epoch: int = 1000,
                       clip: Optional[int] = None) -> TrainState:
    """The optimizer over ``model``'s parameters (frozen ones get
    ``requires_grad=False``), its labels, and a dropout generator on the
    model's device seeded from ``cfg.train.seed``.

    ``clip``: clip-parallel training of a temporal model over the process
    group, ``clip`` ranks to a clip group (see the module's docstring).
    Every process calls it in the same order (it forms the groups). It
    raises without a process group, for a single-frame model, and unless
    ``clip`` divides the world."""
    check_supported(cfg.model, training=True)
    if cfg.train.train_dtype not in TRAIN_DTYPES:
        raise ValueError(f"train_dtype {cfg.train.train_dtype!r} not in "
                         f"{TRAIN_DTYPES}")
    optimizer, labels = build_optimizer(model, cfg.model, cfg.train)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(
        cfg.train.seed + parallel.rank())
    set_dropout_generator(model, generator)
    head_generator = head_seed = None
    if clip is not None:
        if cfg.model.temporal_mode == "none":
            raise ValueError("clip-parallel training splits a clip's frames "
                             "over the ranks: a single-frame model has "
                             "none (train it data-parallel)")
        if not parallel.initialized():
            raise ValueError("clip-parallel training needs a process group "
                             "(parallel.init_distributed)")
        _, d = parallel.clip_layout(parallel.rank(), parallel.world(), clip)
        model.trunk_group = parallel.make_groups(clip)[0]
        head_seed = cfg.train.seed + d
        head_generator = torch.Generator(device=device).manual_seed(
            head_seed)
        for name, child in model.named_children():
            if name != "detr":
                set_dropout_generator(child, head_generator)
    ddp = None
    if parallel.initialized():
        if parallel.world() > 1:
            set_batchnorm_group(model, torch.distributed.group.WORLD)
        # every buffer is a constant or a BN statistic that each rank
        # updates from the same all-reduced batch statistics, so the ranks
        # agree without rank 0's buffers broadcast before each forward
        ddp = nn.parallel.DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            find_unused_parameters=unused_parameters_expected(cfg.model),
            broadcast_buffers=False)
    return TrainState(model, optimizer, labels, generator, cfg,
                      steps_per_epoch, ddp=ddp,
                      head_generator=head_generator, head_seed=head_seed)


def _f32(out):
    """The criterion's inputs cast to f32 (``engine.py:148-152``): the
    predictions (with the mask logits), the aux layers' and the two-stage
    encoder's."""
    res = {k: out[k].float() for k in ("pred_logits", "pred_boxes")
           + (("pred_masks",) if "pred_masks" in out else ())}
    if "aux_outputs" in out:
        res["aux_outputs"] = [{k: a[k].float() for k in a}
                              for a in out["aux_outputs"]]
    if "enc_outputs" in out:
        res["enc_outputs"] = {k: v.float()
                              for k, v in out["enc_outputs"].items()}
    return res


def forward(state: TrainState, batch):
    """The forward in train mode: (the outputs cast to f32, the key rows'
    targets), ready for the criterion."""
    model = state.model
    device = next(model.parameters()).device
    images = as_tensor(batch["images"], device)
    if images.dtype != torch.uint8:
        raise TypeError(f"images must be uint8 frames, got {images.dtype}")
    images, mask = normalize_frames(images,
                                    as_tensor(batch["sizes"], device))
    m = state.cfg.model
    # batch rows per prediction: the clip's frames, key frame first
    F = 1 if m.temporal_mode == "none" else 1 + m.num_ref_frames
    targets = {}
    for k in ("labels", "boxes", "valid") + (
            ("masks",) if "masks" in batch else ()):
        x = as_tensor(batch[k], device)
        targets[k] = x.reshape(x.shape[0] // F, F, *x.shape[1:])[:, 0]
    net = state.ddp if state.ddp is not None else model
    net.train()
    bf16 = state.cfg.train.train_dtype == "bfloat16"
    with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
        out = net(images, mask)
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
    ``grad_norm`` is the global norm before clipping. Under data
    parallelism each is the mean over the ranks (the global batch's).
    The step is the span ``train.step`` with the children
    ``train.forward``, ``train.criterion``, ``train.backward`` and
    ``train.update`` (``utils/trace.py``)."""
    with span("train.step"):
        state.optimizer.zero_grad(set_to_none=True)
        with span("train.forward"):
            out, targets = forward(state, batch)
        with span("train.criterion"):
            loss, parts = criterion(out, targets)
        with span("train.backward"):
            loss.backward()
        with span("train.update"):
            grad_norm = apply_gradients(state)
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        metrics.update({k: v.detach() for k, v in parts.items()})
        return parallel.reduce_mean(metrics)
