"""Model factory (counterpart of ``dfvod_tpu/models/__init__.py``):
``build_model(cfg, device, seed)`` -> (model, criterion, postprocess), the
single-frame ``DeformableDETR`` or, by ``cfg.model.temporal_mode``, the
TransVOD / TransVOD++ ``TemporalDeformableDETR``."""
from __future__ import annotations

import torch
from torch import nn

from dfvod_tpu_torch.models.criterion import SetCriterion
from dfvod_tpu_torch.models.detr import DeformableDETR
from dfvod_tpu_torch.models.postprocess import postprocess
from dfvod_tpu_torch.models.temporal import TemporalDeformableDETR
from dfvod_tpu_torch.models.transformer import DeformableTransformer
from dfvod_tpu_torch.utils.config import Config
from dfvod_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator):
    """Draw every random parameter from ``generator``, with the JAX
    package's initializer kinds: xavier-uniform for Linear and the biased
    convs, he-normal for the bias-free ResNet convs, N(0, 1) for the level
    and query embeddings, zero biases. Values that define the model (zero
    kernels, the ring and prior biases) are kept."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            if not getattr(m, "keep_init", False):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if not getattr(m, "keep_bias", False):
                    m.bias.zero_()
        elif isinstance(m, nn.Conv2d):
            if m.bias is None:
                nn.init.kaiming_normal_(m.weight, mode="fan_in",
                                        nonlinearity="relu",
                                        generator=generator)
            else:
                nn.init.xavier_uniform_(m.weight, generator=generator)
                m.bias.zero_()
        elif isinstance(m, DeformableTransformer):
            m.level_embed.normal_(generator=generator)
            if not m.two_stage:
                m.query_embed.normal_(generator=generator)


def build_model(cfg: Config, device=None, seed: int = 0):
    """(model, criterion, postprocess): the model in eval mode on
    ``device`` (the card unless the caller passes one) with random weights
    drawn from ``seed``, the ``SetCriterion`` of ``cfg.loss``, and
    postprocess. Raises when CUDA is absent and no device was asked for."""
    device = resolve_device(device)
    if cfg.model.temporal_mode == "none":
        model = DeformableDETR(cfg.model)
    else:
        model = TemporalDeformableDETR(cfg.model)
    init_parameters(model, torch.Generator().manual_seed(seed))
    criterion = SetCriterion(cfg.model.num_classes, cfg.loss,
                             dec_layers=cfg.model.dec_layers)
    return model.eval().to(device), criterion, postprocess
