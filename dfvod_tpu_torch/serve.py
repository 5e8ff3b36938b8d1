"""Serving entry point: uint8 RGB-D frames in, detections out.

The counterpart of ``dfvod_tpu/cli/inference.py::DeformableDETRInference``
without file IO. Each request runs ``device_normalize`` -> the model ->
``postprocess``. In serving mode (``dtype=torch.bfloat16``, the default)
every float parameter and buffer is cast to bf16 and the model is fed a
bf16 image, as the JAX package's bench does.
"""
from __future__ import annotations

import numpy as np
import torch

from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.utils.config import Config
from dfvod_tpu_torch.utils.convert import load_jax_variables


class Server:
    """``Server(cfg)(images_u8, sizes)`` -> the top-100 {scores, labels,
    boxes}.

    cfg: ``utils.config.Config``. variables: flax variables of the JAX
    model as nested dicts of numpy arrays (``utils/convert.py``), or None
    for random weights drawn from ``seed``. device: the card unless the
    caller passes one; raises when CUDA is absent and none was asked for.
    """

    def __init__(self, cfg: Config, variables=None, device=None,
                 dtype=torch.bfloat16, seed: int = 0):
        self.cfg = cfg
        self.dtype = dtype
        model, _, self.postprocess = build_model(cfg, device, seed)
        if variables is not None:
            load_jax_variables(model, variables)
        self.device = next(model.parameters()).device
        self.model = model.to(dtype=dtype,
                              memory_format=torch.channels_last)

    @torch.no_grad()
    def forward(self, images_u8, sizes):
        """The model's output dict for one request (see ``__call__``)."""
        images_u8 = _as_tensor(images_u8, self.device)
        if images_u8.dtype != torch.uint8 or images_u8.dim() != 4:
            raise ValueError("images must be uint8 (B, H, W, C)")
        img, mask = device_normalize(images_u8,
                                     _as_tensor(sizes, self.device))
        return self.model(img.to(self.dtype), mask)

    def __call__(self, images_u8, sizes):
        """images_u8: (B, H, W, C) uint8 frames padded bottom/right;
        sizes: (B, 2) content (h, w). Returns scores (B, k), labels (B, k)
        and boxes (B, k, 4) as xyxy pixels of the content frame."""
        out = self.forward(images_u8, sizes)
        return self.postprocess(out["pred_logits"], out["pred_boxes"],
                                _as_tensor(sizes, self.device))


def _as_tensor(x, device):
    return (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            ).to(device)
