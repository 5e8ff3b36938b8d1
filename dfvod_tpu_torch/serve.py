"""Serving entry point: uint8 RGB-D frames in, detections out.

The counterpart of ``dfvod_tpu/cli/inference.py::DeformableDETRInference``
without file IO. Each request runs ``normalize_frames`` -> the model ->
``postprocess``. In serving mode (``dtype=torch.bfloat16``, the default)
every float parameter and buffer is cast to bf16 and the model is fed a
bf16 image, as the JAX package's bench does.

With ``temporal_mode`` ``"transvod"`` or ``"transvod_pp"`` a request is
whole clips: ``B`` clips of ``F = 1 + num_ref_frames`` frames each,
contiguous, frame order ``[key, ref_1, ..., ref_N]``, and the detections
are the key frames'.

Clip-parallel serving of a TransVOD / TransVOD++ model (``group``, a
process group of more than one rank; the JAX package's
``clip_batch_sharding`` over its mesh): every rank is given the whole
request, runs the trunk on its contiguous rows of the frames, and gathers
what the heads read (``models/temporal.py``); a request whose frames do
not divide over the ranks raises, as the JAX sharding does. Every rank
returns the same detections.

Each call is the span ``serve.request`` with the children
``serve.normalize``, ``serve.model`` and ``serve.postprocess``
(``utils/trace.py``).
"""
from __future__ import annotations

import torch

from dfvod_tpu_torch.data.device_pipeline import normalize_frames
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.parallel.dist import world
from dfvod_tpu_torch.utils.config import Config
from dfvod_tpu_torch.utils.convert import load_jax_variables
from dfvod_tpu_torch.utils.device import as_tensor
from dfvod_tpu_torch.utils.trace import span


class Server:
    """``Server(cfg)(images_u8, sizes)`` -> the top-100 {scores, labels,
    boxes}.

    cfg: ``utils.config.Config``. variables: flax variables of the JAX
    model as nested dicts of numpy arrays (``utils/convert.py``), or None
    for random weights drawn from ``seed``. device: the card unless the
    caller passes one; raises when CUDA is absent and none was asked for.
    group: a process group for clip-parallel serving of a temporal model,
    or None.
    """

    def __init__(self, cfg: Config, variables=None, device=None,
                 dtype=torch.bfloat16, seed: int = 0, group=None):
        self.cfg = cfg
        self.dtype = dtype
        m = cfg.model
        # frames per clip; 1 for the single-frame model
        self.frames = 1 if m.temporal_mode == "none" else 1 + m.num_ref_frames
        if group is not None and world(group) > 1 and self.frames == 1:
            raise ValueError("clip-parallel serving splits a clip's frames "
                             "over the ranks: a single-frame model has "
                             "none (serve it in one process per card)")
        model, _, self.postprocess = build_model(cfg, device, seed)
        if variables is not None:
            load_jax_variables(model, variables)
        self.device = next(model.parameters()).device
        self.model = model.to(dtype=dtype,
                              memory_format=torch.channels_last)
        if self.frames > 1:
            self.model.trunk_group = group

    @torch.no_grad()
    def forward(self, images_u8, sizes):
        """The model's output dict for one request (see ``__call__``)."""
        with span("serve.normalize"):
            images_u8 = as_tensor(images_u8, self.device)
            sizes = as_tensor(sizes, self.device)
            if images_u8.dtype != torch.uint8 or images_u8.dim() != 4:
                raise ValueError("images must be uint8 (B, H, W, C)")
            if images_u8.shape[0] % self.frames:
                raise ValueError(f"{images_u8.shape[0]} frames are not "
                                 f"whole clips of {self.frames}")
            if sizes.shape != (images_u8.shape[0], 2):
                raise ValueError(f"sizes must be ({images_u8.shape[0]}, 2), "
                                 f"not {tuple(sizes.shape)}")
            img, mask = normalize_frames(images_u8, sizes)
        with span("serve.model"):
            return self.model(img.to(self.dtype), mask)

    def __call__(self, images_u8, sizes):
        """images_u8: (B*F, H, W, C) uint8 frames padded bottom/right, F
        frames per clip (F = 1 for the single-frame model); sizes: (B*F, 2)
        content (h, w). Returns scores (B, k), labels (B, k) and boxes
        (B, k, 4) as xyxy pixels of the (key) frame's content."""
        with span("serve.request"):
            out = self.forward(images_u8, sizes)
            with span("serve.postprocess"):
                key_sizes = as_tensor(sizes, self.device)[::self.frames]
                return self.postprocess(out["pred_logits"],
                                        out["pred_boxes"], key_sizes)
