"""Box utilities (counterpart of ``dfvod_tpu/utils/box_ops.py``)."""
from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(x):
    cx, cy, w, h = x.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def inverse_sigmoid(x, eps: float = 1e-5):
    """Logit with clamping, parity with ``util/misc.py`` inverse_sigmoid."""
    x = x.clamp(0, 1)
    x1 = x.clamp(min=eps)
    x2 = (1 - x).clamp(min=eps)
    return torch.log(x1 / x2)
