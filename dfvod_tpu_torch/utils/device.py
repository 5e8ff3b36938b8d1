"""Device choice for the port's entry points, and their host inputs."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``. With none given, the card: raises
    when CUDA is absent rather than carrying on on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "port on the CPU")
    return torch.device("cuda")


def as_tensor(x, device) -> torch.Tensor:
    """A tensor or an array-like (numpy, lists) as a tensor on ``device``."""
    return (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
            ).to(device)
