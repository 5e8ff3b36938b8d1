"""Integrated-gradients input attribution, counterpart of
``dfvod_tpu/utils/attribution.py``: the reference's dormant captum hooks
(``inference.py:896-905``: ``IntegratedGradients(model).attribute(img,
baseline=0, n_steps=50, return_convergence_delta=True)``) and its 2x2
RGB / depth figure (``inference.py:972-1026``).

The JAX package scans ``jax.grad`` steps inside one jit region; here the
path integral is a plain loop of ``torch.autograd.grad``, one step at a
time, so the model's kernels run forward and backward at every step.
matplotlib is imported only by the figure.
"""
from __future__ import annotations

import numpy as np
import torch


def integrated_gradients(score_fn, x, baseline=None, n_steps: int = 50):
    """IG along the straight-line path baseline -> x (midpoint rule).

    Args:
      score_fn: differentiable scalar function of ``x`` (e.g. the summed
        hand-class probability of the detections).
      x: input tensor of any shape (e.g. (H, W, 4) RGB-D), on the device
        the model runs on.
      baseline: same-shape start point; zeros when None (the reference's
        ``torch.zeros_like(img2)``).
      n_steps: path-integral resolution (reference: 50).

    Returns ``(attribution, delta)``: attribution (f32, ``x``'s shape)
    sums approximately to ``score_fn(x) - score_fn(baseline)``
    (completeness); ``delta`` (a 0-d f32 tensor) is that residual.
    """
    x = torch.as_tensor(x).detach()
    baseline = (torch.zeros_like(x) if baseline is None
                else torch.as_tensor(baseline, device=x.device).detach())
    alphas = (torch.arange(n_steps, dtype=x.dtype, device=x.device)
              + 0.5) / n_steps
    total = torch.zeros_like(x, dtype=torch.float32)
    with torch.enable_grad():
        for a in alphas:
            z = (baseline + a * (x - baseline)).requires_grad_(True)
            grad, = torch.autograd.grad(score_fn(z).float(), z)
            total += grad
    attribution = (x - baseline).float() * total / n_steps
    with torch.no_grad():
        delta = (score_fn(x) - score_fn(baseline)
                 - attribution.sum()).float()
    return attribution, delta


def _minmax(a):
    lo, hi = float(np.min(a)), float(np.max(a))
    return (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)


def visualize_integrated_gradients(img: np.ndarray,
                                   attribution: np.ndarray,
                                   path: str = "integrated_gradients.png"):
    """2x2 figure: RGB / RGB attributions / depth / depth attribution
    (``inference.py:972-1026``). ``img``/``attribution``: (H, W, 4)
    channels-last RGB-D arrays (or CPU tensors)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img, attribution = np.asarray(img), np.asarray(attribution)
    assert img.shape == attribution.shape, (img.shape, attribution.shape)
    img = _minmax(img.astype(np.float32))
    attribution = _minmax(attribution.astype(np.float32))

    fig, axs = plt.subplots(2, 2, figsize=(10, 6))
    axs[0, 0].imshow(img[..., :3])
    axs[0, 0].set_title("RGB Channels")
    axs[0, 1].imshow(attribution[..., :3])
    axs[0, 1].set_title("RGB Attributions")
    axs[1, 0].imshow(img[..., 3], cmap="gray")
    axs[1, 0].set_title("Depth Channel")
    depth_im = axs[1, 1].imshow(attribution[..., 3])
    axs[1, 1].set_title("Depth Attribution")
    for ax in axs.ravel():
        ax.axis("off")
    fig.colorbar(depth_im, ax=axs, orientation="vertical", fraction=0.05,
                 pad=0.01, shrink=0.5).set_label("Attribution Intensity")
    fig.savefig(path)
    plt.close(fig)
    return path
