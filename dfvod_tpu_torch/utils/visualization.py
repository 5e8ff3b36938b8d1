"""Visualization and debug plots, counterpart of
``dfvod_tpu/utils/visualization.py``: the reference's
``supporting_files/visualization_functions.py`` (feature maps, reference
points, sampling locations, attention maps, queries, position
embeddings) and ``util/plot_utils.py`` (training-log curves). Inputs are
numpy arrays (``tensor.detach().cpu().numpy()``). matplotlib is imported
only when a plot is drawn (the card machine has none), and
``visualize_attention_map`` resizes with PIL, which matplotlib requires.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def visualize_feature_map(feat: np.ndarray, path: str,
                          max_channels: int = 16):
    """feat: (H, W, C) — grid of per-channel heatmaps
    (``visualization_functions.py`` feature-map plots)."""
    plt = _plt()
    C = min(feat.shape[-1], max_channels)
    cols = 4
    rows = -(-C // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
    for i, ax in enumerate(np.atleast_1d(axes).ravel()):
        if i < C:
            ax.imshow(feat[..., i], cmap="viridis")
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def visualize_reference_points(ref_points: np.ndarray, hw, path: str):
    """ref_points: (S, 2) normalized xy (``visualize_reference_points``)."""
    plt = _plt()
    H, W = hw
    fig, ax = plt.subplots(figsize=(6, 6 * H / W))
    ax.scatter(ref_points[:, 0] * W, ref_points[:, 1] * H, s=1)
    ax.set_xlim(0, W)
    ax.set_ylim(H, 0)
    fig.savefig(path)
    plt.close(fig)


def visualize_sampling_locations(image: np.ndarray, locations: np.ndarray,
                                 weights: Optional[np.ndarray], path: str,
                                 query: int = 0):
    """locations: (Lq, M, L, P, 2) normalized; draws one query's sampling
    points over the image, size ~ attention weight
    (``visualize_sampling_locations``)."""
    plt = _plt()
    H, W = image.shape[:2]
    fig, ax = plt.subplots(figsize=(8, 8 * H / W))
    ax.imshow(image)
    pts = locations[query].reshape(-1, 2)
    w = (weights[query].reshape(-1) if weights is not None
         else np.ones(len(pts)))
    ax.scatter(pts[:, 0] * W, pts[:, 1] * H, s=200 * w + 2, c="red",
               alpha=0.6)
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def visualize_attention_map(image: np.ndarray, attn: np.ndarray, path: str):
    """attn: (H', W') map overlaid on the image
    (``visualize_attention_map``, ``visualization_functions.py:235``)."""
    plt = _plt()
    H, W = image.shape[:2]
    from PIL import Image as PILImage
    up = np.array(PILImage.fromarray(
        (255 * (attn - attn.min()) / max(float(np.ptp(attn)), 1e-9)
         ).astype(np.uint8)).resize((W, H)))
    fig, ax = plt.subplots(figsize=(8, 8 * H / W))
    ax.imshow(image)
    ax.imshow(up, cmap="jet", alpha=0.5)
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def plot_logs(log_dirs: Sequence[str], fields=("train_loss",),
              path: str = "logs.png"):
    """Training-curve plots from ``log.txt`` JSON lines
    (``util/plot_utils.py:plot_logs``)."""
    plt = _plt()
    fig, axes = plt.subplots(1, len(fields),
                             figsize=(5 * len(fields), 4), squeeze=False)
    for d in log_dirs:
        with open(os.path.join(d, "log.txt")) as f:
            rows = [json.loads(ln) for ln in f if ln.strip()]
        rows = [r for r in rows if "epoch" in r]
        for ax, field in zip(axes[0], fields):
            xs = [r["epoch"] for r in rows if field in r]
            ys = [r[field] for r in rows if field in r]
            ax.plot(xs, ys, label=os.path.basename(d.rstrip("/")))
            ax.set_title(field)
            ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def visualize_queries(queries: np.ndarray, path: str):
    """Object-query content heatmaps. 1-D input -> a single (1, C) strip
    (``visualize_single_query``, ``visualization_functions.py:160``);
    2-D (Nq, C) input -> a sqrt grid of per-query strips
    (``visualize_queries_2d``, ``:190``)."""
    plt = _plt()
    q = np.asarray(queries)
    if q.ndim == 1:
        fig, ax = plt.subplots(figsize=(10, 1.2))
        im = ax.imshow(q[None, :], aspect="auto", cmap="viridis")
        fig.colorbar(im, ax=ax)
        ax.set_yticks([])
        ax.set_xlabel("dimension")
    else:
        n = len(q)
        cols = max(int(np.sqrt(n)), 1)
        rows = -(-n // cols)
        fig, axes = plt.subplots(rows, cols,
                                 figsize=(min(20, 2 * cols),
                                          min(20, 0.6 * rows)),
                                 squeeze=False)
        flat = axes.ravel()
        for i in range(len(flat)):
            flat[i].axis("off")
            if i < n:
                flat[i].imshow(q[i][None, :], aspect="auto",
                               cmap="viridis")
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def visualize_position_embeddings(pos: np.ndarray, path: str,
                                  num_channels: int = 16):
    """Per-channel 2-D heatmaps of a (H, W, C) position embedding
    (``visualize_position_embeddings``,
    ``visualization_functions.py:423``; the 3-D surface variant is
    collapsed into the same heatmap grid)."""
    plt = _plt()
    pos = np.asarray(pos)
    C = pos.shape[-1]
    # spread picks across the channel range so both the sin and cos
    # halves of the embedding show up
    picks = np.linspace(0, C - 1, min(num_channels, C)).astype(int)
    cols = 4
    rows = -(-len(picks) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3.5 * cols, 3 * rows),
                             squeeze=False)
    for ax, c in zip(axes.ravel(), picks):
        im = ax.imshow(pos[:, :, c], cmap="viridis")
        ax.set_title(f"ch {c}", fontsize=8)
        ax.set_xticks([]); ax.set_yticks([])
    for ax in axes.ravel()[len(picks):]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def visualize_attention_points(feature_map: np.ndarray,
                               locations: np.ndarray,
                               weights: np.ndarray, path: str,
                               query: int = 0, level: int = 0):
    """Per-level, per-head sampling points over one feature-map level,
    marker per head, size/color by attention weight
    (``visualize_attention_map``/``visualize_combined``,
    ``visualization_functions.py:235,313``).

    feature_map: (H, W) single-channel level map; locations:
    (Lq, M, L, P, 2) normalized; weights: (Lq, M, L, P)."""
    plt = _plt()
    H, W = feature_map.shape
    locs = np.array(locations[query, :, level], copy=True)   # (M, P, 2)
    wts = np.asarray(weights[query, :, level])               # (M, P)
    fig, ax = plt.subplots(figsize=(10, 10 * H / W))
    ax.imshow(feature_map, cmap="viridis")
    markers = "osD^v<>p*hH+xd"
    for head in range(locs.shape[0]):
        xy = locs[head] * [W, H]
        ok = ((xy[:, 0] >= 0) & (xy[:, 0] < W) &
              (xy[:, 1] >= 0) & (xy[:, 1] < H))
        ax.scatter(xy[ok, 0], xy[ok, 1], c=wts[head][ok], cmap="YlOrRd",
                   vmin=0, vmax=max(float(wts.max()), 1e-9),
                   marker=markers[head % len(markers)],
                   s=40 + 300 * wts[head][ok], edgecolors="k",
                   linewidths=0.4, label=f"head {head}")
    ax.legend(fontsize=7, loc="upper right")
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
