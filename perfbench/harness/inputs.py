"""Inputs made from the run's seed: pools of uint8 RGB-D frames and, for
training, padded box targets.

Frames are smooth random fields (noise at 1/16 of the size, upsampled
bilinearly, plus pixel noise), so that convolutions and sampling see
structure, made on the device in a few calls and kept in pinned host
memory. Every request copies its batch to the card, as a camera's decoded
frames are. The content sizes come from the mix's list, each frame taking
them in turn from a seeded offset: every seed has the same sizes, in
another order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 16


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one stream of draws (weights, frames, targets) of a run."""
    return (int(seed) * 1_000_003 + stream) % (2 ** 63)


def frames(n, height, width, content_sizes, seed, device, pin=True):
    """(n, H, W, 4) uint8 frames padded bottom/right to (H, W), and their
    (n, 2) content sizes. The draws are made whole, and the frames from
    them ``CHUNK`` at a time, so that the device holds one float copy of
    the pool (its pixel noise) beside the frames, not three."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    low = torch.rand((n, 4, max(height // 16, 1), max(width // 16, 1)),
                     generator=gen, device=device)
    noise = torch.rand((n, 4, height, width), generator=gen, device=device)
    start = int(torch.randint(len(content_sizes), (1,), generator=gen,
                              device=device))
    sizes = torch.tensor([content_sizes[(start + i) % len(content_sizes)]
                          for i in range(n)], dtype=torch.int64)
    h = torch.arange(height, device=device)[None, :, None]
    w = torch.arange(width, device=device)[None, None, :]
    sz = sizes.to(device)
    x = torch.empty((n, height, width, 4), dtype=torch.uint8, device=device)
    for i in range(0, n, CHUNK):
        c = slice(i, i + CHUNK)
        f = F.interpolate(low[c], size=(height, width), mode="bilinear",
                          align_corners=False) + 0.1 * noise[c]
        f = (f.clamp(0, 1) * 255).to(torch.uint8).permute(0, 2, 3, 1)
        pad = (h >= sz[c, 0, None, None]) | (w >= sz[c, 1, None, None])
        x[c] = f.masked_fill(pad[..., None], 0)
    del noise
    if device != "cpu" and torch.device(device).type == "cuda":
        x = x.cpu()
        if pin:
            x = x.pin_memory()
    return x, sizes


def targets(n, slots, min_boxes, max_boxes, seed, device="cpu",
            label_classes=None):
    """labels (n, T), drawn uniformly from ``label_classes`` (by default
    {0, 1}), normalized cxcywh boxes (n, T, 4) and valid (n, T), with
    ``min_boxes``..``max_boxes`` valid slots a frame."""
    gen = torch.Generator().manual_seed(sub_seed(seed, 2))
    count = torch.randint(min_boxes, max_boxes + 1, (n,), generator=gen)
    valid = torch.arange(slots)[None] < count[:, None]
    classes = torch.tensor(label_classes or (0, 1), dtype=torch.int64)
    labels = classes[torch.randint(0, len(classes), (n, slots),
                                   generator=gen)] * valid
    cxcy = torch.rand((n, slots, 2), generator=gen) * 0.6 + 0.2
    wh = torch.rand((n, slots, 2), generator=gen) * 0.3 + 0.05
    boxes = torch.cat([cxcy, wh], -1) * valid[..., None]
    return {"labels": labels.to(device), "boxes": boxes.to(device),
            "valid": valid.to(device)}


def pool(traffic, seed, device, kind):
    """The mix's pool of distinct batches: a list of dicts with ``images``
    (pinned host uint8) and ``sizes``, and, where ``kind`` (the ``KIND``
    of the mix's loop) is ``train``, the targets (labels from the mix's
    ``label_classes`` where it gives them)."""
    n = traffic["frames_per_request"]
    P = traffic["pool"]
    imgs, sizes = frames(n * P, traffic["height"], traffic["width"],
                         [tuple(s) for s in traffic["content_sizes"]],
                         seed, device)
    out = []
    tg = None
    if kind == "train":
        tg = targets(n * P, traffic["target_slots"], traffic["min_boxes"],
                     traffic["max_boxes"], seed,
                     label_classes=traffic.get("label_classes"))
    for i in range(P):
        b = {"images": imgs[i * n:(i + 1) * n],
             "sizes": sizes[i * n:(i + 1) * n]}
        if tg is not None:
            b.update({k: v[i * n:(i + 1) * n] for k, v in tg.items()})
        out.append(b)
    return out
