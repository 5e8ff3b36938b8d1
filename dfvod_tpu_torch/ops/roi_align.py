"""RoIAlign, channels-last (counterpart of ``dfvod_tpu/ops/roi_align.py``):
mmcv's ``RoIAlign(output_size=7, sampling_ratio=2, aligned=True)`` as
TransVOD++'s Query-RoI Fusion uses it.

One formulation on every device, that of ``_roi_align_hat``
(``dfvod_tpu/ops/roi_align.py:70-97``): each output bin is one query whose
``sr * sr`` sample points are the kernel's points at weight ``1 / sr**2``,
so the bin average happens inside the sampling. The sample coordinates are
pre-clamped to the map, as mmcv clamps at the border, and points beyond
``[-1, H]`` (resp. ``W``) get weight 0. ``ops/hat_sample.py`` samples them:
its plain version on the CPU (autograd differentiates it), K3 on the card,
where the features' gradient goes through K4, the kernel's backward.

Semantics (mmcv/detectron2 ``aligned=True``): box coordinates scaled by
``spatial_scale`` and shifted by -0.5; each of the ``P x P`` bins sampled at
``sampling_ratio**2`` regularly spaced points. Boxes are detached, as in
``dfvod_tpu/ops/roi_align.py:122-125``: mmcv's RoIAlign has no box
gradient, so the sample points and weights carry none and K4 computes only
the features' gradient.
"""
from __future__ import annotations

import torch

from dfvod_tpu_torch.ops.hat_sample import hat_sample


def roi_align(features, boxes, *, output_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              aligned: bool = True):
    """features: (B, H, W, C); boxes: (B, R, 4) xyxy in image coordinates,
    each RoI pooling from its own batch element. Returns
    (B, R, output_size, output_size, C) in the features' dtype."""
    B, H, W, C = features.shape
    P = output_size
    px, py, aw = roi_sample_points(boxes, H, W, output_size=P,
                                   spatial_scale=spatial_scale,
                                   sampling_ratio=sampling_ratio,
                                   aligned=aligned)
    out = hat_sample(features.contiguous(), px, py, aw)
    return out.reshape(B, boxes.shape[1], P, P, C)


def roi_sample_points(boxes, H: int, W: int, *, output_size: int = 7,
                      spatial_scale: float = 1.0, sampling_ratio: int = 2,
                      aligned: bool = True):
    """The ``hat_sample`` points of RoIAlign on an (H, W) map: px, py, aw
    of shape (B, R * P * P, sr * sr), f32, contiguous, bins in row-major
    (bin_y, bin_x) order."""
    B, R = boxes.shape[:2]
    P, sr = output_size, sampling_ratio
    G = P * sr
    offset = 0.5 if aligned else 0.0

    b = boxes.detach().float() * spatial_scale - offset
    x1, y1, x2, y2 = b.unbind(-1)
    floor_w = 1e-6 if aligned else 1.0
    bin_w = torch.clamp(x2 - x1, min=floor_w)[..., None] / P   # (B, R, 1)
    bin_h = torch.clamp(y2 - y1, min=floor_w)[..., None] / P
    frac = (torch.arange(G, dtype=torch.float32, device=b.device)
            + 0.5) / sr                                        # (G,)
    xs = x1[..., None] + frac * bin_w                          # (B, R, G)
    ys = y1[..., None] + frac * bin_h

    # all (y, x) sample pairs: (B, R, G, G); the out-of-bounds test runs on
    # the unclamped coordinates
    yy = ys[..., :, None]
    xx = xs[..., None, :]
    oob = (yy < -1.0) | (yy > H) | (xx < -1.0) | (xx > W)
    ycl = torch.clamp(yy, 0.0, H - 1).expand(B, R, G, G)
    xcl = torch.clamp(xx, 0.0, W - 1).expand(B, R, G, G)
    aw = (~oob).to(torch.float32) / (sr * sr)

    def to_bins(a):
        """(G, G) = (bin_y, sub_y, bin_x, sub_x) -> (bin_y, bin_x, sub_y,
        sub_x), flattened to (B, R * P * P, sr * sr)."""
        a = a.reshape(B, R, P, sr, P, sr).permute(0, 1, 2, 4, 3, 5)
        return a.reshape(B, R * P * P, sr * sr).contiguous()

    return to_bins(xcl), to_bins(ycl), to_bins(aw)
