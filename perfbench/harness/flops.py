"""Operations and bytes of a cell, counted from its shapes.

Model FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the cell's
plain reference (its ``build``) run on the ``meta`` device at the cell's
batch and frame size (forward, or forward and backward of the trainable
parameters for a train step), plus an analytic count of what the counter
does not see: the bilinear sampling of deformable attention and of
RoIAlign. The count does not depend on how the port implements the model,
so a later change that removes a kernel still faces the same yardstick.

The deformable-attention calls and their shapes are read from the same
meta run (a pre-hook on each of the reference's ``MSDeformAttn``; the
RoIAlign samples from its ``roi_align``, where it has one), and give K1's
and K2's roofline bounds by the rule of the port's kernel table: the
least time is max(bytes / HBM bandwidth, operations / peak), each input
read once and each output written once.
"""
from __future__ import annotations

import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM5 80 GB, published dense peaks at its 700 W limit
PEAKS = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}

# FLOPs a sampled point costs per channel: 4 corners x (multiply + add),
# plus the attention weight's multiply and the sum; the backward scatters
# the value gradient (4 x 2), forms the location gradient (4 x 2) and the
# weight gradient (2)
MSDA_FWD_FLOPS = 10
MSDA_BWD_FLOPS = 18


class _NoModules:
    """Stands in for ``FlopCounterMode``'s module tracker, whose backward
    hooks fail on the meta device: every count goes to "Global"."""
    parents = {"Global"}
    is_bw = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


def flop_counter():
    fc = FlopCounterMode(display=False)
    fc.mod_tracker = _NoModules()
    return fc


class MSDACall:
    def __init__(self, B, Lq, S, M, L, P, D):
        self.B, self.Lq, self.S = B, Lq, S
        self.M, self.L, self.P, self.D = M, L, P, D

    @property
    def points(self):
        return self.B * self.Lq * self.M * self.L * self.P

    def fwd_flops(self):
        return self.points * self.D * MSDA_FWD_FLOPS

    def fwd_bytes(self, act=2):
        """value and output at ``act`` bytes, f32 locations, weights at
        ``act`` bytes."""
        return (self.B * self.S * self.M * self.D * act
                + self.points * 2 * 4 + self.points * act
                + self.B * self.Lq * self.M * self.D * act)

    def bwd_flops(self):
        return self.points * self.D * MSDA_BWD_FLOPS

    def bwd_bytes(self, act=2):
        """Reads value, locations, weights and the output gradient; writes
        the value, location and weight gradients."""
        return 2 * (self.B * self.S * self.M * self.D * act
                    + self.points * 2 * 4 + self.points * act) \
            + self.B * self.Lq * self.M * self.D * act


def bound_s(flops, nbytes, peak_flops=PEAKS["f32_flops"]):
    return max(nbytes / PEAKS["hbm_bytes"], flops / peak_flops)


def count(model_cfg, frames, height, width, ref, train=False):
    """{"flops": model FLOPs of one call over ``frames`` frames (a train
    step: forward and backward), "msda": [MSDACall, ...] of the forward,
    "roi_flops": RoIAlign's sampling FLOPs} of the reference module
    ``ref`` (the cell's ``reference``). Runs on the meta
    device. A train step's trainable parameters are those that the
    reference's ``group_label`` does not call ``frozen``."""
    calls = []

    def pre(mod, args):
        query, _, value = args[:3]
        calls.append(MSDACall(query.shape[0], query.shape[1], value.shape[1],
                              mod.n_heads, mod.n_levels, mod.n_points,
                              mod.d_model // mod.n_heads))
    with torch.device("meta"):
        m = ref.build(model_cfg)
        msda = getattr(ref, "MSDeformAttn", None)
        for mod in m.modules():
            if msda is not None and isinstance(mod, msda):
                mod.register_forward_pre_hook(pre)
        x = torch.empty(frames, height, width, 4)
        mask = torch.zeros(frames, height, width, dtype=torch.bool)
        roi = {"flops": 0}
        orig = getattr(ref, "roi_align", None)
        # the model calls RoIAlign by the name in the module that defines it
        home = sys.modules[orig.__module__] if orig is not None else None

        def counted_roi(features, boxes, *a, **k):
            B, R = boxes.shape[:2]
            C = features.shape[-1]
            # 7 x 7 bins of 2 x 2 bilinear samples, 4 corners x 2 FLOPs
            roi["flops"] += B * R * 49 * 4 * C * 8
            return orig(features, boxes, *a, **k)
        if home is not None:
            home.roi_align = counted_roi
        try:
            with flop_counter() as fc:
                if train:
                    head = m.detr if hasattr(m, "detr") else m
                    for name, p in head.named_parameters():
                        p.requires_grad_(ref.group_label(name) != "frozen")
                    m.train()
                    out = m(x, mask)
                    loss = sum(o.float().mean() for o in (
                        [out["pred_logits"], out["pred_boxes"]]
                        + [a[k] for a in out["aux_outputs"]
                           for k in ("pred_logits", "pred_boxes")]))
                    loss.backward()
                else:
                    with torch.no_grad():
                        m(x, mask)
        finally:
            if home is not None:
                home.roi_align = orig
    flops = fc.get_total_flops() + roi["flops"]
    flops += sum(c.fwd_flops() for c in calls)
    if train:
        flops += sum(c.bwd_flops() for c in calls)
    return {"flops": float(flops), "msda": calls,
            "roi_flops": float(roi["flops"])}


def msda_fwd_bound_s(calls, act=2):
    return sum(bound_s(c.fwd_flops(), c.fwd_bytes(act)) for c in calls)


def msda_bwd_bound_s(calls, act=2):
    return sum(bound_s(c.bwd_flops(), c.bwd_bytes(act)) for c in calls)

