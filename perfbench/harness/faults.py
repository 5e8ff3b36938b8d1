"""Faults planted underneath the timed path, for the checks' own tests
and for reading each fault's numbers at a cell's size. Each takes the
program as ``cell.run`` builds it and breaks it in place."""
from __future__ import annotations

import torch


def serve_altered_answer(prog):
    """One detection's box moved by 8 pixels where it is produced."""
    post = prog.server.postprocess

    def altered(*args, **kwargs):
        out = post(*args, **kwargs)
        out["boxes"][0, 0] += 8.0
        return out
    prog.server.postprocess = altered


def serve_half_batch(prog):
    """The model runs on the first half of the request's clips and hands
    their outputs to the rest."""
    forward = prog.model.forward

    def half(images, mask):
        F = prog.frames
        n = images.shape[0] // F
        k = max(n // 2, 1) * F
        out = forward(images[:k], mask[:k])
        rep = -(-n // (k // F))

        def fill(x):
            if torch.is_tensor(x) and x.dim() and x.shape[0] == k // F:
                return x.repeat(rep, *[1] * (x.dim() - 1))[:n]
            if isinstance(x, dict):
                return {a: fill(b) for a, b in x.items()}
            if isinstance(x, list):
                return [fill(b) for b in x]
            return x
        return fill(out)
    prog.model.forward = half


def serve_decoder_layer_dropped(prog):
    """The trunk's middle decoder layer hands its input on unchanged."""
    detr = prog.model.detr if hasattr(prog.model, "detr") else prog.model
    t = detr.transformer
    layer = getattr(t, f"decoder_layers_{t.num_decoder_layers // 2}")
    layer.forward = lambda tgt, *a, **k: tgt


def serve_temporal_skipped(prog):
    """The answer is the trunk's key-frame outputs: the temporal head's
    rounds are left out (clips only)."""
    forward = prog.model.forward

    def skipped(images, mask):
        out = forward(images, mask)
        return {**out, **out["_single_frame"]}
    prog.model.forward = skipped


def train_half_batch(prog):
    """Every step sees the first half of its rows; the loss is the mean
    over them."""
    call = prog.__class__.__call__

    def half(self, batch):
        n = batch["images"].shape[0] // 2
        return call(self, {k: v[:n] for k, v in batch.items()})
    prog.__class__ = type("HalfBatch", (prog.__class__,),
                          {"__call__": half})


def train_unchanged(prog):
    """The optimizer's step leaves the parameters as they are."""
    prog.state.optimizer.step = lambda *a, **k: None


FAULTS = {"serve": {"altered_answer": serve_altered_answer,
                    "half_batch": serve_half_batch,
                    "decoder_layer_dropped": serve_decoder_layer_dropped,
                    "temporal_skipped": serve_temporal_skipped},
          "train": {"half_batch": train_half_batch,
                    "unchanged": train_unchanged}}
