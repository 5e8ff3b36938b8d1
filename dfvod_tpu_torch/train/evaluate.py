"""Evaluation: forward, postprocess and COCO mAP (counterpart of
``dfvod_tpu/train/evaluate.py`` and ``make_eval_step`` in
``dfvod_tpu/train/engine.py``).

Parity target: ``engine_single.py:81-165`` / ``engine_multi.py:83-166`` of
the reference: the model's forward, the top-100 postprocess, a COCO
evaluator update per batch, the cross-process merge, accumulate and
summarize.

A batch is the train step's contract plus two keys: ``images`` uint8
``(B, H, W, C)`` padded bottom/right, ``sizes`` ``(B, 2)`` content (h, w),
``orig_size`` ``(B, 2)`` the original image's (h, w), and ``image_id``
``(B,)``. For a TransVOD / TransVOD++ model the rows are whole clips of
``frames`` frames, key frame first, and the key rows' ids and sizes are
read.

Under data parallelism each process evaluates its own shard of the images
(the loader's ``rank`` / ``world``) and the evaluators merge before the
summary, so every process returns the stats of the whole set, those of
one process.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from dfvod_tpu_torch.data.coco_eval import COCOEvaluator
from dfvod_tpu_torch.data.device_pipeline import normalize_frames
from dfvod_tpu_torch.models.postprocess import postprocess
from dfvod_tpu_torch.utils.device import as_tensor


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@torch.no_grad()
def eval_forward(model, images_u8, sizes):
    """(pred_logits, pred_boxes) of ``model`` in ``eval()`` mode on uint8
    frames and their content sizes: ``normalize_frames`` on the model's
    device, then the forward in the model's own dtype (an f32 model runs
    f32, as the JAX package's eval applies its f32 training variables with
    no autocast)."""
    param = next(model.parameters())
    images, mask = normalize_frames(as_tensor(images_u8, param.device),
                                    as_tensor(sizes, param.device))
    out = model.eval()(images.to(param.dtype), mask)
    return out["pred_logits"], out["pred_boxes"]


def evaluate(model, loader, coco_gt, *, frames: int = 1, top_k: int = 100,
             print_freq: int = 10) -> Dict[str, float]:
    """COCO bbox mAP of ``model`` over the batches of ``loader`` against
    ``coco_gt`` (a ``data.coco.COCO``). Detections are scaled to each
    image's original size (``orig_size``, not the content size ``Server``
    uses). An id seen before adds nothing, so a last batch padded with
    repeated ids counts once. Returns the six ``summarize`` stats."""
    evaluator = COCOEvaluator(coco_gt)

    def key_rows(x):
        x = _host(x)
        return x if frames == 1 else x.reshape(
            x.shape[0] // frames, frames, *x.shape[1:])[:, 0]

    t0 = time.perf_counter()
    for i, batch in enumerate(loader):
        logits, boxes = eval_forward(model, batch["images"], batch["sizes"])
        orig = key_rows(batch["orig_size"]).astype(np.float32)
        ids = key_rows(batch["image_id"])
        res = postprocess(logits.float(), boxes.float(),
                          torch.from_numpy(orig), top_k=top_k)
        res = {k: v.cpu().numpy() for k, v in res.items()}
        evaluator.update({int(img_id): {"scores": res["scores"][b],
                                        "labels": res["labels"][b],
                                        "boxes": res["boxes"][b]}
                          for b, img_id in enumerate(ids[:logits.shape[0]])})
        if print_freq and i % print_freq == 0:
            print(f"Eval: [{i}] {time.perf_counter() - t0:.1f} s",
                  flush=True)

    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    return evaluator.summarize()
