"""COCO bbox mAP evaluator: the port's own copy of
``dfvod_tpu/data/coco_eval.py``, plain numpy with pycocotools' semantics
(pycocotools is not a dependency).

It replaces the reference's ``datasets/coco_eval.py``, which wraps
``pycocotools.cocoeval.COCOeval``. The matching rules:

- IoU thresholds 0.5:0.05:0.95, recall grid 0:0.01:1 (101 points);
- greedy per-category matching in detection-score order; a detection may
  move to a better ground truth while unmatched; crowd ground truths take
  leftover detections, which count neither as TP nor as FP;
- ``ignore`` follows the area range; an unmatched detection outside the
  range is ignored, not a FP;
- the precision envelope (running max from the right), then 101-point
  interpolation; -1 where a category has no positives.

The reference merges detections across processes
(``coco_eval.py:63-66``); ``synchronize_between_processes`` does it over
``torch.distributed`` and keeps one copy of each image's detections, as
the reference's ``merge`` (``np.unique`` of the image ids) does. The JAX
package's merge concatenates every process's detections, so an image that
the padded shards give to two processes counts twice there.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {"all": (0.0, 1e10), "small": (0.0, 32.0 ** 2),
            "medium": (32.0 ** 2, 96.0 ** 2), "large": (96.0 ** 2, 1e10)}
MAX_DETS = (1, 10, 100)


def bbox_iou_xywh(dets: np.ndarray, gts: np.ndarray,
                  iscrowd: np.ndarray) -> np.ndarray:
    """IoU between det and gt boxes in xywh. For crowd gts the union is
    the det area alone (pycocotools ``iou`` semantics)."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)))
    dx1, dy1 = dets[:, 0], dets[:, 1]
    dx2, dy2 = dets[:, 0] + dets[:, 2], dets[:, 1] + dets[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    ix = (np.minimum(dx2[:, None], gx2[None]) -
          np.maximum(dx1[:, None], gx1[None])).clip(0)
    iy = (np.minimum(dy2[:, None], gy2[None]) -
          np.maximum(dy1[:, None], gy1[None])).clip(0)
    inter = ix * iy
    d_area = (dets[:, 2] * dets[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area,
                     d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _evaluate_img(dts: List[dict], gts: List[dict], area_rng, max_det: int):
    """Per (image, category, area, maxDet) matching. Returns dict with
    dtScores, dtMatches (T,D), dtIgnore (T,D), gtIgnore (G,), or None."""
    if not dts and not gts:
        return None
    g_ignore = np.array(
        [g.get("iscrowd", 0) or g.get("ignore", 0) or
         not (area_rng[0] <= g["area"] <= area_rng[1]) for g in gts],
        dtype=bool)
    # gts sorted: non-ignored first (pycocotools order)
    g_order = np.argsort(g_ignore, kind="stable")
    gts = [gts[i] for i in g_order]
    g_ignore = g_ignore[g_order]
    d_order = np.argsort([-d["score"] for d in dts], kind="stable")[:max_det]
    dts = [dts[i] for i in d_order]

    iscrowd = np.array([g.get("iscrowd", 0) for g in gts])
    ious = bbox_iou_xywh(
        np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4),
        np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4),
        iscrowd)

    T, D, G = len(IOU_THRS), len(dts), len(gts)
    dt_m = np.zeros((T, D), dtype=np.int64)    # matched gt index + 1
    gt_m = np.zeros((T, G), dtype=np.int64)
    dt_ig = np.zeros((T, D), dtype=bool)
    for t, thr in enumerate(IOU_THRS):
        for d in range(D):
            best, m = min(thr, 1 - 1e-10), -1
            for g in range(G):
                if gt_m[t, g] > 0 and not iscrowd[g]:
                    continue
                # break if moving to ignored gts and a match was found
                if m > -1 and not g_ignore[m] and g_ignore[g]:
                    break
                if ious[d, g] < best:
                    continue
                best, m = ious[d, g], g
            if m == -1:
                continue
            dt_ig[t, d] = g_ignore[m]
            dt_m[t, d] = m + 1
            gt_m[t, m] = d + 1
    # dets outside area range that are unmatched -> ignored
    a = np.array([not (area_rng[0] <= d["bbox"][2] * d["bbox"][3]
                       <= area_rng[1]) for d in dts], dtype=bool)
    dt_ig = dt_ig | ((dt_m == 0) & a[None])
    return {"dtScores": np.array([d["score"] for d in dts]),
            "dtMatches": dt_m, "dtIgnore": dt_ig, "gtIgnore": g_ignore}


class COCOEvaluator:
    """Accumulating bbox evaluator. ``update(predictions)`` with
    {image_id: {"boxes" xyxy, "scores", "labels"}} dicts (the PostProcess
    output contract), then ``summarize()``."""

    def __init__(self, coco_gt, img_ids: Optional[Sequence[int]] = None):
        self.coco = coco_gt
        self.img_ids = list(img_ids if img_ids is not None
                            else coco_gt.getImgIds())
        self.cat_ids = coco_gt.getCatIds() or [1]
        self.detections: List[dict] = []
        self._seen = set()

    def update(self, predictions: Dict[int, dict]):
        for img_id, pred in predictions.items():
            if img_id in self._seen:
                continue
            self._seen.add(img_id)
            boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
            xywh = boxes.copy()
            xywh[:, 2:] -= xywh[:, :2]
            for box, score, label in zip(
                    xywh, np.asarray(pred["scores"], np.float64),
                    np.asarray(pred["labels"]).astype(int)):
                self.detections.append({
                    "image_id": int(img_id), "category_id": int(label),
                    "bbox": box.tolist(), "score": float(score)})

    def synchronize_between_processes(self):
        """Merge the detections of every process, so that each holds all
        of them: nothing to merge without a process group or with one
        process. An image evaluated by more than one process (the padded
        shards of ``data/loader.py::shard_indices`` wrap the order) keeps
        the detections of the lowest rank, once."""
        import torch.distributed as dist
        if not dist.is_available() or not dist.is_initialized() \
                or dist.get_world_size() <= 1:
            return
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, {"dets": self.detections,
                                       "seen": sorted(self._seen)})
        dets, seen = [], set()
        for part in parts:                 # rank order
            new = set(part["seen"]) - seen
            dets.extend(d for d in part["dets"] if d["image_id"] in new)
            seen |= new
        self.detections, self._seen = dets, seen

    def accumulate(self):
        dt_by = defaultdict(list)
        for d in self.detections:
            dt_by[(d["image_id"], d["category_id"])].append(d)
        gt_by = defaultdict(list)
        for img_id in self.img_ids:
            for a in self.coco.imgToAnns[img_id]:
                gt_by[(img_id, a["category_id"])].append(a)

        T, R = len(IOU_THRS), len(REC_THRS)
        K, A, M = len(self.cat_ids), len(AREA_RNG), len(MAX_DETS)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        for k, cat in enumerate(self.cat_ids):
            for a, rng in enumerate(AREA_RNG.values()):
                for m, max_det in enumerate(MAX_DETS):
                    evals = [_evaluate_img(dt_by[(i, cat)], gt_by[(i, cat)],
                                           rng, max_det)
                             for i in self.img_ids]
                    evals = [e for e in evals if e is not None]
                    if not evals:
                        continue
                    scores = np.concatenate([e["dtScores"] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([e["dtMatches"] for e in evals],
                                         axis=1)[:, order]
                    dti = np.concatenate([e["dtIgnore"] for e in evals],
                                         axis=1)[:, order]
                    n_pos = sum(int((~e["gtIgnore"]).sum()) for e in evals)
                    if n_pos == 0:
                        continue
                    tps = (dtm > 0) & ~dti
                    fps = (dtm == 0) & ~dti
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        rc = tp / n_pos
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        recall[t, k, a, m] = rc[-1] if len(rc) else 0
                        # precision envelope
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        idx = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(R)
                        ok = idx < len(pr)
                        q[ok] = pr[idx[ok]]
                        precision[t, :, k, a, m] = q
        self.precision, self.recall = precision, recall
        return precision, recall

    def _ap(self, iou_thr=None, area="all", max_det=100):
        a = list(AREA_RNG).index(area)
        m = MAX_DETS.index(max_det)
        p = self.precision
        if iou_thr is not None:
            p = p[[int(round((iou_thr - 0.5) / 0.05))]]
        p = p[:, :, :, a, m]
        valid = p > -1
        return float(p[valid].mean()) if valid.any() else -1.0

    def summarize(self, verbose: bool = True) -> Dict[str, float]:
        if not hasattr(self, "precision"):
            self.accumulate()
        stats = {
            "mAP": self._ap(),
            "mAP_50": self._ap(iou_thr=0.5),
            "mAP_75": self._ap(iou_thr=0.75),
            "mAP_small": self._ap(area="small"),
            "mAP_medium": self._ap(area="medium"),
            "mAP_large": self._ap(area="large"),
        }
        if verbose:
            for k, v in stats.items():
                print(f"  {k:12s} = {v:.4f}")
        return stats
