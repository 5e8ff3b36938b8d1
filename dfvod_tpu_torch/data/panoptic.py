"""COCO panoptic: the dataset and PQ evaluation without panopticapi
(counterpart of ``dfvod_tpu/data/panoptic.py``; the reference's dormant
``datasets/coco_panoptic.py`` and ``datasets/panoptic_eval.py``).

The id maps are 8-bit RGB PNGs read by the port's own decoder
(``data/image_io.py``), the frames JPEGs; the evaluator's PNG artifacts
are written by its encoder. ``pq_compute_single`` follows panopticapi's
matching: intersections from the joint (gt, pred) histogram, the pred's
overlap with VOID out of the union, a match at IoU > 0.5 within a
category, crowd segments never matched, and an unmatched prediction
waived when more than half of it lies on VOID and same-category crowd.
Under data parallelism ``synchronize_between_processes`` sums every
process's per-category counts (``all_gather_object``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist

from dfvod_tpu_torch import parallel
from dfvod_tpu_torch.data.image_io import encode_png, read_image, read_rgb

VOID = 0
_OFFSET = 256 ** 3


def rgb2id(color: np.ndarray) -> np.ndarray:
    """panopticapi's id of an RGB colour: R + 256 G + 256^2 B."""
    color = color.astype(np.uint32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id2rgb(id_map: np.ndarray) -> np.ndarray:
    """``rgb2id``'s inverse: (H, W, 3) uint8."""
    id_map = id_map.astype(np.uint32)
    return np.stack([id_map % 256, (id_map // 256) % 256,
                     (id_map // (256 * 256)) % 256], -1).astype(np.uint8)


def masks_to_boxes(masks: np.ndarray) -> np.ndarray:
    """(N, H, W) masks -> (N, 4) xyxy boxes, the last row and column + 1
    (``util/box_ops.py:masks_to_boxes``); an empty mask gives zeros."""
    boxes = np.zeros((len(masks), 4), np.float32)
    for i, m in enumerate(masks):
        cols, rows = np.nonzero(m.any(0))[0], np.nonzero(m.any(1))[0]
        if len(cols):
            boxes[i] = [cols[0], rows[0], cols[-1] + 1, rows[-1] + 1]
    return boxes


class CocoPanopticDataset:
    """``datasets/coco_panoptic.py:23-86``: ``ds[i]`` -> (rgb (H, W, 3)
    uint8, target {image_id, masks (N, H, W) bool (with
    ``return_masks``), labels, boxes xyxy, iscrowd, area, orig_size})."""

    def __init__(self, img_folder: str, ann_folder: str, ann_file: str,
                 return_masks: bool = True):
        with open(ann_file) as f:
            self.coco = json.load(f)
        self.coco["images"] = sorted(self.coco["images"],
                                     key=lambda x: x["id"])
        for img, ann in zip(self.coco["images"],
                            self.coco.get("annotations", [])):
            if img["file_name"][:-4] != ann["file_name"][:-4]:
                raise ValueError(f"image {img['file_name']} and annotation "
                                 f"{ann['file_name']} are out of order")
        self.img_folder = img_folder
        self.ann_folder = ann_folder
        self.return_masks = return_masks

    def __len__(self):
        return len(self.coco["images"])

    def __getitem__(self, idx: int):
        anns = self.coco.get("annotations")
        info = anns[idx] if anns else self.coco["images"][idx]
        rgb = read_rgb(os.path.join(
            self.img_folder, info["file_name"].replace(".png", ".jpg")))
        target: Dict = {"image_id": info.get("image_id", info.get("id"))}
        if "segments_info" in info:
            segs = info["segments_info"]
            id_map = rgb2id(read_image(os.path.join(self.ann_folder,
                                                    info["file_name"])))
            ids = np.array([s["id"] for s in segs])
            masks = id_map[None] == ids[:, None, None]
            if self.return_masks:
                target["masks"] = masks
            target["labels"] = np.array([s["category_id"] for s in segs],
                                        np.int64)
            target["boxes"] = masks_to_boxes(masks)
            target["iscrowd"] = np.array([s.get("iscrowd", 0) for s in segs])
            target["area"] = np.array([s["area"] for s in segs])
        target["orig_size"] = rgb.shape[:2]
        return rgb, target


def build_panoptic(image_set: str, coco_path: str, coco_panoptic_path: str,
                   return_masks: bool = True):
    """``coco_panoptic.py:89-107``: the reference's panoptic layout,
    ``{train,val}2017/`` frames, ``panoptic_{split}/`` PNGs and
    ``annotations/panoptic_{split}.json``."""
    split = {"train": "train2017", "val": "val2017"}[image_set]
    return CocoPanopticDataset(
        os.path.join(coco_path, split),
        os.path.join(coco_panoptic_path, f"panoptic_{split}"),
        os.path.join(coco_panoptic_path, "annotations",
                     f"panoptic_{split}.json"),
        return_masks=return_masks)


def _segment_areas(id_map: np.ndarray) -> Dict[int, int]:
    ids, counts = np.unique(id_map, return_counts=True)
    return {int(i): int(c) for i, c in zip(ids, counts)}


def _stat(stats: Dict, k: int) -> Dict:
    return stats.setdefault(k, {"tp": 0, "fp": 0, "fn": 0, "iou": 0.0})


def pq_compute_single(gt_map: np.ndarray, gt_segments: Sequence[Dict],
                      pred_map: np.ndarray, pred_segments: Sequence[Dict],
                      stats: Dict):
    """One image's PQ counts added to ``stats`` ({category: {tp, fp, fn,
    iou}}), with panopticapi's ``pq_compute_single_core`` matching (see
    the module docstring)."""
    gt_info = {int(s["id"]): s for s in gt_segments}
    pred_info = {int(s["id"]): s for s in pred_segments}
    gt_areas = _segment_areas(gt_map)
    pred_areas = _segment_areas(pred_map)
    combined = gt_map.astype(np.uint64) * _OFFSET + pred_map.astype(
        np.uint64)
    pairs, counts = np.unique(combined, return_counts=True)
    inter = {(int(p // _OFFSET), int(p % _OFFSET)): int(c)
             for p, c in zip(pairs, counts)}

    def cat(info, sid):
        return int(info[sid]["category_id"])

    matched_gt, matched_pred = set(), set()
    for (g, p), c in inter.items():
        if VOID in (g, p) or g not in gt_info or p not in pred_info:
            continue
        if gt_info[g].get("iscrowd", 0) or cat(gt_info, g) != cat(
                pred_info, p):
            continue
        union = (gt_areas.get(g, 0) + pred_areas.get(p, 0) - c
                 - inter.get((VOID, p), 0))
        iou = c / union if union > 0 else 0.0
        if iou > 0.5:
            st = _stat(stats, cat(gt_info, g))
            st["tp"] += 1
            st["iou"] += iou
            matched_gt.add(g)
            matched_pred.add(p)

    crowd_by_cat: Dict[int, int] = {}
    for g, info in gt_info.items():
        if info.get("iscrowd", 0):
            crowd_by_cat[cat(gt_info, g)] = g
        elif g not in matched_gt:
            _stat(stats, cat(gt_info, g))["fn"] += 1

    for p in pred_info:
        if p in matched_pred or p not in pred_areas:
            continue
        ignore = inter.get((VOID, p), 0)
        crowd_id = crowd_by_cat.get(cat(pred_info, p))
        if crowd_id is not None:
            ignore += inter.get((crowd_id, p), 0)
        if ignore / pred_areas[p] > 0.5:
            continue
        _stat(stats, cat(pred_info, p))["fp"] += 1


def pq_average(stats: Dict, categories: Optional[Dict[int, bool]] = None,
               isthing: Optional[bool] = None) -> Dict:
    """PQ, SQ and RQ averaged over the categories with a count
    (panopticapi's ``pq_average``); ``isthing`` keeps the things or the
    stuff of ``categories``."""
    n, pq, sq, rq = 0, 0.0, 0.0, 0.0
    for k, st in stats.items():
        if isthing is not None and (categories is None
                                    or categories.get(k) != isthing):
            continue
        denom = st["tp"] + 0.5 * st["fp"] + 0.5 * st["fn"]
        if denom == 0:
            continue
        n += 1
        pq += st["iou"] / denom
        sq += st["iou"] / st["tp"] if st["tp"] else 0.0
        rq += st["tp"] / denom
    if n == 0:
        return {"pq": 0.0, "sq": 0.0, "rq": 0.0, "n": 0}
    return {"pq": pq / n, "sq": sq / n, "rq": rq / n, "n": n}


class PanopticEvaluator:
    """``datasets/panoptic_eval.py:21-52``: ``update`` takes one image's
    ``postprocess_panoptic`` output and its ground truth (and, with
    ``output_dir`` and a file name, writes the prediction as an id2rgb
    PNG, as the reference does); ``summarize`` -> {"All", "Things",
    "Stuff"}."""

    def __init__(self, is_thing_map: Optional[Dict[int, bool]] = None,
                 output_dir: str = ""):
        self.stats: Dict = {}
        self.is_thing_map = is_thing_map or {}
        self.output_dir = output_dir
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)

    def update(self, pred_map, pred_segments, gt_map, gt_segments,
               file_name: str = ""):
        pq_compute_single(np.asarray(gt_map), gt_segments,
                          np.asarray(pred_map), pred_segments, self.stats)
        if self.output_dir and file_name:
            with open(os.path.join(self.output_dir, file_name), "wb") as f:
                f.write(encode_png(id2rgb(np.asarray(pred_map))))

    def synchronize_between_processes(self):
        """Every process's counts summed into each (the counts are all PQ
        needs; the reference gathers the predictions)."""
        if parallel.world() == 1:
            return
        parts = [None] * parallel.world()
        dist.all_gather_object(parts, self.stats)
        merged: Dict = {}
        for part in parts:
            for k, st in part.items():
                m = _stat(merged, int(k))
                for f in ("tp", "fp", "fn", "iou"):
                    m[f] += st[f]
        self.stats = merged

    def summarize(self) -> Dict:
        out = {"All": pq_average(self.stats)}
        if self.is_thing_map:
            out["Things"] = pq_average(self.stats, self.is_thing_map,
                                       isthing=True)
            out["Stuff"] = pq_average(self.stats, self.is_thing_map,
                                      isthing=False)
        return out
