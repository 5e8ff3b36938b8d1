"""YOLO-txt detection scoring, counterpart of
``dfvod_tpu/tools/yolo_eval.py`` (numpy only): the external
"benchmark_tool" the reference README points at for its mAP@0.5 / F1
tables (``README.md:260-264``) but does not ship. Scores prediction txt
files (``class cx cy w h prob`` normalized — the inference CLI's --save_txt
output) against ground-truth txt files (``class cx cy w h``).

Reports AP@0.5 (101-point interpolation, matching the COCO evaluator's
convention) plus precision/recall/F1 at the best-F1 confidence threshold —
the three numbers in the reference's results tables. The port's
``cli/inference.py`` writes the prediction files (class token ``Hand``).

    python -m dfvod_tpu_torch.tools.yolo_eval --gt_dir DIR --pred_dir DIR
"""
from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def _parse(path: Path, has_score: bool) -> List[Tuple]:
    rows = []
    if not path.exists():
        return rows
    for line in path.read_text().splitlines():
        parts = line.split()
        if not parts:
            continue
        cls = parts[0]
        vals = list(map(float, parts[1:]))
        if has_score and len(vals) >= 5:
            rows.append((cls, vals[0], vals[1], vals[2], vals[3], vals[4]))
        elif len(vals) >= 4:
            rows.append((cls, vals[0], vals[1], vals[2], vals[3], 1.0))
    return rows


def _iou_cxcywh(a, b) -> float:
    ax1, ay1 = a[0] - a[2] / 2, a[1] - a[3] / 2
    ax2, ay2 = a[0] + a[2] / 2, a[1] + a[3] / 2
    bx1, by1 = b[0] - b[2] / 2, b[1] - b[3] / 2
    bx2, by2 = b[0] + b[2] / 2, b[1] + b[3] / 2
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = a[2] * a[3] + b[2] * b[3] - inter
    return inter / union if union > 0 else 0.0


def evaluate_yolo_dirs(gt_dir: str, pred_dir: str,
                       iou_thr: float = 0.5) -> Dict[str, float]:
    """Greedy score-ordered matching per image per class (pycocotools
    convention), 101-point interpolated AP + best-F1 operating point."""
    gt_files = sorted(Path(gt_dir).glob("*.txt"))
    n_gt = 0
    records = []  # (score, is_tp)
    for gt_path in gt_files:
        stem = gt_path.stem
        gts = _parse(gt_path, has_score=False)
        preds = sorted(_parse(Path(pred_dir) / f"{stem}.txt",
                              has_score=True),
                       key=lambda r: -r[5])
        n_gt += len(gts)
        used = [False] * len(gts)
        for cls, cx, cy, w, h, score in preds:
            best, best_j = iou_thr, -1
            for j, (gcls, gcx, gcy, gw, gh, _) in enumerate(gts):
                if used[j] or gcls != cls:
                    continue
                iou = _iou_cxcywh((cx, cy, w, h), (gcx, gcy, gw, gh))
                if iou >= best:
                    best, best_j = iou, j
            if best_j >= 0:
                used[best_j] = True
                records.append((score, 1))
            else:
                records.append((score, 0))

    if not records or n_gt == 0:
        return {"ap50": 0.0, "precision": 0.0, "recall": 0.0, "f1": 0.0,
                "best_threshold": 0.0, "num_gt": n_gt,
                "num_pred": len(records)}

    records.sort(key=lambda r: -r[0])
    scores = np.array([r[0] for r in records])
    tps = np.array([r[1] for r in records], np.float64)
    tp_cum = np.cumsum(tps)
    fp_cum = np.cumsum(1 - tps)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)

    # 101-point interpolated AP (precision envelope)
    pr = precision.copy()
    for i in range(len(pr) - 1, 0, -1):
        pr[i - 1] = max(pr[i - 1], pr[i])
    rec_grid = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, rec_grid, side="left")
    q = np.zeros(101)
    ok = idx < len(pr)
    q[ok] = pr[idx[ok]]
    ap = float(q.mean())

    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-12)
    best = int(np.argmax(f1))
    return {"ap50": ap, "precision": float(precision[best]),
            "recall": float(recall[best]), "f1": float(f1[best]),
            "best_threshold": float(scores[best]), "num_gt": int(n_gt),
            "num_pred": len(records)}


def main(argv=None):
    p = argparse.ArgumentParser("yolo_eval")
    p.add_argument("--gt_dir", required=True,
                   help="ground-truth txt folder (class cx cy w h)")
    p.add_argument("--pred_dir", required=True,
                   help="prediction txt folder (class cx cy w h prob)")
    p.add_argument("--iou_thr", type=float, default=0.5)
    a = p.parse_args(argv)
    stats = evaluate_yolo_dirs(a.gt_dir, a.pred_dir, a.iou_thr)
    for k, v in stats.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")


if __name__ == "__main__":
    main()
