"""YOLO txt -> COCO json conversion, counterpart of
``dfvod_tpu/tools/yolo_to_coco.py`` (the reference's
``data_conversion_tools/change_to_coco.py``, flat and nested-folder
variants).

YOLO line format: ``class cx cy w h`` normalized; converted to COCO xywh
pixels. Each folder becomes a video (``videos`` entry + per-image
``video_id``/``frame_id``), matching the reference's CocoVID output shape
(``change_to_coco.py:60-75``). Each image's size comes from its JPEG
frame header or PNG IHDR (``image_io.image_size``), without decoding it.

    python -m dfvod_tpu_torch.tools.yolo_to_coco --images_dir DIR \
        --labels_dir DIR --output FILE.json [--nested]
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path
from typing import List, Optional

from dfvod_tpu_torch.data import image_io

EXTENSIONS = (".png", ".jpg", ".jpeg")


def yolo_folder_to_coco(images_dir: str, labels_dir: str,
                        categories: Optional[List[str]] = None,
                        nested: bool = False) -> dict:
    categories = categories or ["hand"]
    coco = {
        "info": {"description": None, "year": 2022},
        "licenses": [{"id": 1, "name": None, "url": None}],
        "categories": [{"id": j + 1, "name": c, "supercategory": c}
                       for j, c in enumerate(categories)],
        "images": [], "annotations": [], "videos": [],
    }
    img_root = Path(images_dir)
    lbl_root = Path(labels_dir)
    folders = (sorted(d for d in img_root.iterdir() if d.is_dir())
               if nested else [img_root])
    image_id = ann_id = 1
    for vid, folder in enumerate(folders, start=1):
        coco["videos"].append({"id": vid, "file_name": str(folder.name)})
        files = sorted((f for f in folder.iterdir()
                        if f.suffix.lower() in EXTENSIONS),
                       key=lambda f: f.stem)
        for frame_id, img_path in enumerate(files):
            h, w = image_io.image_size(img_path)
            rel = img_path.relative_to(img_root)
            coco["images"].append({
                "id": image_id, "file_name": str(rel), "width": w,
                "height": h, "video_id": vid, "frame_id": frame_id})
            lbl = (lbl_root / rel).with_suffix(".txt")
            if lbl.exists():
                for line in lbl.read_text().splitlines():
                    parts = line.split()
                    if len(parts) < 5:
                        continue
                    cls, cx, cy, bw, bh = (int(parts[0]),
                                           *map(float, parts[1:5]))
                    x = (cx - bw / 2) * w
                    y = (cy - bh / 2) * h
                    coco["annotations"].append({
                        "id": ann_id, "image_id": image_id,
                        "category_id": cls + 1,
                        "bbox": [x, y, bw * w, bh * h],
                        "area": bw * w * bh * h, "iscrowd": 0,
                        "instance_id": -1})
                    ann_id += 1
            image_id += 1
    return coco


def main(argv=None):
    p = argparse.ArgumentParser("yolo_to_coco")
    p.add_argument("--images_dir", required=True)
    p.add_argument("--labels_dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--categories_file", default=None)
    p.add_argument("--nested", action="store_true",
                   help="one sub-folder per video")
    a = p.parse_args(argv)
    cats = None
    if a.categories_file:
        cats = [ln.strip() for ln in open(a.categories_file)
                if ln.strip()]
    coco = yolo_folder_to_coco(a.images_dir, a.labels_dir, cats, a.nested)
    os.makedirs(os.path.dirname(os.path.abspath(a.output)), exist_ok=True)
    with open(a.output, "w") as f:
        json.dump(coco, f)
    print(f"wrote {len(coco['images'])} images, "
          f"{len(coco['annotations'])} annotations -> {a.output}")


if __name__ == "__main__":
    main()
