"""COCO / CocoVID annotation index: the port's own copy of
``dfvod_tpu/data/coco.py``.

A subset of the pycocotools ``COCO`` API that the reference uses
(``datasets/torchvision_datasets/coco.py``, ``datasets/coco_video_parser.py``):
json and dict indexes only, no C extension.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional


class COCO:
    """Minimal COCO index: imgs / anns / cats + img->anns mapping."""

    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[dict] = None):
        if annotation_file is not None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset or {}
        self.anns: Dict = {}
        self.imgs: Dict = {}
        self.cats: Dict = {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        self.create_index()

    def create_index(self):
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.imgToAnns[ann["image_id"]].append(ann)
            self.catToImgs[ann["category_id"]].append(ann["image_id"])
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    # -- pycocotools-compatible accessors -----------------------------------
    def getImgIds(self, imgIds=(), catIds=()) -> List[int]:
        ids = set(imgIds) if imgIds else set(self.imgs)
        if catIds:
            cat_imgs = set()
            for c in catIds:
                cat_imgs.update(self.catToImgs[c])
            ids &= cat_imgs
        return sorted(ids)

    def getAnnIds(self, imgIds=(), catIds=(), areaRng=(), iscrowd=None
                  ) -> List[int]:
        if imgIds:
            anns = [a for i in imgIds for a in self.imgToAnns[i]]
        else:
            anns = list(self.anns.values())
        if catIds:
            catIds = set(catIds)
            anns = [a for a in anns if a["category_id"] in catIds]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getCatIds(self) -> List[int]:
        return sorted(self.cats)

    def loadImgs(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def loadAnns(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadCats(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.cats[i] for i in ids]

    def loadRes(self, results) -> "COCO":
        """Build a results COCO from a list of detection dicts
        ({image_id, category_id, bbox xywh, score})."""
        if isinstance(results, str):
            with open(results) as f:
                results = json.load(f)
        dataset = {"images": list(self.imgs.values()),
                   "categories": list(self.cats.values()),
                   "annotations": []}
        for i, det in enumerate(results):
            ann = dict(det)
            x, y, w, h = det["bbox"]
            ann.setdefault("area", w * h)
            ann.setdefault("iscrowd", 0)
            ann["id"] = i + 1
            dataset["annotations"].append(ann)
        return COCO(dataset=dataset)


class CocoVID(COCO):
    """COCO extended with video/instance indexes
    (``datasets/coco_video_parser.py:6-150``)."""

    def __init__(self, annotation_file: Optional[str] = None,
                 dataset: Optional[dict] = None):
        self.videos: Dict = {}
        self.vidToImgs = defaultdict(list)
        self.instancesToImgs = defaultdict(list)
        self.vidToInstances = defaultdict(set)
        super().__init__(annotation_file, dataset)

    def create_index(self):
        super().create_index()
        for video in self.dataset.get("videos", []):
            self.videos[video["id"]] = video
        for img in self.dataset.get("images", []):
            vid = img.get("video_id", -1)
            self.vidToImgs[vid].append(img)
        for ann in self.dataset.get("annotations", []):
            ins = ann.get("instance_id")
            if ins is not None:
                self.instancesToImgs[ins].append(ann["image_id"])
                vid = self.imgs[ann["image_id"]].get("video_id", -1)
                self.vidToInstances[vid].add(ins)
        # frames sorted by frame_id within each video
        for vid in self.vidToImgs:
            self.vidToImgs[vid].sort(key=lambda im: im.get("frame_id", 0))

    def get_vid_ids(self) -> List[int]:
        return sorted(self.videos)

    def get_img_ids_from_vid(self, vid: int) -> List[int]:
        return [im["id"] for im in self.vidToImgs[vid]]

    def get_img_ids_from_ins_id(self, ins_id: int) -> List[int]:
        return self.instancesToImgs[ins_id]
