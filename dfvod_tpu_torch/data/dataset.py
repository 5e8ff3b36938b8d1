"""RGB-D COCO datasets, single-frame and video clips (counterpart of
``dfvod_tpu/data/dataset.py``).

Parity targets: ``datasets/torchvision_datasets/coco.py`` of the reference
(paired RGB + depth with the ``images -> depth_pred`` path substitution and
per-image min-max depth normalization), ``datasets/vid_single.py`` (targets
+ transforms) and ``datasets/vid_multi.py`` (reference frames: train = the
nearest +-num_ref_frames ids without the key frame, eval = one-sided stride
``max(len // 16, 1)``; a still image, ``video_id == -1``, repeats the key
frame).

Frames are decoded by the port's JPEG decoder (``data/image_io.py``).
Segmentation masks (``return_masks``) and ``coco_panoptic`` wait for the
segmentation slice.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from dfvod_tpu_torch.data.coco import COCO, CocoVID
from dfvod_tpu_torch.data.image_io import read_image, read_rgb
from dfvod_tpu_torch.data.transforms import (
    EvalTransform,
    Sample,
    TrainTransform,
)

_SEGMENTATION = "waits for the segmentation slice"


def load_depth(path) -> np.ndarray:
    """Reference ``get_depth`` (``torchvision_datasets/coco.py:75-105``):
    read unchanged, refuse 3 channels, min-max normalize to uint8."""
    depth = read_image(path)
    if depth.ndim == 3:
        raise ValueError(f"depth image has {depth.shape[-1]} channels: "
                         f"{path} (expected single-channel)")
    d = depth.astype(np.float32)
    rng = d.max() - d.min()
    if rng > 0:
        d = (d - d.min()) / rng
    else:
        d = np.zeros_like(d)
    return (d * 255).astype(np.uint8)


def depth_path_for(image_path: str) -> str:
    """``images -> depth_pred`` substitution
    (``torchvision_datasets/coco.py:84``)."""
    return image_path.replace("images", "depth_pred")


def prepare_targets(anns: List[dict], h: int, w: int):
    """``ConvertCocoPolysToMask`` without masks (``vid_single.py:65-127``):
    xywh -> xyxy, clamp to the image, drop crowd and degenerate boxes.
    Returns (boxes (T, 4) float32, labels (T,) int64)."""
    anns = [a for a in anns if a.get("iscrowd", 0) == 0]
    boxes = np.array([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
    boxes[:, 2:] += boxes[:, :2]
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
    labels = np.array([a["category_id"] for a in anns], np.int64)
    keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
    return boxes[keep], labels[keep]


def ref_ids(coco, img_id: int, num_ref_frames: int, *,
            train: bool) -> List[int]:
    """The reference frames of ``img_id`` in a ``CocoVID`` index
    (``vid_multi.py:74-125``): for training the nearest +-num_ref_frames
    ids of its video, for evaluation a one-sided stride of
    ``max(len // 16, 1)``; without the key frame (the reference's
    ``filter_key_img``), repeated up to ``num_ref_frames``; a still image (``video_id == -1``)
    repeats the key frame."""
    n = num_ref_frames
    video_id = coco.imgs[img_id].get("video_id", -1)
    if video_id == -1:
        return [img_id] * n
    img_ids = coco.get_img_ids_from_vid(video_id)
    if train:
        refs = list(range(max(img_ids[0], img_id - n),
                          min(img_ids[-1], img_id + n) + 1))
    else:
        interval = max(len(img_ids) // 16, 1)
        if (img_id - img_ids[0]) // interval < n:
            refs = [min(img_id + (i + 1) * interval, img_ids[-1])
                    for i in range(n)]
        else:
            refs = [max(img_id - (i + 1) * interval, img_ids[0])
                    for i in range(n)]
    if img_id in refs:
        refs.remove(img_id)
    while 0 < len(refs) < n:
        refs.extend(refs)
    return refs[:n] or [img_id] * n


class CocoDetectionDataset:
    """Single-frame dataset: ``__getitem__`` returns a list of one
    ``Sample`` (a clip of length 1), the video dataset longer clips through
    the same interface.

    ``cache_mode``: every RGB file's bytes are read into RAM once, for this
    process, and decoded from there (``torchvision_datasets/coco.py:51-58``;
    sharing the cache across hosts waits for data parallelism, item 14)."""

    def __init__(self, img_folder: str, ann_file: str, *,
                 use_depth: bool = False, train: bool = True,
                 cache_mode: bool = False, return_masks: bool = False):
        if return_masks:
            raise NotImplementedError(f"return_masks {_SEGMENTATION}")
        self.root = img_folder
        self.coco = self._index(ann_file)
        self.ids = sorted(self.coco.imgs)
        self.use_depth = use_depth
        self.train = train
        self._cache: Optional[dict] = None
        if cache_mode:
            self._cache = {}
            for img_id in self.ids:
                with open(self._path(img_id), "rb") as f:
                    self._cache[img_id] = f.read()

    @staticmethod
    def _index(ann_file: str):
        return COCO(ann_file)

    def _path(self, img_id: int) -> str:
        return os.path.join(self.root, self.coco.imgs[img_id]["file_name"])

    def __len__(self):
        return len(self.ids)

    def _load_frame(self, img_id: int) -> Sample:
        path = self._path(img_id)
        rgb = read_rgb(self._cache[img_id] if self._cache is not None
                       else path)
        depth = load_depth(depth_path_for(path)) if self.use_depth else None
        h, w = rgb.shape[:2]
        boxes, labels = prepare_targets(self.coco.imgToAnns[img_id], h, w)
        return Sample(rgb=rgb, depth=depth, boxes=boxes, labels=labels,
                      image_id=img_id, orig_size=(h, w))

    def __getitem__(self, index: int) -> List[Sample]:
        return [self._load_frame(self.ids[index])]


class CocoVideoDataset(CocoDetectionDataset):
    """Key frame + ``num_ref_frames`` reference frames, by the reference's
    id arithmetic (``vid_multi.py:74-125``), which assumes contiguous image
    ids within a video; a reference id absent from the file repeats the
    key frame."""

    def __init__(self, img_folder: str, ann_file: str, *,
                 num_ref_frames: int = 3, use_depth: bool = False,
                 train: bool = True, cache_mode: bool = False,
                 return_masks: bool = False):
        super().__init__(img_folder, ann_file, use_depth=use_depth,
                         train=train, cache_mode=cache_mode,
                         return_masks=return_masks)
        self.num_ref_frames = num_ref_frames

    @staticmethod
    def _index(ann_file: str):
        return CocoVID(ann_file)

    def _ref_ids(self, img_id: int) -> List[int]:
        return ref_ids(self.coco, img_id, self.num_ref_frames,
                       train=self.train)

    def __getitem__(self, index: int) -> List[Sample]:
        key = self.ids[index]
        frames = [self._load_frame(key)]
        for rid in self._ref_ids(key):
            frames.append(self._load_frame(rid) if rid in self.coco.imgs
                          else frames[0])
        return frames


def build_dataset(image_set: str, cfg, temporal: bool = False):
    """``datasets/__init__.py:28-42``: the reference's path layout under
    ``coco_path``; a ``dataset_file`` starting with ``coco`` selects the
    plain-COCO layout (``train2017/`` +
    ``annotations/instances_train2017.json``)."""
    data = cfg.data
    root = data.coco_path
    if data.dataset_file == "coco_panoptic":
        raise NotImplementedError(f"coco_panoptic {_SEGMENTATION}")
    if cfg.model.masks:
        raise NotImplementedError(f"masks {_SEGMENTATION}")
    if data.dataset_file.startswith("coco"):
        img_folder = os.path.join(root, f"{image_set}2017")
        ann_file = os.path.join(root, "annotations",
                                f"instances_{image_set}2017.json")
    else:
        img_folder = os.path.join(root, "coco", "images")
        ann_file = os.path.join(root, "coco", "annotations",
                                f"{image_set}.json")
    kw = dict(use_depth=data.use_depth, train=image_set == "train",
              cache_mode=data.cache_mode)
    if temporal:
        return CocoVideoDataset(img_folder, ann_file,
                                num_ref_frames=data.num_ref_frames, **kw)
    return CocoDetectionDataset(img_folder, ann_file, **kw)


def make_transform(train: bool, cfg):
    data = cfg.data
    if train:
        return TrainTransform(short_sides=data.train_short_sides,
                              max_size=data.max_size,
                              strong_aug=data.strong_aug)
    return EvalTransform(short_side=data.eval_short_side,
                         max_size=data.max_size)
