"""Data: the JPEG decoder, PNG reader and host resize (``image_io``,
``native``), the RGB-D COCO datasets, transforms (``photometric`` for
``strong_aug``) and loader, the on-device normalization (plain or s2d
packed), and the COCO index and bbox mAP evaluator."""
from dfvod_tpu_torch.data.coco import COCO, CocoVID  # noqa: F401
from dfvod_tpu_torch.data.dataset import (  # noqa: F401
    CocoDetectionDataset,
    CocoVideoDataset,
    build_dataset,
)
from dfvod_tpu_torch.data.loader import Loader  # noqa: F401
