"""Offline tools, counterparts of ``dfvod_tpu/tools``: monocular depth
generation (``rgb2d``), YOLO -> COCO label conversion (``yolo_to_coco``),
YOLO-txt scoring (``yolo_eval``) and dataset mean/std
(``calculate_mean_std``). Images are read through ``data/image_io.py``,
never PIL (the card machine has none)."""
