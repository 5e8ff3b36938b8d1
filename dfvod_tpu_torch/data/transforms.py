"""Normalization statistics (the port's own copy of
``dfvod_tpu/data/transforms.py:29-31``): RGB ImageNet and the DFormer
depth statistics (``vid_single.py:133-142`` of the reference)."""
import numpy as np

RGB_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
RGB_STD = np.array([0.229, 0.224, 0.225], np.float32)
DEPTH_MEAN, DEPTH_STD = 0.48, 0.28
