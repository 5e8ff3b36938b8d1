"""The port's photometric and cropping augmentations
(``dfvod_tpu_torch/data/photometric.py``, ``--strong_aug``) against the JAX
package's (``dfvod_tpu/data/photometric.py``) on ``datasets/synth_rgbd``.

- The HSV conversions: bitwise equal to cv2 over all 2^24 inputs, both
  ways.
- Each op and the distortion stack: the same frames, boxes and sizes
  (bitwise) from the same ``np.random.Generator`` calls.
- ``TrainTransform(strong_aug=True)``: boxes, labels and sizes bitwise;
  images within the resize gate of ``tests/test_torch_data.py`` (values 1
  level apart on at most 0.05% of them; the JAX side resizes with its
  native library, ``DFVOD_CV2=0``).
"""
import os
import sys

import cv2
import numpy as np
import pytest

from dfvod_tpu.data import dataset as j_dataset
from dfvod_tpu.data import loader as j_loader
from dfvod_tpu.data import photometric as j_ph
from dfvod_tpu.data import transforms as j_tf
from dfvod_tpu_torch.data import dataset, image_io
from dfvod_tpu_torch.data import photometric as ph
from dfvod_tpu_torch.data import transforms as tf
from dfvod_tpu_torch.data.loader import Loader
from torch_port_helpers import private_jax_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

IMAGES, DEPTHS = chip_smoke.synth_jpegs()
COCO_DIR = os.path.join(chip_smoke.SYNTH_RGBD, "coco")
TRAIN_JSON = os.path.join(COCO_DIR, "annotations", "train.json")
MAX_DIFF_SHARE = 5e-4           # the resize gate of test_torch_data.py


@pytest.fixture(scope="module", autouse=True)
def jax_native_library(tmp_path_factory):
    restore = private_jax_native(tmp_path_factory.mktemp("jax_native"))
    yield
    restore()


@pytest.fixture(autouse=True)
def jax_native_resize(monkeypatch):
    monkeypatch.setenv("DFVOD_CV2", "0")


def every_triple():
    a = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([a >> 16, (a >> 8) & 255, a & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("direction", ["rgb2hsv", "hsv2rgb"])
def test_hsv_conversion_is_cv2_bitwise_on_every_input(direction):
    x = every_triple()
    if direction == "rgb2hsv":
        got, ref = ph.rgb_to_hsv_u8(x), cv2.cvtColor(
            x, cv2.COLOR_RGB2HSV_FULL)
    else:
        got, ref = ph.hsv_to_rgb_u8(x), cv2.cvtColor(
            x, cv2.COLOR_HSV2RGB_FULL)
    np.testing.assert_array_equal(got, ref)


def clip_pairs(n=3, seed=0, boxes=True):
    """(port frames, JAX frames): the first ``n`` synth frames as a clip,
    each with 1-4 boxes drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    port, jax_ = [], []
    for k in range(n):
        rgb = image_io.read_rgb(IMAGES[k])
        depth = dataset.load_depth(DEPTHS[k])
        h, w = rgb.shape[:2]
        t = int(rng.integers(1, 5)) if boxes else 0
        xy = rng.uniform(0, 0.6, (t, 2)) * (w, h)
        wh = rng.uniform(0.1, 0.4, (t, 2)) * (w, h)
        b = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        labels = rng.integers(1, 3, t)
        port.append(tf.Sample(rgb, depth, b, labels, image_id=k + 1,
                              orig_size=(h, w)))
        jax_.append(j_tf.Sample(rgb.copy(), depth.copy(), b.copy(),
                                labels.copy(), image_id=k + 1,
                                orig_size=(h, w)))
    return port, jax_


def assert_frames_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for field in ("rgb", "depth", "boxes", "labels"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(r, field), err_msg=field)
        assert (g.image_id, tuple(g.orig_size)) == (r.image_id,
                                                    tuple(r.orig_size))


OPS = ["RandomContrast", "RandomBrightness", "RandomSaturation", "RandomHue",
       "RandomLightingNoise", "PhotometricDistortion", "MinIoURandomCrop"]


@pytest.mark.parametrize("op", OPS)
def test_op_equals_jax_under_the_same_rng(op):
    """Twelve seeds, so every op fires (and each single op also passes);
    the generators are left in the same state."""
    fired = 0
    for seed in range(12):
        port, jax_ = clip_pairs(seed=seed, boxes=seed % 4 != 3)
        p_rng, j_rng = (np.random.default_rng(seed),
                        np.random.default_rng(seed))
        got = getattr(ph, op)()(port, p_rng)
        ref = getattr(j_ph, op)()(jax_, j_rng)
        assert_frames_equal(got, ref)
        assert p_rng.random() == j_rng.random()
        fired += any(g is not p for g, p in zip(got, port))
    assert 0 < fired <= (12 if op == "PhotometricDistortion" else 11)


def test_min_iou_crop_crops_every_frame_of_the_clip_alike():
    for seed in range(40):
        port, _ = clip_pairs(seed=seed)
        got = ph.MinIoURandomCrop()(port, np.random.default_rng(seed))
        if got[0] is not port[0]:
            break
    else:
        pytest.fail("no crop in 40 seeds")
    shapes = {g.rgb.shape[:2] for g in got}
    assert len(shapes) == 1 and got[0].depth.shape == got[0].rgb.shape[:2]
    assert tuple(got[0].orig_size) == got[0].rgb.shape[:2]


def test_strong_aug_train_transform_equals_jax():
    """Sixteen clips: boxes, labels and sizes bitwise; images within the
    resize gate."""
    p_t = tf.TrainTransform(short_sides=(224, 256, 288), max_size=512,
                            strong_aug=True)
    j_t = j_tf.TrainTransform(short_sides=(224, 256, 288), max_size=512,
                              strong_aug=True)
    diff = total = 0
    for seed in range(16):
        port, jax_ = clip_pairs(seed=seed)
        got = p_t(port, np.random.default_rng(seed))
        ref = j_t(jax_, np.random.default_rng(seed))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.boxes, r.boxes)
            np.testing.assert_array_equal(g.labels, r.labels)
            assert tuple(g.orig_size) == tuple(r.orig_size)
            for a, b in ((g.rgb, r.rgb), (g.depth, r.depth)):
                assert a.shape == b.shape
                d = np.abs(a.astype(np.int16) - b)
                assert d.max() <= 1
                diff, total = diff + int((d > 0).sum()), total + d.size
    print(f"strong_aug frames: {diff} of {total} values 1 level apart")
    assert diff <= MAX_DIFF_SHARE * total


def test_strong_aug_loader_equals_jax():
    """The first three batches of a train loader with ``strong_aug``:
    every key but the image bitwise, the image within the resize gate."""
    common = dict(batch_size=4, use_depth=True, shuffle=True,
                  drop_last=True, seed=7)
    short = dict(short_sides=(224, 256), max_size=512, strong_aug=True)
    port = Loader(dataset.CocoDetectionDataset(
        os.path.join(COCO_DIR, "images"), TRAIN_JSON, use_depth=True),
        tf.TrainTransform(**short), **common)
    jax_ = j_loader.Loader(j_dataset.CocoDetectionDataset(
        os.path.join(COCO_DIR, "images"), TRAIN_JSON, use_depth=True),
        j_tf.TrainTransform(**short), device_preprocess=True, **common)
    n = 0
    for got, ref in zip(port, jax_):
        assert got.keys() == ref.keys()
        for k in ref:
            if k == "image":
                d = np.abs(got[k].astype(np.int16) - ref[k])
                assert d.max() <= 1 and (d > 0).mean() <= MAX_DIFF_SHARE
            else:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        n += 1
        if n == 3:
            break
    assert n == 3
