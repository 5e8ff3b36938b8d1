"""The port's data layer (``dfvod_tpu_torch/data``: host resize,
transforms, datasets, loader) against the JAX package's on
``datasets/synth_rgbd``.

The resize gate: the port's resize (``csrc/preprocess.cpp``, built without
floating-point contraction) against the JAX package's native library
(built with ``-march=native``, whose fused multiply-adds round once per
sum): within 1 level on at most 0.05% of the values. Against JAX's default
cv2 resize (fixed-point weights) within 1 level: a known difference. Every
other field, and every frame that is not resized, is bitwise equal. The
JAX side runs with ``DFVOD_CV2=0`` so that it resizes with its native
library.
"""
import dataclasses
import json
import os
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch

from dfvod_tpu.data import dataset as j_dataset
from dfvod_tpu.data import loader as j_loader
from dfvod_tpu.data import native as j_native
from dfvod_tpu.data import transforms as j_tf
from dfvod_tpu_torch.data import dataset, image_io, native
from dfvod_tpu_torch.data import transforms as tf
from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.data.loader import Loader, shard_indices

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

COCO_DIR = os.path.join(chip_smoke.SYNTH_RGBD, "coco")
IMG_DIR = os.path.join(COCO_DIR, "images")
TRAIN_JSON = os.path.join(COCO_DIR, "annotations", "train.json")
VAL_JSON = os.path.join(COCO_DIR, "annotations", "val.json")
IMAGES, DEPTHS = chip_smoke.synth_jpegs()
MAX_DIFF_SHARE = 5e-4           # the resize gate: values 1 level apart


@pytest.fixture(autouse=True)
def jax_native_resize(monkeypatch):
    """The JAX package resizes with its native library, not cv2."""
    monkeypatch.setenv("DFVOD_CV2", "0")
    assert j_native.available()


def resize_gap(got, ref, what=""):
    """Every value within 1 level; returns (values 1 level apart,
    values). The share is gated over a test's whole set of values
    (``assert_share``): one small frame alone can exceed it."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - ref)
    assert d.max(initial=0) <= 1, what
    return int((d > 0).sum()), d.size


def assert_share(diff, total, what):
    print(f"{what}: {diff} of {total} values 1 level apart "
          f"({100 * diff / max(total, 1):.4f}%)")
    assert diff <= MAX_DIFF_SHARE * total


# ---------------------------------------------------------------- resize
SIZES = [(224, 280), (480, 600), (600, 750), (800, 1000), (300, 333),
         (129, 161)]


def test_resize_within_one_level_of_jax_native():
    """10 RGB and 10 depth frames at six sizes, up and down."""
    diff, total = 0, 0
    for f, df in zip(IMAGES[:10], DEPTHS[:10]):
        for img in (image_io.read_rgb(f), image_io.read_gray(df)):
            for h, w in SIZES:
                ref = j_native.resize_bilinear_u8(img, h, w)
                n, size = resize_gap(native.resize_bilinear_u8(img, h, w),
                                     ref[..., 0] if img.ndim == 2 else ref,
                                     (f, h, w))
                diff, total = diff + n, total + size
    assert_share(diff, total, "resize vs the JAX native library")


def test_resize_within_one_level_of_cv2():
    """The JAX package's default (cv2's fixed-point INTER_LINEAR): a known
    difference of 1 level on about 1 value in 8."""
    img = image_io.read_rgb(IMAGES[0])
    for h, w in SIZES:
        ref = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
        d = np.abs(native.resize_bilinear_u8(img, h, w).astype(np.int16)
                   - ref)
        assert d.max() <= 1
    print(f"resize vs cv2: {(d > 0).mean():.4f} of the values 1 level "
          "apart")


def test_resize_is_exact_at_edges_and_odd_shapes():
    rng = np.random.default_rng(0)
    for sh, sw, c, dh, dw in [(1, 1, 3, 5, 7), (37, 53, 1, 11, 100),
                              (5, 3, 4, 5, 3), (2, 9, 3, 1, 1)]:
        img = rng.integers(0, 256, (sh, sw, c), np.uint8)
        n, size = resize_gap(native.resize_bilinear_u8(img, dh, dw),
                             j_native.resize_bilinear_u8(img, dh, dw))
        assert n <= 1, (sh, sw, dh, dw)
    with pytest.raises(ValueError):
        native.resize_bilinear_u8(img.astype(np.float32), 4, 4)


def test_unresized_frames_and_pack_are_bitwise():
    rgb = image_io.read_rgb(IMAGES[3])
    depth = dataset.load_depth(DEPTHS[3])
    s = tf.Sample(rgb, depth, np.zeros((0, 4), np.float32),
                  np.zeros(0, np.int64))
    # the short side already 256: no resize
    assert tf._resize(s, 256, 1333) is s
    h, w = rgb.shape[:2]
    for canvas_hw in ((h, w), (h + 64, w + 128)):
        got = np.zeros((*canvas_hw, 4), np.uint8)
        ref = np.zeros((*canvas_hw, 4), np.uint8)
        native.pack_rgbd_u8(rgb[:, ::-1], depth, got)
        j_native.pack_rgbd_u8(rgb[:, ::-1], depth, ref)
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError):
        native.pack_rgbd_u8(rgb, depth, np.zeros((h, w - 1, 4), np.uint8))


# ------------------------------------------------------------ transforms
def samples(n=4, depth=True, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        f, df = IMAGES[k], DEPTHS[k]
        boxes = np.sort(rng.uniform(0, 256, (3 + k, 4)).astype(np.float32),
                        axis=1)[:, [0, 1, 2, 3]]
        labels = rng.integers(1, 3, 3 + k)
        out.append((tf.Sample(image_io.read_rgb(f),
                              dataset.load_depth(df) if depth else None,
                              boxes, labels, image_id=k + 1,
                              orig_size=(256, 320)),
                    j_tf.Sample(image_io.read_rgb(f),
                                j_dataset.load_depth(df) if depth else None,
                                boxes.copy(), labels.copy(),
                                image_id=k + 1, orig_size=(256, 320))))
    return out


def assert_sample_close(got, ref):
    """Boxes, labels, ids and sizes equal; returns the frames' resize gap
    (values 1 level apart, values)."""
    n, size = resize_gap(got.rgb, ref.rgb)
    if ref.depth is None:
        assert got.depth is None
    else:
        dn, dsize = resize_gap(got.depth, ref.depth)
        n, size = n + dn, size + dsize
    np.testing.assert_array_equal(got.boxes, ref.boxes)
    np.testing.assert_array_equal(got.labels, ref.labels)
    assert (got.image_id, got.orig_size) == (ref.image_id, ref.orig_size)
    return n, size


def test_resize_short_side_and_bucket_shape_equal_jax():
    for h in (1, 37, 256, 480, 1000):
        for w in (1, 53, 320, 640, 1400):
            for short in (224, 600, 800):
                for mx in (512, 1333):
                    assert tf.resize_short_side(h, w, short, mx) == \
                        j_tf.resize_short_side(h, w, short, mx)
            for step, cap in ((128, 1344), (32, 512)):
                assert tf.bucket_shape(h, w, step, cap) == \
                    j_tf.bucket_shape(h, w, step, cap)


def test_hflip_and_pad_u8_equal_jax():
    for (p, j), use_depth, max_boxes in zip(
            samples(3), (True, True, False), (8, 4, 2)):
        pf, jf = tf._hflip(p), j_tf._hflip(j)
        np.testing.assert_array_equal(pf.rgb, jf.rgb)
        np.testing.assert_array_equal(pf.depth, jf.depth)
        np.testing.assert_array_equal(pf.boxes, jf.boxes)
        got = tf.pad_u8(pf, (384, 384), use_depth, max_boxes)
        ref = j_tf.pad_u8(jf, (384, 384), use_depth, max_boxes)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_transforms_equal_jax_under_the_same_rng(train):
    """A clip of four frames: the same flip and short side drawn from the
    same ``rng`` calls, so the same sizes and boxes (bitwise) and images
    within the resize gate."""
    pairs = samples(4)
    if train:
        p_t = tf.TrainTransform(short_sides=(224, 480, 800), max_size=1333)
        j_t = j_tf.TrainTransform(short_sides=(224, 480, 800), max_size=1333)
    else:
        p_t = tf.EvalTransform(short_side=600, max_size=1333)
        j_t = j_tf.EvalTransform(short_side=600, max_size=1333)
    diff, total = 0, 0
    for seed in range(4):
        got = p_t([p for p, _ in pairs], np.random.default_rng(seed))
        ref = j_t([j for _, j in pairs], np.random.default_rng(seed))
        for g, r in zip(got, ref):
            n, size = assert_sample_close(g, r)
            diff, total = diff + n, total + size
    assert_share(diff, total, "transformed frames")


# --------------------------------------------------------------- datasets
def assert_frames_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for field in ("rgb", "depth", "boxes", "labels"):
            np.testing.assert_array_equal(getattr(g, field),
                                          getattr(r, field), err_msg=field)
        assert (g.image_id, tuple(g.orig_size)) == (r.image_id,
                                                    tuple(r.orig_size))


@pytest.mark.parametrize("split", ["train", "val"])
def test_single_frame_dataset_equals_jax(split):
    ann = TRAIN_JSON if split == "train" else VAL_JSON
    got = dataset.CocoDetectionDataset(IMG_DIR, ann, use_depth=True,
                                       train=split == "train")
    ref = j_dataset.CocoDetectionDataset(IMG_DIR, ann, use_depth=True,
                                         train=split == "train")
    assert got.ids == ref.ids and len(got) == len(ref)
    for i in range(0, len(got), 3):
        assert_frames_equal(got[i], ref[i])


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_ref_ids_equal_jax_for_every_image(train):
    ann = TRAIN_JSON if train else VAL_JSON
    for n in (1, 2, 3, 5):
        got = dataset.CocoVideoDataset(IMG_DIR, ann, num_ref_frames=n,
                                       train=train)
        ref = j_dataset.CocoVideoDataset(IMG_DIR, ann, num_ref_frames=n,
                                         train=train)
        for img_id in ref.ids:
            assert got._ref_ids(img_id) == ref._ref_ids(img_id), (n, img_id)


@pytest.fixture(scope="module")
def gap_tree(tmp_path_factory):
    """Six synth frames: a video whose ids skip one (1, 2, 3, 5: the
    reference's id arithmetic reaches the absent 4) and two still images
    (``video_id`` -1)."""
    root = tmp_path_factory.mktemp("gap")
    (root / "images").mkdir()
    (root / "depth_pred").mkdir()
    images, anns = [], []
    for k, img_id in enumerate((1, 2, 3, 5, 10, 11)):
        name = os.path.basename(IMAGES[k])
        shutil.copy(IMAGES[k], root / "images" / name)
        shutil.copy(DEPTHS[k], root / "depth_pred" / name)
        images.append({"id": img_id, "file_name": name, "width": 320,
                       "height": 256,
                       "video_id": 1 if img_id < 10 else -1})
        anns.append({"id": k + 1, "image_id": img_id, "category_id": 1,
                     "bbox": [10 + k, 20, 30, 40], "area": 1200,
                     "iscrowd": 0})
    ann = root / "ann.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": anns,
        "videos": [{"id": 1, "name": "v"}],
        "categories": [{"id": 1, "name": "Hand"}]}))
    return str(root / "images"), str(ann)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_video_dataset_with_still_images_and_an_id_gap_equals_jax(
        gap_tree, train):
    img_dir, ann = gap_tree
    got = dataset.CocoVideoDataset(img_dir, ann, num_ref_frames=2,
                                   use_depth=True, train=train)
    ref = j_dataset.CocoVideoDataset(img_dir, ann, num_ref_frames=2,
                                     use_depth=True, train=train)
    for i in range(len(ref)):
        assert got._ref_ids(got.ids[i]) == ref._ref_ids(ref.ids[i])
        assert_frames_equal(got[i], ref[i])
    # a still image repeats the key frame; the gap falls back to it
    assert [f.image_id for f in got[4]] == [10, 10, 10]
    if train:
        assert 4 in got._ref_ids(3) or 4 in got._ref_ids(5)


def test_cache_mode_decodes_the_same_frames():
    cached = dataset.CocoDetectionDataset(IMG_DIR, VAL_JSON, use_depth=True,
                                          cache_mode=True)
    plain = dataset.CocoDetectionDataset(IMG_DIR, VAL_JSON, use_depth=True)
    assert len(cached._cache) == len(plain)
    for i in (0, 17, 59):
        assert_frames_equal(cached[i], plain[i])


# ----------------------------------------------------------------- loader
def assert_batches_close(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        if k == "image":
            assert_share(*resize_gap(got[k], ref[k], k), "batch")
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
            assert got[k].dtype == ref[k].dtype, k


def loaders(ann, *, video=False, train=True, batch_size=8, n_ref=2,
            **kw):
    """(the port's Loader, the JAX Loader) on synth_rgbd, RGB-D."""
    common = dict(batch_size=batch_size, use_depth=True, shuffle=train,
                  drop_last=train, seed=42)
    common.update(kw)
    short = dict(short_sides=(224, 256, 288, 320), max_size=512)
    out = []
    for ds_mod, tf_mod, ld_mod, extra in (
            (dataset, tf, Loader, {}),
            (j_dataset, j_tf, j_loader.Loader, {"device_preprocess": True})):
        ds = (ds_mod.CocoVideoDataset(IMG_DIR, ann, num_ref_frames=n_ref,
                                      use_depth=True, train=train)
              if video else ds_mod.CocoDetectionDataset(
                  IMG_DIR, ann, use_depth=True, train=train))
        t = (tf_mod.TrainTransform(**short) if train
             else tf_mod.EvalTransform(short_side=256, max_size=512))
        out.append(ld_mod(ds, t, **common, **extra))
    return out


def first(loader, n):
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    return out


def test_shard_indices_equal_jax():
    for n, world, shuffle in ((240, 1, True), (60, 1, False), (7, 3, True)):
        for rank in range(world):
            np.testing.assert_array_equal(
                shard_indices(n, rank, world, shuffle=shuffle, seed=42,
                              epoch=3),
                j_loader.shard_indices(n, rank, world, shuffle=shuffle,
                                       seed=42, epoch=3))


def test_train_loader_equals_jax_over_two_epochs():
    port, jax_ = loaders(TRAIN_JSON)
    assert len(port) == len(jax_) == 30
    for epoch in (0, 1):
        port.set_epoch(epoch)
        jax_.set_epoch(epoch)
        for got, ref in zip(first(port, 4), first(jax_, 4)):
            assert_batches_close(got, ref)
    assert port.timings["batches"] >= 4 and port.timings["decode"] > 0


@pytest.mark.parametrize("drop_last", [True, False])
def test_val_loader_drop_last_equals_jax(drop_last):
    """60 images in batches of 8: 7 batches, or 8 with the last padded by
    wrapping. Eval frames are not resized: images bitwise."""
    port, jax_ = loaders(VAL_JSON, train=False, drop_last=drop_last)
    got, ref = list(port), list(jax_)
    assert len(got) == len(ref) == len(port) == (7 if drop_last else 8)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_bucket_ladder_equals_jax(monkeypatch):
    monkeypatch.setenv("DFVOD_BUCKET_LADDER", "300,400")
    port, jax_ = loaders(TRAIN_JSON)
    assert port.bucket_ladder == (300, 400)
    for got, ref in zip(first(port, 3), first(jax_, 3)):
        assert got["image"].shape[1:3] in ((300, 400), (400, 400))
        assert_batches_close(got, ref)


def test_num_workers_give_identical_batches():
    port0, jax_ = loaders(TRAIN_JSON)
    port2, _ = loaders(TRAIN_JSON, num_workers=2)
    for a, b, r in zip(first(port0, 5), first(port2, 5), first(jax_, 5)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert_batches_close(a, r)


def test_video_loader_clips_key_first_equal_jax():
    """Clips of a key frame and 2 reference frames: rows key-first, the
    key frames in the shuffled order."""
    port, jax_ = loaders(TRAIN_JSON, video=True, batch_size=4)
    keys = [port.dataset.ids[int(j)] for j in shard_indices(
        240, 0, 1, shuffle=True, seed=42, epoch=0)]
    for b, (got, ref) in enumerate(zip(first(port, 3), first(jax_, 3))):
        assert got["image"].shape[0] == 12
        assert_batches_close(got, ref)
        assert got["image_id"].reshape(4, 3)[:, 0].tolist() == \
            keys[4 * b:4 * b + 4]


class Exploding:
    """A dataset whose fourth item raises."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        if i == 3:
            raise RuntimeError("bad item 3")
        return self.base[i]


@pytest.mark.parametrize("num_workers", [0, 2])
def test_a_workers_exception_reaches_the_consumer(num_workers):
    base = dataset.CocoDetectionDataset(IMG_DIR, VAL_JSON, use_depth=True,
                                        train=False)
    loader = Loader(Exploding(base), tf.EvalTransform(256, 512),
                    batch_size=2, use_depth=True, shuffle=False,
                    num_workers=num_workers)
    seen = 0
    with pytest.raises(RuntimeError, match="bad item 3"):
        for _ in loader:
            seen += 1
    assert seen == 1


def test_first_batch_and_cpu_tensors_equal_the_host_batch():
    port, _ = loaders(VAL_JSON, train=False)
    host = next(iter(port))
    np.testing.assert_array_equal(port.first_batch()["image"], host["image"])
    port.device = torch.device("cpu")
    tensors = next(iter(port))
    for k, v in host.items():
        assert torch.is_tensor(tensors[k])
        np.testing.assert_array_equal(tensors[k].numpy(), v, err_msg=k)


def test_device_normalize_equals_jax_normalize_and_pad():
    """The port ships uint8 and normalizes on the device; the JAX host f32
    path (``normalize_and_pad``) on the same unresized frames gives the
    same image within 1e-6 and the same padding mask."""
    port, _ = loaders(VAL_JSON, train=False)
    ds = j_dataset.CocoDetectionDataset(IMG_DIR, VAL_JSON, use_depth=True,
                                        train=False)
    jl = j_loader.Loader(ds, j_tf.EvalTransform(short_side=256, max_size=512),
                         batch_size=8, use_depth=True, shuffle=False,
                         seed=42, device_preprocess=False)
    got, ref = next(iter(port)), next(iter(jl))
    img, mask = device_normalize(torch.from_numpy(got["image"]),
                                 torch.from_numpy(got["size"]))
    np.testing.assert_allclose(img.numpy(), ref["image"], atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(mask.numpy(), ref["mask"])


def test_loader_digest_is_chip_smokes_constant_and_close_to_jax():
    """The batches ``chip_smoke.py`` digests on the card
    (``Synth_LateFusion.sh``'s loaders: 3 train batches of epoch 0, 2 val
    batches) give its constant on the CPU, and agree with the JAX Loader's
    under the same configuration (resize gate)."""
    from dfvod_tpu.cli import flags as j_flags
    cfg = chip_smoke.synth_recipe_cfg()
    batches = chip_smoke.loader_batches(cfg)
    assert chip_smoke.loader_digest(batches) == \
        chip_smoke.SYNTH_RGBD_LOADER_SHA256
    _, argv = chip_smoke.recipe_argv("Synth_LateFusion.sh",
                                     COCO_PATH=chip_smoke.SYNTH_RGBD)
    jcfg = j_flags.config_from_args(j_flags.get_args_parser().parse_args(
        argv))
    ref = []
    for split, n in (("train", 3), ("val", 2)):
        jl = j_loader.Loader(
            j_dataset.build_dataset(split, jcfg),
            j_dataset.make_transform(split == "train", jcfg),
            batch_size=jcfg.train.batch_size, max_boxes=jcfg.data.max_boxes,
            use_depth=True, seed=jcfg.train.seed, shuffle=split == "train",
            drop_last=split == "train", device_preprocess=True)
        ref += first(jl, n)
    for got, r in zip(batches, ref):
        assert_batches_close(got, r)


def test_data_layer_refusals_name_their_slice():
    ds = dataset.CocoDetectionDataset(IMG_DIR, VAL_JSON)
    with pytest.raises(NotImplementedError, match="item 14"):
        Loader(ds, tf.EvalTransform(), batch_size=2, world=2)
    with pytest.raises(NotImplementedError, match="s2d slice"):
        Loader(ds, tf.EvalTransform(), batch_size=2, pack_s2d=True)
    with pytest.raises(NotImplementedError, match="photometric slice"):
        tf.TrainTransform(strong_aug=True)
    with pytest.raises(NotImplementedError, match="segmentation slice"):
        dataset.CocoDetectionDataset(IMG_DIR, VAL_JSON, return_masks=True)
    cfg = chip_smoke.synth_recipe_cfg()
    for data, model in ((dict(dataset_file="coco_panoptic"), {}),
                        ({}, dict(masks=True))):
        bad = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, **data),
            model=dataclasses.replace(cfg.model, **model))
        with pytest.raises(NotImplementedError, match="segmentation slice"):
            dataset.build_dataset("val", bad)
