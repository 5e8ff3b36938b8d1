"""The port's mask and panoptic data path against the JAX package's: COCO
RLE decoding, the polygon fill against PIL's, ``prepare_targets`` with
masks, the masks through the transforms and the loader's collate
(``tests/test_masks_dataset.py``'s cases, each held against the JAX
function), and ``data/panoptic.py`` (``tests/test_panoptic.py``'s cases:
the id codec, ``masks_to_boxes``, PQ, the dataset through the port's PNG
reader, the evaluator with its PNG artifact, ``build_dataset``'s
``coco_panoptic`` route).

The polygon fill equals PIL's ``ImageDraw.polygon(fill=1, outline=1)`` on
every annotation of ``datasets/synth_rgbd`` and on random convex
polygons; on random concave ones it may differ by a pixel (ROADMAP.md
Queue 3, known differences), which the test bounds.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image, ImageDraw

from dfvod_tpu.data import dataset as j_dataset
from dfvod_tpu.data import panoptic as j_panoptic
from dfvod_tpu.data import transforms as j_transforms
from dfvod_tpu.data.loader import Loader as JLoader
from dfvod_tpu_torch.data import dataset, masks, panoptic, transforms
from dfvod_tpu_torch.data.loader import Loader, to_train_batch
from dfvod_tpu_torch.data.photometric import MinIoURandomCrop
from dfvod_tpu_torch.utils.config import Config, DataConfig, ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, "datasets", "synth_rgbd", "coco", "annotations")


# -------------------------------------------------------------------- RLE
@pytest.mark.parametrize("s", ["32", "111", "1110", "253L",
                               chr(48 + 36) + chr(48 + 3), "1a3Ob0Q1n0"],
                         ids=["simple", "raw3", "delta", "negative",
                              "continuation", "mixed"])
def test_rle_counts_decode_as_jax(s):
    assert masks.decode_rle_counts(s) == j_dataset._decode_rle_counts(s)
    assert masks.decode_rle_counts(s.encode()) == \
        j_dataset._decode_rle_counts(s)


@pytest.mark.parametrize("seg", [
    {"size": [2, 3], "counts": [1, 2, 3]},
    {"size": [2, 3], "counts": "123"},
    {"size": [7, 5], "counts": [3, 4, 2, 9, 1, 6, 10]},
    {"size": [6, 9], "counts": "1a3Ob0Q1n0"}],
    ids=["uncompressed", "compressed", "uncompressed_7x5", "compressed_6x9"])
def test_rle_masks_equal_jax(seg):
    """Column-major runs, cut to (h, w) where the frame is smaller."""
    h, w = seg["size"]
    for hw in ((h, w), (h - 1, w - 1)):
        got = masks.rasterize_segmentation(seg, *hw)
        np.testing.assert_array_equal(
            got, j_dataset.rasterize_segmentation(seg, *hw))
        assert got.dtype == np.uint8


# --------------------------------------------------------------- polygons
def pil_fill(seg, h, w):
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in seg:
        draw.polygon([(poly[i], poly[i + 1])
                      for i in range(0, len(poly) - 1, 2)], outline=1,
                     fill=1)
    return np.asarray(img)


@pytest.mark.parametrize("seg", [
    [[10, 10, 20, 10, 20, 20, 10, 20]],
    [[2, 2, 8, 2, 8, 8, 2, 8], [20, 20, 26, 20, 26, 26, 20, 26]],
    [[5, 5, 15, 5, 15, 15, 5, 15]], [[40, 40, 41, 40, 41, 41]],
    [[8, 8, 24, 8, 24, 20, 8, 20]], [[1.5, 2.5, 30.7, 4.2, 12.9, 29.6]],
    [[-4.5, 3, 40, -2.2, 45.9, 50, 3, 40]], [[0, 0, 1, 1]]],
    ids=["square", "two_squares", "keep_filter", "degenerate",
         "loader_box", "float_triangle", "clipped", "too_few"])
def test_polygons_equal_jax_and_pil(seg):
    """``tests/test_masks_dataset.py``'s polygons and a few more: the
    JAX package's rasterization (PIL) pixel for pixel."""
    got = masks.rasterize_segmentation(seg, 32, 48)
    np.testing.assert_array_equal(
        got, j_dataset.rasterize_segmentation(seg, 32, 48))
    if len(seg[0]) >= 6:
        np.testing.assert_array_equal(got, pil_fill(seg, 32, 48))


def test_synth_rgbd_polygons_equal_pil():
    """Every annotation of ``datasets/synth_rgbd`` (480 train, 120 val;
    each a polygon) fills as the JAX package fills it."""
    n = 0
    for split in ("train", "val"):
        with open(os.path.join(SYNTH, f"{split}.json")) as f:
            d = json.load(f)
        sizes = {i["id"]: (i["height"], i["width"]) for i in d["images"]}
        for a in d["annotations"]:
            h, w = sizes[a["image_id"]]
            np.testing.assert_array_equal(
                masks.rasterize_segmentation(a["segmentation"], h, w),
                j_dataset.rasterize_segmentation(a["segmentation"], h, w),
                err_msg=str(a["id"]))
            n += 1
    assert n == 600


def random_polygon(rng, S, convex):
    """A star-shaped polygon around a random centre: on a circle when
    convex, each vertex at its own radius when not; float vertices, some
    outside the frame."""
    n = int(rng.integers(3, 16))
    c = rng.uniform(0.1 * S, 0.9 * S, 2)
    a = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(2, 0.4 * S) if convex else rng.uniform(1, 0.4 * S, n)
    return [np.stack([c[0] + r * np.cos(a), c[1] + r * np.sin(a)],
                     1).reshape(-1).tolist()]


@pytest.mark.parametrize("S", [50, 300])
def test_random_polygons_against_pil(S):
    """200 convex polygons fill exactly as PIL fills them; of 200 concave
    ones at most 5% differ, each by at most 2 pixels (measured: 4 of 200
    at S = 50 and 2 of 200 at S = 400, one pixel each)."""
    rng = np.random.default_rng(S)
    for _ in range(200):
        seg = random_polygon(rng, S, convex=True)
        np.testing.assert_array_equal(
            masks.rasterize_segmentation(seg, S, S), pil_fill(seg, S, S))
    differ = []
    for _ in range(200):
        seg = random_polygon(rng, S, convex=False)
        d = int((masks.rasterize_segmentation(seg, S, S)
                 != pil_fill(seg, S, S)).sum())
        if d:
            differ.append(d)
    assert len(differ) <= 10 and max(differ, default=0) <= 2, differ


# ------------------------------------------------------------ the targets
ANNS = [
    {"bbox": [5, 5, 10, 10], "category_id": 1, "iscrowd": 0,
     "segmentation": [[5, 5, 15, 5, 15, 15, 5, 15]]},
    {"bbox": [40, 40, 0, 0], "category_id": 2, "iscrowd": 0,
     "segmentation": [[40, 40, 41, 40, 41, 41]]},
    {"bbox": [20, 2, 30, 12], "category_id": 2, "iscrowd": 1,
     "segmentation": {"size": [64, 64], "counts": [100, 20, 3000]}},
    {"bbox": [30, 30, 20, 25], "category_id": 1, "iscrowd": 0,
     "segmentation": {"size": [64, 64], "counts": "1a3Ob0Q1n0"}}]


@pytest.mark.parametrize("anns", [ANNS, []], ids=["keep_filter", "empty"])
def test_prepare_targets_with_masks_equal_jax(anns):
    """Crowd and degenerate boxes dropped with their masks; without
    ``return_masks`` the two-value contract stays."""
    got = dataset.prepare_targets(anns, 64, 64, return_masks=True)
    want = j_dataset.prepare_targets(anns, 64, 64, return_masks=True)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].shape == (len(got[0]), 64, 64)
    assert len(dataset.prepare_targets(anns, 64, 64)) == 2


def sample_pair(h=48, w=64):
    m = np.zeros((2, h, w), np.uint8)
    m[0, 8:20, 8:24] = 1
    m[1, 30:41, 5:9] = 1
    kw = dict(rgb=np.random.default_rng(0).integers(
        0, 255, (h, w, 3), dtype=np.uint8),
        depth=np.zeros((h, w), np.uint8),
        boxes=np.array([[8, 8, 24, 20], [5, 30, 9, 41]], np.float32),
        labels=np.array([1, 2], np.int64), masks=m, orig_size=(h, w))
    return transforms.Sample(**kw), j_transforms.Sample(**kw)


@pytest.mark.parametrize("size", [(96, 200), (37, 60), (48, 64)],
                         ids=["up_2x", "down_odd", "same"])
def test_mask_resize_and_flip_equal_jax(size, monkeypatch):
    """The masks through ``_resize`` (torch's legacy nearest) and
    ``_hflip`` equal JAX's (its C++ resize path, ``DFVOD_CV2=0``)."""
    monkeypatch.setenv("DFVOD_CV2", "0")
    p, j = sample_pair()
    np.testing.assert_array_equal(transforms._resize(p, *size).masks,
                                  j_transforms._resize(j, *size).masks)
    np.testing.assert_array_equal(transforms._hflip(p).masks,
                                  j_transforms._hflip(j).masks)


def test_pad_u8_emits_padded_masks_as_jax():
    """(max_boxes, ph, pw) uint8, the instances top-left, the padding
    slots empty; no masks, no key."""
    p, j = sample_pair()
    got = transforms.pad_u8(p, (128, 128), True, 8)
    want = j_transforms.pad_u8(j, (128, 128), True, 8)
    np.testing.assert_array_equal(got["masks"], want["masks"])
    assert got["masks"].shape == (8, 128, 128)
    assert got["masks"][0].sum() == 12 * 16 and got["masks"][2:].sum() == 0
    p.masks = None
    assert "masks" not in transforms.pad_u8(p, (64, 64), True, 8)


def test_the_crop_cuts_the_masks_with_the_frame():
    """``MinIoURandomCrop`` crops the masks to the frame's patch (the JAX
    package leaves them whole, ROADMAP.md known differences): the cropped
    frame's mask is the mask's crop at the same offset."""
    p, _ = sample_pair()
    rng = np.random.default_rng(3)
    for _ in range(20):
        (out,) = MinIoURandomCrop()([p], rng)
        h, w = out.rgb.shape[:2]
        assert out.masks.shape == (2, h, w)
        if (h, w) != p.rgb.shape[:2]:
            ys, xs = np.nonzero((p.rgb == out.rgb[0, 0]).all(-1))
            found = [(y, x) for y, x in zip(ys, xs)
                     if np.array_equal(p.rgb[y:y + h, x:x + w], out.rgb)]
            y0, x0 = found[0]
            np.testing.assert_array_equal(out.masks,
                                          p.masks[:, y0:y0 + h, x0:x0 + w])
            return
    pytest.fail("no crop drawn in 20 tries")


# ----------------------------------------------------------------- loader
@pytest.fixture
def seg_coco_dir(tmp_path):
    """``tests/test_masks_dataset.py``'s tree: 4 JPEG frames with a
    polygon each, and their depth maps."""
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for sub in ("images", "depth_pred"):
        (tmp_path / sub).mkdir()
    for i in range(4):
        name = f"im{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), np.uint8)
                        ).save(tmp_path / "images" / name)
        Image.fromarray(rng.integers(0, 255, (48, 64), np.uint8)
                        ).save(tmp_path / "depth_pred" / name)
        images.append({"id": i + 1, "file_name": f"images/{name}",
                       "width": 64, "height": 48})
        annotations.append({"id": i + 1, "image_id": i + 1,
                            "category_id": 1, "bbox": [8, 8, 16, 12],
                            "area": 192, "iscrowd": 0,
                            "segmentation": [[8, 8, 24, 8, 24, 20, 8, 20]]})
    ann = tmp_path / "train.json"
    ann.write_text(json.dumps({
        "images": images, "annotations": annotations,
        "categories": [{"id": 1, "name": "Hand"}]}))
    return tmp_path, str(ann)


def test_loader_batch_masks_equal_jax(seg_coco_dir, monkeypatch):
    """``return_masks``: the port's loader batch holds ``masks`` (B, T,
    H, W) on the canvas, equal to the JAX loader's (same transform draws,
    ``DFVOD_CV2=0``), and ``to_train_batch`` passes them on; without it
    the samples carry none."""
    monkeypatch.setenv("DFVOD_CV2", "0")
    root, ann = seg_coco_dir
    kw = dict(batch_size=2, max_boxes=4, shuffle=False, use_depth=True)
    ds = dataset.CocoDetectionDataset(str(root), ann, train=True,
                                      use_depth=True, return_masks=True)
    batch = Loader(ds, transforms.TrainTransform(short_sides=[48],
                                                 max_size=64),
                   prefetch=0, **kw).first_batch()
    jds = j_dataset.CocoDetectionDataset(str(root), ann, train=True,
                                         use_depth=True, return_masks=True)
    want = JLoader(jds, j_transforms.TrainTransform(short_sides=[48],
                                                    max_size=64),
                   prefetch=0, device_preprocess=True, **kw).first_batch()
    assert batch["masks"].shape[:2] == (2, 4)
    assert batch["masks"].shape[2:] == batch["image"].shape[1:3]
    np.testing.assert_array_equal(batch["masks"], np.asarray(want["masks"]))
    m = batch["masks"]
    assert m[0, 0].sum() > 0 and m[0, 1].sum() == 0
    assert to_train_batch(batch)["masks"] is batch["masks"]
    plain = dataset.CocoDetectionDataset(str(root), ann, train=True)
    assert plain[0][0].masks is None
    assert "masks" not in to_train_batch(
        Loader(plain, transforms.TrainTransform(short_sides=[48],
                                                max_size=64),
               batch_size=2, max_boxes=4, shuffle=False,
               prefetch=0).first_batch())


# --------------------------------------------------------------- panoptic
def test_id_codec_and_boxes_equal_jax():
    ids = np.array([[0, 1, 255], [256, 70000, 256 ** 3 - 1]], np.uint32)
    np.testing.assert_array_equal(panoptic.id2rgb(ids),
                                  j_panoptic.id2rgb(ids))
    np.testing.assert_array_equal(panoptic.rgb2id(panoptic.id2rgb(ids)),
                                  ids)
    m = np.zeros((3, 8, 10), bool)
    m[0, 2:5, 3:7] = True
    m[1, 0:1, 9:10] = True
    np.testing.assert_array_equal(panoptic.masks_to_boxes(m),
                                  j_panoptic.masks_to_boxes(m))
    assert panoptic.masks_to_boxes(np.zeros((0, 4, 4), bool)).shape == (0, 4)


def _seg(i, cat, crowd=0):
    return {"id": i, "category_id": cat, "iscrowd": crowd}


def pq_cases():
    """``tests/test_panoptic.py``'s PQ cases and a random one."""
    halves = np.zeros((10, 10), np.int32)
    halves[:5], halves[5:] = 1, 2
    wide = np.zeros((10, 10), np.int32)
    wide[:, :6] = 1
    thin, grown = np.zeros((10, 10), np.int32), np.zeros((10, 10), np.int32)
    thin[:, :3], grown[:, :5] = 1, 1
    left = np.zeros((10, 10), np.int32)
    left[:, :5] = 1
    ones = np.ones((10, 10), np.int32)
    rng = np.random.default_rng(8)
    gt_r, pred_r = rng.integers(0, 6, (30, 40)), rng.integers(0, 6, (30, 40))
    gt_r[:12, :15] = pred_r[:12, :15] = 3
    return {
        "perfect": (halves, [_seg(1, 7), _seg(2, 8)], halves.copy(),
                    [_seg(1, 7), _seg(2, 8)]),
        "category_mismatch": (ones, [_seg(1, 7)], ones.copy(), [_seg(1, 8)]),
        "iou_at_half": (wide, [_seg(1, 7)], thin, [_seg(1, 7)]),
        "iou_above_half": (wide, [_seg(1, 7)], grown, [_seg(1, 7)]),
        "void_out_of_union": (left, [_seg(1, 7)], ones, [_seg(1, 7)]),
        "crowd": (ones, [_seg(1, 7, crowd=1)], ones.copy(), [_seg(1, 7)]),
        "on_void": (np.zeros((10, 10), np.int32), [], ones, [_seg(1, 7)]),
        "random": (gt_r, [_seg(i, i % 3, crowd=int(i == 4))
                          for i in range(1, 6)],
                   pred_r, [_seg(i, (i + 1) % 3 if i == 2 else i % 3)
                            for i in range(1, 6)]),
    }


@pytest.mark.parametrize("name", list(pq_cases()))
def test_pq_equals_jax(name):
    """The per-category counts and the All / Things / Stuff averages."""
    gt, gs, pred, ps = pq_cases()[name]
    got, want = {}, {}
    panoptic.pq_compute_single(gt, gs, pred, ps, got)
    j_panoptic.pq_compute_single(gt, gs, pred, ps, want)
    assert got == want
    things = {7: True, 8: False, 0: True, 1: False, 2: True}
    for kw in ({}, {"categories": things, "isthing": True},
               {"categories": things, "isthing": False}):
        assert panoptic.pq_average(got, **kw) == \
            j_panoptic.pq_average(want, **kw)


@pytest.fixture
def pan_tree(tmp_path):
    """``tests/test_panoptic.py``'s tree: two JPEG frames and their
    PNG id maps (written by PIL) under the reference's layout."""
    img_dir = tmp_path / "val2017"
    ann_dir = tmp_path / "pan" / "panoptic_val2017"
    img_dir.mkdir()
    ann_dir.mkdir(parents=True)
    (tmp_path / "pan" / "annotations").mkdir()
    rng = np.random.default_rng(0)
    images, annotations = [], []
    for i in (1, 2):
        name = f"img_{i}"
        Image.fromarray(rng.integers(0, 255, (16, 20, 3), np.uint8)
                        ).save(img_dir / f"{name}.jpg")
        id_map = np.zeros((16, 20), np.uint32)
        id_map[2:8, 3:9] = 5
        id_map[10:14, 10:18] = 9 + 256 * i
        Image.fromarray(j_panoptic.id2rgb(id_map)).save(
            ann_dir / f"{name}.png")
        images.append({"id": i, "file_name": f"{name}.png", "height": 16,
                       "width": 20})
        annotations.append({
            "image_id": i, "file_name": f"{name}.png",
            "segments_info": [
                {"id": 5, "category_id": 1, "iscrowd": 0, "area": 36},
                {"id": 9 + 256 * i, "category_id": 2, "iscrowd": 0,
                 "area": 32}]})
    ann_file = tmp_path / "pan" / "annotations" / "panoptic_val2017.json"
    ann_file.write_text(json.dumps({"images": images,
                                    "annotations": annotations}))
    return tmp_path, img_dir, ann_dir, ann_file


def test_panoptic_dataset_equals_jax(pan_tree):
    """Frames (the port's JPEG decoder, bitwise PIL's), masks from the
    PNG id maps, labels, boxes, iscrowd, area, image id; also through
    ``build_dataset``'s ``coco_panoptic`` route."""
    root, img_dir, ann_dir, ann_file = pan_tree
    ds = panoptic.CocoPanopticDataset(str(img_dir), str(ann_dir),
                                      str(ann_file))
    jds = j_panoptic.CocoPanopticDataset(str(img_dir), str(ann_dir),
                                         str(ann_file))
    cfg = Config(model=ModelConfig(masks=True),
                 data=DataConfig(coco_path=str(root),
                                 coco_panoptic_path=str(root / "pan"),
                                 dataset_file="coco_panoptic"))
    routed = dataset.build_dataset("val", cfg)
    assert isinstance(routed, panoptic.CocoPanopticDataset)
    assert len(ds) == len(jds) == len(routed) == 2
    for i in range(2):
        (rgb, tgt), (jrgb, jtgt) = ds[i], jds[i]
        np.testing.assert_array_equal(rgb, jrgb)
        assert set(tgt) == set(jtgt)
        for k in tgt:
            np.testing.assert_array_equal(tgt[k], jtgt[k], err_msg=k)
        np.testing.assert_array_equal(routed[i][1]["masks"], tgt["masks"])
    assert ds[0][1]["masks"][0].sum() == 36
    no_masks = panoptic.CocoPanopticDataset(
        str(img_dir), str(ann_dir), str(ann_file), return_masks=False)
    assert "masks" not in no_masks[0][1]


def test_panoptic_evaluator_end_to_end(pan_tree, tmp_path):
    """Ground truth against itself through the evaluator: PQ 1 as in JAX,
    and each prediction written as an id2rgb PNG that PIL reads back."""
    _, img_dir, ann_dir, ann_file = pan_tree
    ds = panoptic.CocoPanopticDataset(str(img_dir), str(ann_dir),
                                      str(ann_file))
    ev = panoptic.PanopticEvaluator(is_thing_map={1: True, 2: False},
                                    output_dir=str(tmp_path / "out"))
    jev = j_panoptic.PanopticEvaluator(is_thing_map={1: True, 2: False})
    for i in range(len(ds)):
        _, tgt = ds[i]
        id_map = np.zeros(tgt["masks"].shape[1:], np.int32)
        segs = []
        for j, (m, lab) in enumerate(zip(tgt["masks"], tgt["labels"]), 1):
            id_map[m] = j
            segs.append({"id": j, "category_id": int(lab)})
        ev.update(id_map, segs, id_map, segs, file_name=f"img_{i}.png")
        jev.update(id_map, segs, id_map, segs)
        png = np.asarray(Image.open(tmp_path / "out" / f"img_{i}.png"))
        np.testing.assert_array_equal(j_panoptic.rgb2id(png), id_map)
    ev.synchronize_between_processes()
    assert ev.summarize() == jev.summarize()
    assert ev.summarize()["All"]["pq"] == pytest.approx(1.0)


def test_samples_keep_their_fields_through_replace():
    """The port's ``Sample`` carries ``masks`` as the JAX one does, so
    every ``dataclasses.replace`` of a transform keeps them."""
    names = [f.name for f in dataclasses.fields(transforms.Sample)]
    assert names == [f.name for f in dataclasses.fields(j_transforms.Sample)]
