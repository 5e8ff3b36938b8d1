"""The port's COCO index and bbox evaluator (``dfvod_tpu_torch/data/coco.py``,
``coco_eval.py``) against the JAX package's (``dfvod_tpu/data/coco.py``,
``coco_eval.py``): the same detections give equal precision and recall
arrays and equal ``summarize()`` stats (both float64 numpy, so equality is
exact). Detections are seeded with numpy over the in-repo annotations
``datasets/synth_rgbd/coco/annotations/val.json`` (60 images, 2
categories; no image is read), the hand-built cases of
``tests/test_coco_eval.py`` and seeded scenes of
``tests/test_coco_eval_fuzz.py``."""
import os

import numpy as np
import pytest

from dfvod_tpu.data import coco as j_coco
from dfvod_tpu.data import coco_eval as j_coco_eval
from dfvod_tpu_torch.data import coco, coco_eval

VAL_JSON = os.path.join(os.path.dirname(__file__), "..", "datasets",
                        "synth_rgbd", "coco", "annotations", "val.json")


def evaluate_both(port_gt, jax_gt, preds, img_ids=None):
    """(port evaluator, JAX evaluator) after the same updates, accumulated
    and summarized."""
    out = []
    for mod, gt in ((coco_eval, port_gt), (j_coco_eval, jax_gt)):
        ev = mod.COCOEvaluator(gt, img_ids=img_ids)
        for p in preds:
            ev.update(p)
        ev.synchronize_between_processes()
        ev.accumulate()
        ev.stats = ev.summarize(verbose=False)
        out.append(ev)
    return out


def assert_same(port, ref):
    np.testing.assert_array_equal(port.precision, ref.precision)
    np.testing.assert_array_equal(port.recall, ref.recall)
    assert port.stats == ref.stats
    assert list(port.stats) == ["mAP", "mAP_50", "mAP_75", "mAP_small",
                                "mAP_medium", "mAP_large"]


def jittered_detections(gt, seed, n_noise=6, drop=0.2, batch=8):
    """Per-batch {image_id: {boxes xyxy, scores, labels}}: jittered copies
    of the ground truth (some dropped, some given the other category),
    noise boxes, and scores with ties, in batches of ``batch`` ids; the
    last batch repeats ids from the first."""
    rng = np.random.default_rng(seed)
    ids = gt.getImgIds()
    per_img = {}
    for i in ids:
        boxes, scores, labels = [], [], []
        for a in gt.imgToAnns[i]:
            if rng.uniform() < drop:
                continue
            x, y, w, h = a["bbox"]
            j = rng.normal(0, 0.08, 4) * [w, h, w, h]
            boxes.append([x + j[0], y + j[1], x + w + j[2], y + h + j[3]])
            scores.append(rng.choice([0.9, 0.7, rng.uniform(0.3, 1.0)]))
            labels.append(a["category_id"] if rng.uniform() < 0.9 else
                          3 - a["category_id"])
        for _ in range(rng.integers(0, n_noise)):
            x, y = rng.uniform(0, 280, 2)
            w, h = rng.uniform(4, 120, 2)
            boxes.append([x, y, x + w, y + h])
            scores.append(rng.uniform(0.0, 0.8))
            labels.append(int(rng.integers(1, 3)))
        per_img[i] = {"boxes": np.array(boxes, np.float32).reshape(-1, 4),
                      "scores": np.array(scores, np.float32),
                      "labels": np.array(labels, np.int64)}
    batches = [ids[k:k + batch] for k in range(0, len(ids), batch)]
    batches[-1] = batches[-1] + batches[0][:batch - len(batches[-1])]
    return [{i: per_img[i] for i in b} for b in batches]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluator_matches_jax_on_val_json(seed):
    """Seeded detections over val.json's 60 images, in batches of 8 with
    the last one padded by repeated ids."""
    port_gt, jax_gt = coco.COCO(VAL_JSON), j_coco.COCO(VAL_JSON)
    preds = jittered_detections(port_gt, seed)
    port, ref = evaluate_both(port_gt, jax_gt, preds)
    assert_same(port, ref)
    assert len(port.detections) == len(ref.detections)
    assert 0.0 < port.stats["mAP"] < 1.0


def test_evaluator_matches_jax_with_ground_truth_as_detections():
    """Every ground-truth box as a detection: both give mAP 1.0."""
    port_gt, jax_gt = coco.COCO(VAL_JSON), j_coco.COCO(VAL_JSON)
    preds = [{i: {"boxes": np.array([[x, y, x + w, y + h] for x, y, w, h in
                                     (a["bbox"] for a in gt_anns)],
                                    np.float64).reshape(-1, 4),
                  "scores": np.linspace(1.0, 0.5, len(gt_anns)),
                  "labels": np.array([a["category_id"] for a in gt_anns])}
              for i, gt_anns in port_gt.imgToAnns.items()}]
    port, ref = evaluate_both(port_gt, jax_gt, preds)
    assert_same(port, ref)
    assert port.stats["mAP"] == port.stats["mAP_50"] == 1.0


def make_gt(mod, boxes_per_img, cat_id=1):
    """``tests/test_coco_eval.py::make_gt`` for either package's COCO."""
    images, anns = [], []
    ann_id = 1
    for img_id, boxes in boxes_per_img.items():
        images.append({"id": img_id, "width": 100, "height": 100,
                       "file_name": f"{img_id}.jpg"})
        for b in boxes:
            crowd = len(b) == 5 and b[4]
            anns.append({"id": ann_id, "image_id": img_id,
                         "category_id": cat_id, "bbox": list(b[:4]),
                         "area": b[2] * b[3], "iscrowd": int(crowd)})
            ann_id += 1
    return mod.COCO(dataset={"images": images, "annotations": anns,
                             "categories": [{"id": cat_id, "name": "hand"}]})


def preds(dets):
    """dets: {img_id: [(x1, y1, x2, y2, score), ...]}"""
    return {i: {"boxes": np.array([d[:4] for d in ds], np.float64
                                  ).reshape(-1, 4),
                "scores": np.array([d[4] for d in ds], np.float64),
                "labels": np.ones(len(ds), int)}
            for i, ds in dets.items()}


# the cases of tests/test_coco_eval.py: ground truth, detections
CASES = {
    "perfect": ({1: [(10, 10, 20, 20)], 2: [(30, 30, 10, 10)]},
                {1: [(10, 10, 30, 30, 0.9)], 2: [(30, 30, 40, 40, 0.8)]}),
    "miss": ({1: [(10, 10, 20, 20)]}, {1: [(70, 70, 90, 90, 0.9)]}),
    "iou_threshold_cut": ({1: [(0, 0, 10, 10)]}, {1: [(0, 0, 10, 7, 0.9)]}),
    "duplicate": ({1: [(0, 0, 10, 10)]},
                  {1: [(0, 0, 10, 10, 0.9), (0, 0, 10, 10, 0.8)]}),
    "crowd": ({1: [(0, 0, 50, 50, True), (60, 60, 10, 10)]},
              {1: [(5, 5, 15, 15, 0.9), (60, 60, 70, 70, 0.8)]}),
    "score_order": ({1: [(0, 0, 10, 10)]},
                    {1: [(50, 50, 60, 60, 0.95), (0, 0, 10, 10, 0.5)]}),
    "area_ranges": ({1: [(0, 0, 10, 10), (0, 0, 40, 40), (0, 0, 99, 99)]},
                    {1: [(0, 0, 10, 10, 0.9), (1, 1, 41, 41, 0.6),
                         (0, 0, 50, 99, 0.7)]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluator_matches_jax_on_hand_built_cases(case):
    gt, dets = CASES[case]
    port, ref = evaluate_both(make_gt(coco, gt), make_gt(j_coco, gt),
                              [preds(dets)])
    assert_same(port, ref)


class FakeCOCO:
    """``tests/test_coco_eval_fuzz.py``'s shim: imgToAnns and cats only."""

    def __init__(self, anns_by_img, cat_ids):
        self.imgToAnns = anns_by_img
        self.cats = {c: {"id": c} for c in cat_ids}

    def getCatIds(self):
        return sorted(self.cats)

    def getImgIds(self):
        return sorted(self.imgToAnns)


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_evaluator_matches_jax_on_fuzz_scenes(seed):
    """Scenes drawn as ``test_coco_eval_fuzz.py::_random_scene`` draws
    them (jittered ground truth and noise, two categories)."""
    from test_coco_eval_fuzz import _random_scene
    img_ids, cat_ids, anns_by_img, gts, dets = _random_scene(
        np.random.default_rng(seed))
    assert gts
    gt = FakeCOCO(anns_by_img, cat_ids)
    p = {}
    for img in img_ids:
        mine = [d for d in dets if d[0] == img]
        p[img] = {"boxes": np.array([d[2] for d in mine]).reshape(-1, 4),
                  "scores": np.array([d[3] for d in mine]),
                  "labels": np.array([d[1] for d in mine], np.int64)}
    port, ref = evaluate_both(gt, gt, [p], img_ids=img_ids)
    assert_same(port, ref)


def test_iou_matches_jax():
    rng = np.random.default_rng(4)
    d = rng.uniform(0, 50, (7, 4))
    g = rng.uniform(0, 50, (5, 4))
    crowd = np.array([0, 1, 0, 0, 1])
    np.testing.assert_array_equal(coco_eval.bbox_iou_xywh(d, g, crowd),
                                  j_coco_eval.bbox_iou_xywh(d, g, crowd))


def test_cocovid_indexes_match_jax():
    port, ref = coco.CocoVID(VAL_JSON), j_coco.CocoVID(VAL_JSON)
    assert port.get_vid_ids() == ref.get_vid_ids()
    assert len(port.get_vid_ids()) == 15
    for v in port.get_vid_ids():
        assert port.get_img_ids_from_vid(v) == ref.get_img_ids_from_vid(v)
    assert dict(port.instancesToImgs) == dict(ref.instancesToImgs)
    assert dict(port.vidToInstances) == dict(ref.vidToInstances)
    assert port.getImgIds() == ref.getImgIds()
    assert port.getCatIds() == ref.getCatIds() == [1, 2]
    assert port.getAnnIds(imgIds=[241, 242], catIds=[1]) == \
        ref.getAnnIds(imgIds=[241, 242], catIds=[1])
    assert port.getImgIds(catIds=[2]) == ref.getImgIds(catIds=[2])
    res = [{"image_id": 241, "category_id": 1, "bbox": [1, 2, 3, 4],
            "score": 0.5}]
    assert port.loadRes(res).dataset == ref.loadRes(res).dataset


def test_synchronize_is_a_no_op_for_one_process_and_raises_for_more(
        monkeypatch):
    """Uninitialized ``torch.distributed`` or one process: nothing to
    merge. More than one (the all-gather stood in for, two ranks whose
    shards both hold image 242, as wrapped shards do): every rank's
    detections in rank order, one copy of each image's, the lowest rank's.
    The merge no longer raises since data parallelism came; the name is
    kept. The real all-gather over two processes is in
    ``tests/test_torch_parallel.py``."""
    import torch.distributed as dist
    ev = coco_eval.COCOEvaluator(coco.COCO(VAL_JSON))
    ev.synchronize_between_processes()
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    ev.synchronize_between_processes()
    assert ev.detections == [] and ev._seen == set()

    def det(img, score):
        return {"boxes": [[1.0, 2.0, 5.0, 9.0]], "scores": [score],
                "labels": [1]}
    ranks = [coco_eval.COCOEvaluator(coco.COCO(VAL_JSON)) for _ in "ab"]
    ranks[0].update({241: det(241, 0.9), 242: det(242, 0.8)})
    ranks[1].update({243: det(243, 0.7), 242: det(242, 0.6)})

    def all_gather_object(out, obj, group=None):
        out[:] = [{"dets": r.detections, "seen": sorted(r._seen)}
                  for r in ranks]
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "all_gather_object", all_gather_object)
    ev.synchronize_between_processes()
    assert ev._seen == {241, 242, 243}
    assert [(d["image_id"], d["score"]) for d in ev.detections] == [
        (241, 0.9), (242, 0.8), (243, 0.7)]
