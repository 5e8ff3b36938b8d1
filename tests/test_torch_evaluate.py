"""The port's evaluation loop (``dfvod_tpu_torch/train/evaluate.py``)
against the JAX package's (``dfvod_tpu/train/evaluate.py`` with
``make_eval_step``): the same random weights (flax variables carried into
the port by ``load_jax_variables``) and the same seeded uint8 frames for
the 60 images of ``datasets/synth_rgbd/coco/annotations/val.json``, 8 per
batch, the last padded with repeated ids (``chip_smoke.eval_batches``, at
64x96 with 60x75 content; original size 256x320).

- Every batch's logits and boxes within atol 1e-4 / rtol 1e-3 (the JAX
  package's full-model parity tolerance).
- The detections each evaluator received agree, and the six stats are
  equal, over val.json's ground truth (at random weights every stat is 0)
  and, scored again, over a ground truth that the detections partly match
  (``matched_ground_truth``). A near-tie of two scores could reorder them
  and move a stat; none occurs at these weights, so equality is
  asserted.
- ``frames=3`` on a small TransVOD++ model: the key rows' ids and sizes
  are read, so it gives JAX's stats.
- ``chip_smoke.OracleDetector``, whose outputs encode the ground truth,
  scores mAP == mAP_50 == 1.0, single frames and clips; its frames read
  on the wrong rows, or its boxes scaled to the content size, it does
  not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dfvod_tpu.data.coco import COCO as JCOCO
from dfvod_tpu.data.coco import CocoVID as JCocoVID
from dfvod_tpu.data.coco_eval import COCOEvaluator as JCOCOEvaluator
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.train import evaluate as j_evaluate
from dfvod_tpu.train.engine import make_eval_step
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu_torch.data.coco import COCO, CocoVID
from dfvod_tpu_torch.data.coco_eval import COCOEvaluator
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models.postprocess import postprocess
from dfvod_tpu_torch.train.evaluate import eval_forward, evaluate
from dfvod_tpu_torch.utils.config import Config, ModelConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import assert_close, random_variables

VAL_JSON = chip_smoke.VAL_JSON
SIZE, CONTENT = (64, 96), (60, 75)
DIMS = dict(num_classes=3, num_queries=12, hidden_dim=64, nheads=4,
            enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0,
            num_feature_levels=1, fusion_type="LateFusion")
VIDEO = dict(DIMS, hidden_dim=32, enc_layers=1, dim_feedforward=64,
             temporal_mode="transvod_pp", num_ref_frames=2)


def batches(coco, frames=1, batch=8, img_ids=None):
    return list(chip_smoke.eval_batches(coco, img_ids, batch=batch,
                                        frames=frames, size=SIZE,
                                        content=CONTENT))


def jax_batch(b):
    """A port batch under the JAX loader's keys."""
    return {"image": b["images"].numpy(), "size": b["sizes"].numpy(),
            "orig_size": b["orig_size"].numpy(),
            "image_id": b["image_id"].numpy()}


def models(kw, seed=11):
    """(flax model, flax variables, the port model with those weights)."""
    jmodel = j_build_model(JConfig(model=JModelConfig(**kw)))[0]
    F = 1 + kw.get("num_ref_frames", 0) if "temporal_mode" in kw else 1
    x = jnp.zeros((F, *SIZE, 4), jnp.float32)
    mask = jnp.zeros((F, *SIZE), bool)
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), x, mask, train=False),
        seed=seed)
    model = build_model(Config(model=ModelConfig(**kw)), device="cpu")[0]
    return jmodel, variables, load_jax_variables(model, variables)


def matched_ground_truth(outputs, data, seed=0):
    """val.json's images with a ground truth that the detections of
    ``outputs`` (each batch's logits and boxes) partly match: each image's
    three best label-1 detections, jittered by up to 15% of their size
    (seeded), as category 1. At random weights the model's boxes miss
    val.json's own ground truth, so its stats are all 0; these are not."""
    rng = np.random.default_rng(seed)
    dataset = COCO(VAL_JSON).dataset
    anns = []
    for (logits, boxes), b in zip(outputs, data):
        res = postprocess(logits, boxes, b["orig_size"].float())
        for i, img_id in enumerate(b["image_id"].tolist()):
            if any(a["image_id"] == img_id for a in anns):
                continue
            xyxy = res["boxes"][i][res["labels"][i] == 1][:3].numpy()
            for x0, y0, x1, y1 in xyxy.astype(np.float64):
                w, h = x1 - x0, y1 - y0
                j = rng.uniform(-0.15, 0.15, 4) * [w, h, w, h]
                anns.append({"id": len(anns) + 1, "image_id": img_id,
                             "category_id": 1, "iscrowd": 0,
                             "bbox": [x0 + j[0], y0 + j[1], w + j[2],
                                      h + j[3]],
                             "area": (w + j[2]) * (h + j[3])})
    return dict(dataset, annotations=anns)


class Recorded:
    """Patches a module's ``COCOEvaluator`` so that the evaluators
    ``evaluate`` makes are kept."""

    def __init__(self, monkeypatch, module):
        self.made = []
        base = module.COCOEvaluator
        made = self.made

        class Keep(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.append(self)
        monkeypatch.setattr(module, "COCOEvaluator", Keep)


def recording(fn, outs):
    """``fn`` that appends each call's result to ``outs``."""
    def call(*a):
        outs.append(fn(*a))
        return outs[-1]
    return call


@pytest.fixture(scope="module")
def single_frame():
    """Each package's ``evaluate`` over val.json: every batch's logits and
    boxes (the forwards ``evaluate`` ran, recorded) and the evaluator it
    made; and the detections each evaluator received, scored again by a
    fresh evaluator of its package against ``matched_ground_truth``."""
    from dfvod_tpu.train import engine as j_engine
    from dfvod_tpu_torch.train import evaluate as p_evaluate
    jmodel, variables, model = models(DIMS)
    data = batches(COCO(VAL_JSON))
    port_outs, jax_outs = [], []
    with pytest.MonkeyPatch.context() as mp:
        port, ref = Recorded(mp, p_evaluate), Recorded(mp, j_evaluate)
        mp.setattr(p_evaluate, "eval_forward",
                   recording(eval_forward, port_outs))
        mp.setattr(j_engine, "make_eval_step",
                   lambda m: recording(make_eval_step(m), jax_outs))
        stats = evaluate(model, data, COCO(VAL_JSON), print_freq=0)
        jstats = j_evaluate.evaluate(jmodel, variables,
                                     [jax_batch(b) for b in data],
                                     JCOCO(VAL_JSON))
    outs = list(zip(port_outs, jax_outs))
    assert len(outs) == len(data)
    runs = {"val_json": (stats, jstats, port.made[0], ref.made[0])}
    matched = matched_ground_truth(port_outs, data)
    rescored = []
    for ev, again in ((port.made[0], COCOEvaluator(COCO(dataset=matched))),
                      (ref.made[0], JCOCOEvaluator(JCOCO(dataset=matched)))):
        again.detections = list(ev.detections)
        again.accumulate()
        rescored.append((again.summarize(verbose=False), again))
    runs["matched"] = (rescored[0][0], rescored[1][0], rescored[0][1],
                       rescored[1][1])
    return data, outs, runs


def test_batches_cover_val_json_and_pad_the_last(single_frame):
    data = single_frame[0]
    ids = [int(i) for b in data for i in b["image_id"]]
    coco = COCO(VAL_JSON)
    assert len(data) == 8 and len(ids) == 64
    assert ids[:60] == coco.getImgIds() and ids[60:] == ids[:4]
    assert all((b["orig_size"] == torch.tensor([256, 320])).all()
               for b in data)


@pytest.mark.parametrize("k", [0, 1], ids=["logits", "boxes"])
def test_eval_forward_matches_make_eval_step(single_frame, k):
    for i, (got, ref) in enumerate(single_frame[1]):
        assert_close(got[k], ref[k], 1e-4, 1e-3, err_msg=f"batch {i}")


def assert_same_detections(port, ref, n):
    assert len(port.detections) == len(ref.detections) == n
    for d, r in zip(port.detections, ref.detections):
        assert (d["image_id"], d["category_id"]) == (r["image_id"],
                                                     r["category_id"])
        np.testing.assert_allclose(d["bbox"], r["bbox"], atol=0.05,
                                   rtol=1e-3)
        np.testing.assert_allclose(d["score"], r["score"], atol=1e-4)


@pytest.mark.parametrize("gt", ["val_json", "matched"])
def test_evaluate_matches_jax(single_frame, gt):
    """The detections each package's evaluator received (ids, categories,
    boxes in original pixels within 0.05 px + rtol 1e-3, scores within
    1e-4) and the six stats, equal."""
    stats, jstats, port, ref = single_frame[2][gt]
    assert_same_detections(port, ref, 60 * 24)
    assert list(stats) == list(jstats)
    assert stats == jstats
    if gt == "matched":
        assert 0.1 < stats["mAP"] < stats["mAP_50"] < 1.0


@pytest.fixture(scope="module")
def video_models():
    return models(VIDEO, seed=12)


def test_clip_evaluate_reads_the_key_rows_as_jax(video_models,
                                                monkeypatch):
    """TransVOD++ over the first 2 videos' frames, 2 clips of 3 frames
    per batch: the key rows' ids and original sizes, as JAX reads them;
    the same detections and stats."""
    from dfvod_tpu_torch.train import evaluate as p_evaluate
    port, ref = (Recorded(monkeypatch, p_evaluate),
                 Recorded(monkeypatch, j_evaluate))
    jmodel, variables, model = video_models
    coco = CocoVID(VAL_JSON)
    ids = [i for v in coco.get_vid_ids()[:2]
           for i in coco.get_img_ids_from_vid(v)]
    data = batches(coco, frames=3, batch=2, img_ids=ids)
    assert data[0]["images"].shape[0] == 6
    # every row an image's, the key frames' ids the evaluated ones
    assert [int(i) for b in data for i in b["image_id"][::3]] == ids
    stats = evaluate(model, data, coco, frames=3, print_freq=0)
    jstats = j_evaluate.evaluate(jmodel, variables,
                                 [jax_batch(b) for b in data],
                                 JCocoVID(VAL_JSON), frames=3)
    assert_same_detections(port.made[-1], ref.made[-1], 8 * 24)
    assert {d["image_id"] for d in port.made[-1].detections} == set(ids)
    assert stats == jstats


@pytest.mark.parametrize("frames", [1, 5])
def test_oracle_scores_one(frames):
    coco = CocoVID(VAL_JSON)
    oracle = chip_smoke.OracleDetector(coco, frames)
    data = batches(coco, frames=frames, batch=8 if frames == 1 else 2)
    stats = evaluate(oracle, data, coco, frames=frames, print_freq=0)
    assert stats["mAP"] == stats["mAP_50"] == 1.0


def test_oracle_fails_on_wrong_rows_or_sizes():
    """The oracle's score pins the key rows and the original sizes: with
    a reference frame's id in the key row, or scaled to the content size,
    it falls below 1/2."""
    coco = CocoVID(VAL_JSON)
    data = batches(coco, frames=3, batch=2)
    # the ids of each clip's first reference frame in the key rows
    wrong_rows = [dict(b, image_id=b["image_id"].roll(-1, 0)) for b in data]
    oracle = chip_smoke.OracleDetector(coco, 3)
    assert evaluate(oracle, wrong_rows, coco, frames=3,
                    print_freq=0)["mAP"] < 0.5
    content = [dict(b, orig_size=b["sizes"]) for b in data]
    assert evaluate(oracle, content, coco, frames=3,
                    print_freq=0)["mAP"] < 0.5


def test_eval_forward_runs_the_model_in_its_dtype_in_eval_mode():
    """A bf16 model gets a bf16 image; the model is left in eval mode and
    no graph is kept."""
    model = build_model(Config(model=ModelConfig(**DIMS)), device="cpu")[0]
    model = model.to(torch.bfloat16).train()
    b = batches(COCO(VAL_JSON))[0]
    logits, boxes = eval_forward(model, b["images"][:2], b["sizes"][:2])
    assert logits.dtype == boxes.dtype == torch.bfloat16
    assert not model.training and not logits.requires_grad
    assert np.isfinite(logits.float().numpy()).all()
