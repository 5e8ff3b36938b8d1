"""What a later change adds with files alone, in a temporary copy with no
existing file edited: a configuration that names its own reference
module, whose count, weights and check then come from that module, and a
train loop under another name, which gets targets and a forward and
backward count."""
import json
import os

import torch

from perfbench.harness import cell, flops, spec
from perfbench.tests import tiny

RECORDER = '''"""The default reference, recording what it is asked."""
import torch

from perfbench.reference import latefusion as _base
from perfbench.reference.latefusion import *  # noqa: F401,F403

CALLS = []


def build(cfg):
    CALLS.append(("build", torch.empty(0).device.type))
    return _base.build(cfg)


def normalize(images, sizes):
    CALLS.append(("normalize",))
    return _base.normalize(images, sizes)


def ring_bias(*a):
    CALLS.append(("ring_bias",))
    return _base.ring_bias(*a)


def group_label(name):
    CALLS.append(("group_label",))
    return _base.group_label(name)


class TrainStep(_base.TrainStep):
    def __init__(self, *a, **k):
        CALLS.append(("TrainStep",))
        super().__init__(*a, **k)
'''


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)


def _files(root):
    for d, _, fs in os.walk(root):
        if "__pycache__" not in d:
            for f in fs:
                yield os.path.join(d, f)


def _add_cell(root, name, config, mix, like):
    """A workload ``name`` of ``config`` under ``mix`` in the copy's
    BENCHMARK.json, with the limits and metric lists of the tiny cell
    ``like``."""
    pb = os.path.join(root, "perfbench")
    bench = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    if config not in [c["name"] for c in bench["configs"]]:
        bench["configs"].append({"name": config, "source": "tiny",
                                 "file": f"perfbench/configs/{config}.json",
                                 "reduced": [], "why": "tiny"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": mix, "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    _write(os.path.join(pb, "limits", name + ".json"),
           spec.load_json(os.path.join(pb, "limits", like + ".json")))


def test_a_configuration_names_its_reference(tmp_path):
    root = tiny.make_root(tmp_path)
    pb = os.path.join(root, "perfbench")
    before = {p: open(p, "rb").read() for p in _files(root)}
    with open(os.path.join(pb, "reference", "recorder.py"), "w") as f:
        f.write(RECORDER)
    cfg = spec.load_json(os.path.join(pb, "configs",
                                      "tiny_latefusion_r50_dformer.json"))
    cfg["name"] = "tiny_recorded"
    cfg["reference"] = "recorder"
    _write(os.path.join(pb, "configs", "tiny_recorded.json"), cfg)
    _add_cell(root, "rec.serve", "tiny_recorded", "tiny_serve.b32",
              "tiny.serve")
    _add_cell(root, "rec.train", "tiny_recorded", "tiny_train.b32",
              "tiny.train")
    calls = spec.reference(cfg, root).CALLS
    assert spec.reference({}, root) is not spec.reference(cfg, root)
    meta = {}
    for name, trace in (("rec.serve", False), ("rec.serve", True),
                        ("rec.train", False), ("rec.train", True)):
        calls.clear()
        torch.manual_seed(0)
        c = spec.Cell(name, root=root)
        assert c.reference.CALLS is calls
        r = cell.run(c, 11, 0.2, trace, device="cpu")
        assert r["correct"], r["checks"]
        seen = {k[0] for k in calls}
        # the program's weights and the check's from its rings; the check
        # builds the model on the CPU, and serving's normalizes the frames
        # (a train step, the module's own, normalizes inside)
        assert "ring_bias" in seen
        assert ("build", "cpu") in calls
        meta[name, trace] = calls.count(("build", "meta"))
        if name == "rec.serve":
            assert "normalize" in seen
        else:
            assert "TrainStep" in seen
            # the count's trainable parameters, in a traced run
            assert ("group_label" in seen) == trace
    # the weights' meta builds, and in a traced run the count's
    for name in ("rec.serve", "rec.train"):
        assert meta[name, True] == meta[name, False] + 1 >= 3
    for p, data in before.items():
        if os.path.basename(p) != "BENCHMARK.json":
            assert open(p, "rb").read() == data, p


def test_a_train_loop_under_another_name(tmp_path, monkeypatch):
    root = tiny.make_root(tmp_path)
    pb = os.path.join(root, "perfbench")
    with open(os.path.join(pb, "loops", "learn.py"), "w") as f:
        f.write("from perfbench.loops.train import *  # noqa: F401,F403\n"
                "KIND = 'train'\nCHIPS = (1,)\n")
    mix = spec.load_json(os.path.join(pb, "traffic", "tiny_train.b32.json"))
    mix["loop"] = "learn"
    _write(os.path.join(pb, "traffic", "learn.b2.json"), mix)
    _add_cell(root, "learn.b2", "tiny_latefusion_r50_dformer", "learn.b2",
              "tiny.train")
    counted = []
    count = flops.count

    def recording(*a, **k):
        counted.append(k["train"])
        return count(*a, **k)
    monkeypatch.setattr(flops, "count", recording)
    torch.manual_seed(0)
    c = spec.Cell("learn.b2", root=root)
    assert c.kind == "train"
    from perfbench.harness import inputs
    pool = inputs.pool(c.traffic, 5, "cpu", kind=c.kind)
    assert {"labels", "boxes", "valid"} <= set(pool[0])
    r = cell.run(c, 5, 0.2, True, device="cpu")
    # the train loop's check, held to the train cell's limits
    assert set(r["checks"]) >= set(cell.limits_of(c))
    assert counted == [True]
    assert r["metrics"]["mfu.train"]["value"] > 0
