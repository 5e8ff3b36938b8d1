"""A configuration, a traffic mix (an open-loop one among them), a loop
and a per-layer metric added as new files (and entries in
BENCHMARK.json) are found and run by the harness with no existing file
edited."""
import json
import os

import torch

from perfbench.harness import cell, spec
from perfbench.tests import tiny


def test_new_files_are_found(tmp_path):
    root = tiny.make_root(tmp_path)
    pb = os.path.join(root, "perfbench")
    before = {p: open(p, "rb").read() for p in _files(root)}

    cfg = spec.load_json(os.path.join(pb, "configs",
                                      "tiny_latefusion_r50_dformer.json"))
    cfg["name"] = "tiny_late_q10"
    cfg["config"]["num_queries"] = 10
    _write(os.path.join(pb, "configs", "tiny_late_q10.json"), cfg)
    mix = spec.load_json(os.path.join(pb, "traffic", "tiny_serve.b32.json"))
    mix["frames_per_request"] = 3
    mix["arrival_rate_per_s"] = 20.0
    _write(os.path.join(pb, "traffic", "serve.b3.json"), mix)
    # a loop of its own, found by the name its mix gives
    with open(os.path.join(pb, "loops", "serve_again.py"), "w") as f:
        f.write("from perfbench.loops.serve import *  # noqa: F401,F403\n"
                "CHIPS = (1,)\n")
    mix["loop"] = "serve_again"
    _write(os.path.join(pb, "traffic", "serve_again.b3.json"), mix)
    _write(os.path.join(pb, "limits", "added.serve.b3.json"),
           spec.load_json(os.path.join(pb, "limits", "tiny.serve.json")))
    with open(os.path.join(pb, "metrics", "frames_per_call.serve.py"),
              "w") as f:
        f.write("def read(ctx):\n    return ctx.frames_per_call\n")
    bench = spec.load_json(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append({"name": "tiny_late_q10", "source": "tiny",
                             "file": "perfbench/configs/tiny_late_q10.json",
                             "reduced": ["num_queries"], "why": "tiny"})
    bench["workloads"].append({"name": "added.serve.b3",
                               "config": "tiny_late_q10",
                               "traffic": "serve.b3", "chips": 1,
                               "why": "tiny"})
    bench["workloads"].append({"name": "added.serve_again.b3",
                               "config": "tiny_late_q10",
                               "traffic": "serve_again.b3", "chips": 1,
                               "why": "tiny"})
    _write(os.path.join(pb, "limits", "added.serve_again.b3.json"),
           spec.load_json(os.path.join(pb, "limits", "tiny.serve.json")))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny.serve" in m.get("workloads", []):
            m["workloads"] += ["added.serve.b3", "added.serve_again.b3"]
    bench["per_layer"].append({"name": "frames_per_call.serve",
                               "unit": "frames", "better": "higher",
                               "source": "program_counter",
                               "layer": "serving entry",
                               "moves": "serve_frames_per_s",
                               "workloads": ["added.serve.b3"]})
    _write(os.path.join(root, "BENCHMARK.json"), bench)

    torch.manual_seed(0)
    c = spec.Cell("added.serve.b3", root=root)
    assert c.config["config"]["num_queries"] == 10
    r = cell.run(c, 3, 0.2, True, device="cpu")
    assert r["metrics"]["frames_per_call.serve"]["value"] == 3
    assert r["correct"]
    r = cell.run(spec.Cell("added.serve_again.b3", root=root), 4, 0.2,
                 False, device="cpu")
    assert r["correct"] and r["metrics"]["serve_p95_ms"]["value"] > 0
    for p, data in before.items():
        if os.path.basename(p) != "BENCHMARK.json":
            assert open(p, "rb").read() == data, p


def _files(root):
    for d, _, fs in os.walk(root):
        for f in fs:
            yield os.path.join(d, f)


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
