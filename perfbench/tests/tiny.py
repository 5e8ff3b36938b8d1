"""A tiny copy of the benchmark's data for CPU tests: a temporary checkout
root holding a BENCHMARK.json with tiny cells, their configurations, mixes
and limits, and the real loops, references and metric readers. The
data-parallel cell runs two ranks on the CPU (gloo)."""
from __future__ import annotations

import copy
import json
import os
import shutil

from perfbench.harness import spec

TINY_MODEL = {"hidden_dim": 32, "nheads": 8, "enc_layers": 2,
              "dec_layers": 2, "dim_feedforward": 64, "num_queries": 20}
TINY_FRAME = {"height": 64, "width": 96,
              "content_sizes": [[64, 96], [48, 96], [64, 80]]}
# Limits for the tiny cells, set as the cells' own are (perfbench/control.py
# readings, here on the CPU over three seeds): serving, the program reads
# features (median) 1.8-3.2, memory 1.0-2.0, decoder boxes (stored) 1.7-2.0,
# decoder logits 1.3-2.1, temporal queries 1.5-1.7 and temporal logits
# (stored) 0.9-1.3; the fp8 reference 12.2-19.2, 6.8-13.2, 12.1-21.0,
# 8.2-15.5, 13.7-24.4 and 7.8-10.9 (the port's int8 path fails on the
# features and the memory). A decoder layer dropped reads 69-186 on the
# decoder logits, the temporal rounds skipped 120-259 on the temporal
# logits. Training: the program reads fwd memory 0.8-1.5, logits 1.6-1.9,
# boxes 2.1-3.2, gradients 1.5-5.4, changes 1.0-1.9; the fp8 reference
# 3.3-12.7 on the memory and 7.6-12.3 on the logits. The two-rank cell,
# over eight seeds: the program reads memory 0.97-1.82, logits 1.01-1.69,
# boxes 2.21-3.24, gradients 0.55-5.63, changes 0.77-2.79 and no state
# mismatch; the fp8 reference over four, 6.7-11.4, 7.7-11.2, 12.7-22.7,
# 1.7-15.3 and 1.8-6.9.
SERVE_LIMITS = {"features_median_ratio": 5.0, "memory_ratio": 3.5,
                "decoder_box_stored_ratio": 5.0,
                "decoder_logit_stored_ratio": 4.5, "post_mismatch": 0}
TINY_LIMITS = {
    "tiny.serve": SERVE_LIMITS,
    "tiny.clips": {**SERVE_LIMITS, "temporal_hs_ratio": 5.0,
                   "temporal_logit_stored_ratio": 3.2},
    "tiny.train": {"fwd_memory_ratio": 2.5, "fwd_logit_ratio": 4.0,
                   "fwd_box_ratio": 6.0, "grad_median_gap_ratio": 8.0,
                   "change_median_gap_ratio": 4.0},
    "tiny.train_ddp": {"fwd_memory_ratio": 2.5, "fwd_logit_ratio": 4.0,
                       "fwd_box_ratio": 6.0, "grad_median_gap_ratio": 8.0,
                       "change_median_gap_ratio": 4.0,
                       "ranks_state_mismatch": 0}}


TINY_CHIPS = {"tiny.train_ddp": 2}


def make_root(tmp, limits=None):
    """A checkout root under ``tmp`` with the cells ``tiny.serve``,
    ``tiny.clips``, ``tiny.train`` and ``tiny.train_ddp`` and their limits
    (``limits``, by default ``TINY_LIMITS``)."""
    root = os.path.join(str(tmp), "checkout")
    pb = os.path.join(root, "perfbench")
    os.makedirs(pb)
    for d in ("metrics", "loops", "reference"):
        shutil.copytree(os.path.join(spec.PERFBENCH, d), os.path.join(pb, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(pb, d))
    bench = spec.load_json(os.path.join(spec.ROOT, "BENCHMARK.json"))
    # name: (configuration, the mix it shrinks, its file here, the cell
    # whose metric lists it joins, what it changes in the mix); the
    # two-rank cell drives the one-card train mix through the ranks' loop
    cells = {"tiny.serve": ("latefusion_r50_dformer", "serve.b32",
                            "tiny_serve.b32", "latefusion.serve.b32",
                            {"frames_per_request": 2, "check_block": 1}),
             "tiny.clips": ("transvodpp_latefusion_r50_dformer", "serve.c8x5",
                            "tiny_serve.c8x5", "transvodpp.serve.c8x5",
                            {"frames_per_request": 10, "check_block": 5}),
             "tiny.train": ("latefusion_r50_dformer", "train.b32",
                            "tiny_train.b32", "latefusion.train.b32",
                            {"frames_per_request": 2, "max_boxes": 4,
                             "target_slots": 8}),
             "tiny.train_ddp": ("latefusion_r50_dformer", "train.b32",
                                "tiny_train_ddp.2x2", "latefusion.train.b32",
                                {"loop": "train_ddp", "frames_per_request": 4,
                                 "max_boxes": 4, "target_slots": 8})}
    configs, workloads = [], []
    for name, (cfg_name, mix, mix_file, _, over) in cells.items():
        cfg = spec.load_json(os.path.join(spec.PERFBENCH, "configs",
                                          cfg_name + ".json"))
        cfg["config"].update(TINY_MODEL)
        cfg["name"] = "tiny_" + cfg_name
        path = os.path.join(pb, "configs", cfg["name"] + ".json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        if cfg["name"] not in [c["name"] for c in configs]:
            configs.append({"name": cfg["name"], "source": cfg["source"],
                            "file": os.path.relpath(path, root),
                            "reduced": [], "why": "tiny"})
        tr = spec.load_json(os.path.join(spec.PERFBENCH, "traffic",
                                         mix + ".json"))
        tr.update(TINY_FRAME, pool=2, warmup=1, check_requests=2, **over)
        with open(os.path.join(pb, "traffic", mix_file + ".json"), "w") as f:
            json.dump(tr, f)
        lim = (limits or TINY_LIMITS)[name]
        with open(os.path.join(pb, "limits", name + ".json"), "w") as f:
            json.dump(lim, f)
        workloads.append({"name": name, "config": cfg["name"],
                          "traffic": mix_file,
                          "chips": TINY_CHIPS.get(name, 1), "why": "tiny"})
    tiny = copy.deepcopy(bench)
    tiny["configs"], tiny["workloads"] = configs, workloads
    for m in tiny["end_to_end"] + tiny["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [name for w in m["workloads"]
                              for name, c in cells.items() if c[3] == w]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(tiny, f)
    return root
