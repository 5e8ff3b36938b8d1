"""Where the harness finds a cell's parts, by the names in BENCHMARK.json.

- a configuration: the ``file`` its entry in ``configs`` names
  (``perfbench/configs/<config>.json``);
- a traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``loop``
  names the loop that drives it: ``perfbench/loops/<loop>.py``;
- a per-layer metric: ``perfbench/metrics/<metric>.py``, a module with
  ``read(ctx)`` that returns the metric's value or None.

A later change adds a cell by adding files and entries; no file of the
harness names a cell, a configuration, a mix or a metric.
"""
from __future__ import annotations

import importlib.util
import json
import os

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic mix
    and metric lists."""

    def __init__(self, name, bench=None, root=ROOT):
        bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"({', '.join(sorted(by_name))})")
        self.root = root
        self.workload = by_name[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        cfg_entry = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = load_json(os.path.join(root, cfg_entry["file"]))
        self.traffic = load_json(os.path.join(
            root, "perfbench", "traffic", self.workload["traffic"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def metric_reader(name, root=ROOT):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loop_module(name, root=ROOT):
    """The loop ``perfbench/loops/<name>.py``: a module with ``CHIPS`` (the
    card counts it runs on), ``build``, ``warm_up``, ``trace_events``,
    ``window``, ``traced_call``, ``hand_over`` and ``check_numbers`` (see
    ``perfbench/loops/serve.py``)."""
    path = os.path.join(root, "perfbench", "loops", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_loop_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
