"""Where the harness finds a cell's parts, by the names in BENCHMARK.json.

- a configuration: the ``file`` its entry in ``configs`` names
  (``perfbench/configs/<config>.json``);
- a configuration's plain reference: the module
  ``perfbench/reference/<reference>.py`` that its file's ``reference`` key
  names, ``latefusion`` (``model.py`` with ``train.py``) without the key;
- a traffic mix: ``perfbench/traffic/<traffic>.json``, whose ``loop``
  names the loop that drives it: ``perfbench/loops/<loop>.py``, which
  states its ``KIND`` (``serve`` or ``train``);
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
DEFAULT_REFERENCE = "latefusion"
KINDS = ("serve", "train")
_modules = {}


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
        self.reference = reference(self.config, root)
        self.loop = loop_module(self.traffic["loop"], root)
        self.kind = self.loop.KIND
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


def _load(kind, name, root):
    """The module ``perfbench/<kind>/<name>.py`` under ``root``, loaded once
    a process."""
    path = os.path.join(root, "perfbench", kind, name + ".py")
    if path not in _modules:
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def loop_module(name, root=ROOT):
    """The loop ``perfbench/loops/<name>.py``: a module with ``KIND`` (one
    of ``KINDS``: whether its mix carries targets and its count has a
    backward), ``CHIPS`` (the card counts it runs on), ``build``,
    ``warm_up``, ``trace_events``, ``window``, ``traced_call``,
    ``hand_over`` and ``check_numbers`` (see ``perfbench/loops/serve.py``)."""
    mod = _load("loops", name, root)
    if getattr(mod, "KIND", None) not in KINDS:
        raise ValueError(f"perfbench/loops/{name}.py states no KIND of "
                         f"{KINDS}")
    return mod


def reference(config, root=ROOT):
    """The plain reference of a configuration file's contents ``config``:
    the module ``perfbench/reference/<name>.py`` that its ``reference``
    key names, ``DEFAULT_REFERENCE`` without the key. What such a module
    gives is in ``perfbench/README.md``."""
    return _load("reference", config.get("reference", DEFAULT_REFERENCE),
                 root)
