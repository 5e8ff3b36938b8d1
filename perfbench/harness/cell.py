"""One run of one cell: set-up, the measured window, the traced stretch
(``trace``), the check against the plain reference, and the result.

Set-up builds the program and its inputs from the seed and warms up the
cell's one shape (serving: two requests; training: the first steps, which
the check then follows). ``setup_s`` runs from the process's start to
the end of set-up. With ``trace`` off the window gives the end-to-end
metrics; with it on the window runs with forward hooks and host spans and
is followed by a ``torch.profiler`` stretch, and the per-layer metrics'
readers take their numbers from those.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time
import types

import torch

from perfbench.harness import flops, inputs, spec
from perfbench.harness import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dfvod_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``dfvod_tpu_torch`` is not ``dfvod_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def limits_of(cell):
    return spec.load_json(os.path.join(cell.root, "perfbench", "limits",
                                       cell.name + ".json"))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def run(cell, seed, seconds, trace, device="cuda", t_start=None,
        faults=None):
    """The result dict of one run (its keys in the result line's order).
    ``faults``: a callable given the program once it is built, for the
    tests that break the timed path underneath."""
    t_start = time.perf_counter() if t_start is None else t_start
    traffic, config, loop = cell.traffic, cell.config, cell.loop
    limits = limits_of(cell)
    setup = {"import_s": time.perf_counter() - t_start}
    t = time.perf_counter()
    pool = inputs.pool(traffic, seed, device, kind=cell.kind)
    setup["inputs_s"] = time.perf_counter() - t
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    t = time.perf_counter()
    prog = loop.build(cell, seed, device)
    setup["build_s"] = time.perf_counter() - t
    if faults is not None:
        faults(prog)
    t = time.perf_counter()
    first = loop.warm_up(prog, pool, traffic, seed)
    sync()
    setup["warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in setup.items()))

    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans, pairs, handles = ({}, {}, []) if trace else (None, {}, [])
    if trace and cuda:
        pairs, handles = loop.trace_events(prog)
    w = loop.window(prog, pool, traffic, seconds, spans)
    sync()
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    for h in handles:
        h.remove()
    metrics, device_info, breakdown = {}, {}, None
    if not trace:
        log(f"[window] {w.summary}")
        metrics.update(w.metrics)
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        ctx = types.SimpleNamespace(
            loop=traffic["loop"], chips=cell.chips, calls=w.calls,
            window_s=w.seconds,
            frames_per_s=w.frames / w.seconds,
            key_frames_per_call=w.key_frames,
            frames_per_call=traffic["frames_per_request"],
            spans=spans, events=tr.pair_ms(pairs) if cuda else {},
            peak_window_bytes=peak_window, peaks=flops.PEAKS, profile=None,
            counts=None)
        if cuda:
            sent = iter(range(10 ** 9))

            def one():
                loop.traced_call(prog, pool[next(sent) % len(pool)])
            ctx.profile = tr.profile_calls(one, traffic["profile_calls"],
                                           traffic["profile_seconds"])
            device_info["busy_s"] = ctx.profile.busy_us * 1e-6
            device_info["window_s"] = ctx.profile.window_us * 1e-6
            breakdown = ctx.profile.breakdown()
        ctx.counts = flops.count(config["config"],
                                 traffic["frames_per_request"],
                                 traffic["height"], traffic["width"],
                                 train=cell.kind == "train",
                                 ref=cell.reference)
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}

    # the check, after the program's state is freed (a loop of ranks has
    # ended its other ranks, and hands their peak over)
    held = loop.hand_over(prog, first, w)
    peak_ranks = held.pop("memory_peak_bytes", 0) if isinstance(
        held, dict) else 0
    del prog, first
    free(cuda)
    numbers = loop.check_numbers(cell, seed, pool, held, device)
    checks, correct = judge(numbers, limits)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if cuda
                            else "cpu"),
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": int(max(peak_setup, peak_window,
                                                peak_ranks)),
                   **device_info}
    result = {"correct": correct, "attempted": w.calls, "failed": w.failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def free(cuda):
    """Collect what the program or a reference left and give the card's
    cached blocks back."""
    import gc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def judge(numbers, limits):
    """({name: {"value", "limit"}}, correct): every number with a limit
    must be at most its limit; a number whose limit is missing, or a
    limit whose number is missing, fails."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct &= ok
        checks[name] = {"value": value, "limit": limit}
    for name, value in numbers.items():
        if name.startswith("_"):
            log(f"[look] {name[1:]} {value}")
        elif name not in limits:
            checks[name] = {"value": value, "limit": None}
    return checks, bool(correct)


def report(result):
    """The checks on standard error, each beside its limit, then the
    result line on standard output."""
    for name, c in result["checks"].items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
