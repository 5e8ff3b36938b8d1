"""Where the port's serving or training time goes on the card.

Serving (default): the full-width LateFusion bf16 serving request of
``chip_smoke.py`` (B=8 608x800 uint8 RGB-D, random weights from a seed)
through ``dfvod_tpu_torch.serve.Server``. ``--clips``: the full-width
TransVOD++ LateFusion request of its clip phase (2 clips x 5 frames at
608x800, bf16). ``--train``: the train step of its train phase (the
LateFusion_bf16.sh recipe, B=6 608x800, bf16 autocast). ``--train-clips``:
the TransVOD++ step of its train_clips phase (the TransVOD++_withdepth.sh
recipe, 1 clip x 5 frames at 608x800, f32). ``--fusion
Encoder_CrossFusion`` or ``--fusion Backbone_CrossFusion`` serves (or,
with ``--train``, trains in f32, as their recipes do) that mode's
full-width model in place of LateFusion.

Each mode prints the host ms of each call (a ``torch.cuda.synchronize``
after it), then runs ``--requests`` calls under ``torch.profiler`` and
reads the program's own spans there (``dfvod_tpu_torch/utils/trace.py``):

1. for each innermost span (``serve.normalize``, ``backbone``,
   ``depth_backbone``, ``trunk.encoder``, ``trunk.decoder``,
   ``temporal``, ``serve.postprocess``; in a step ``train.forward``'s
   layers, ``train.criterion``, ``matcher``, ``train.backward``,
   ``train.update``): the host's own ms there, the device ms of the
   kernels and copies launched from there (autograd's thread included),
   the card's idle ms while the host was there, and the device syncs the
   program counted there, each a call;
2. the device busy share, the copy kernels, the hand-written kernels'
   time, and the top ops, kernels and host ops a call.

    python3 scripts/profile_torch_serving.py [--requests 3]
    python3 scripts/profile_torch_serving.py --fusion Backbone_CrossFusion
    python3 scripts/profile_torch_serving.py --clips [--requests 3]
    python3 scripts/profile_torch_serving.py --train [--requests 3]
    python3 scripts/profile_torch_serving.py --train-clips [--requests 3]

Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PREFIX = "dfvod."


def device_time_us(evt, self_only):
    for attr in (("self_device_time_total", "self_cuda_time_total")
                 if self_only else ("device_time_total",
                                    "cuda_time_total")):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def innermost_segments(spans):
    """Disjoint (start, end, name) pieces of the host timeline, each
    labelled by the innermost span over it. spans: (name, start, end),
    nested as one thread opens them; time outside every span is left
    out."""
    segs, stack, t = [], [], None
    for name, a, b in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][1] <= a:
            n, e = stack.pop()
            segs.append((t, e, n))
            t = e
        if stack:
            segs.append((t, a, stack[-1][0]))
        stack.append((name, b))
        t = a
    while stack:
        n, e = stack.pop()
        segs.append((t, e, n))
        t = e
    return [s for s in segs if s[1] > s[0]]


class Timeline:
    """The innermost span at each host instant."""

    def __init__(self, spans):
        self.segs = innermost_segments(spans)
        self.starts = [s[0] for s in self.segs]

    def at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return "outside spans"

    def split(self, a, b):
        """{span: us of [a, b] under it}."""
        out = collections.Counter()
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        covered = 0.0
        while i < len(self.segs) and self.segs[i][0] < b:
            s0, s1, name = self.segs[i]
            d = min(b, s1) - max(a, s0)
            if d > 0:
                out[name] += d
                covered += d
            i += 1
        if b - a > covered:
            out["outside spans"] += b - a - covered
        return out


def span_report(prof, n, label, syncs):
    """Per innermost program span, a call's mean: host self ms, device ms
    of what was launched from there, the card's idle ms, syncs."""
    from perfbench.harness.trace import Profile
    events = prof.events()
    spans = [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end)
             for e in events if e.name.startswith(PREFIX)]
    if not spans:
        raise RuntimeError("the profiler window holds no program span")
    line = Timeline(spans)
    host, device, idle = (collections.Counter() for _ in range(3))
    for a, b, name in line.segs:
        host[name] += b - a
    for e in events:
        kernels = getattr(e, "kernels", None) or []
        if kernels:
            name = (e.name[len(PREFIX):] if e.name.startswith(PREFIX)
                    else line.at(e.time_range.start))
            device[name] += sum(k.duration for k in kernels)
    p = Profile(events, calls=n, wall_s=0.0)
    for a, b in p.gaps():
        idle.update(line.split(a, b))
    order = list(dict.fromkeys(seg[2] for seg in line.segs))
    order += [s for s in ("outside spans",) if idle[s] or device[s]]
    print(f"[span] {'innermost span':20s} {'host ms':>9s} {'device ms':>10s}"
          f" {'idle ms':>9s} {'syncs':>6s}  (a {label}'s mean)", flush=True)
    for name in order:
        print(f"[span] {name:20s} {host[name] / 1e3 / n:9.3f} "
              f"{device[name] / 1e3 / n:10.3f} {idle[name] / 1e3 / n:9.3f} "
              f"{syncs.get(name, 0) / n:6.2f}", flush=True)
    print(f"[span] device busy {p.busy_us / 1e3 / n:.3f} ms, idle "
          f"{sum(idle.values()) / 1e3 / n:.3f} ms a {label}; launched from "
          f"spans {sum(device.values()) / 1e3 / n:.3f} ms", flush=True)


def profiler_window(fn, n, label):
    """Run ``fn`` ``n`` times under ``torch.profiler``; print the spans'
    report, the device busy share, the hand-written kernels' time and the
    top kernels and ops a call."""
    from perfbench.harness.trace import is_device_activity
    from torch.profiler import ProfilerActivity, profile

    from dfvod_tpu_torch.utils import trace
    torch.cuda.synchronize()
    before = trace.counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            # marks the calls' window for ``Profile``
            with torch.profiler.record_function("bench.profile.call"):
                fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    syncs = {k[len("sync."):]: v - before.get(k, 0)
             for k, v in trace.counters().items() if k.startswith("sync.")}
    span_report(prof, n, label, syncs)
    avgs = prof.key_averages()
    kernels = [e for e in avgs if is_device_activity(e)]
    busy_ms = sum(device_time_us(e, True) for e in kernels) / 1e3
    if busy_ms == 0:
        raise RuntimeError("the profiler recorded no device activity")
    print(f"[prof] window {wall_ms:.3f} ms for {n} {label}s; kernel time "
          f"{busy_ms:.3f} ms; device busy {100 * busy_ms / wall_ms:.1f}%, "
          f"idle {100 - 100 * busy_ms / wall_ms:.1f}% (profiler on)",
          flush=True)
    copies = [e for e in kernels if "copy" in e.key.lower()]
    print(f"[prof] copy kernels "
          f"{sum(device_time_us(e, True) for e in copies) / 1e3 / n:.3f} ms"
          f" per {label} (x{sum(e.count for e in copies) // n})", flush=True)
    for name in ("msda_fwd", "msda_bwd", "hat_sample_fwd", "hat_sample_bwd",
                 "lapjv"):
        us = sum(device_time_us(e, True) for e in kernels if name in e.key)
        calls = sum(e.count for e in kernels if name in e.key)
        if calls:
            print(f"[prof] {name} kernels {us / 1e3 / n:.3f} ms per {label}"
                  f" (x{calls // n}; {100 * us / 1e3 / busy_ms:.1f}% of "
                  f"kernel time)", flush=True)
    ops = sorted((e for e in avgs if e.key.startswith("aten::")),
                 key=lambda e: -device_time_us(e, False))
    for e in ops[:12]:
        print(f"[prof] op {e.key:40s} "
              f"{device_time_us(e, False) / 1e3 / n:8.3f} ms/{label} "
              f"(x{e.count // n})", flush=True)
    for e in sorted(kernels, key=lambda e: -device_time_us(e, True))[:15]:
        print(f"[prof] kernel {e.key[:70]:70s} "
              f"{device_time_us(e, True) / 1e3 / n:8.3f} ms/{label} "
              f"(x{e.count // n})", flush=True)
    host = sorted((e for e in avgs if not is_device_activity(e)),
                  key=lambda e: -e.self_cpu_time_total)
    for e in host[:10]:
        print(f"[prof] host op {e.key[:60]:60s} "
              f"{e.self_cpu_time_total / 1e3 / n:8.3f} ms/{label} self "
              f"(x{e.count // n})", flush=True)
    return avgs


def host_ms(fn, n):
    """Host ms of each of ``n`` calls, each ended by a synchronize."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def profile_train(cs, n, clips=False, fusion="LateFusion"):
    """The training breakdown (module docstring, ``--train`` and
    ``--train-clips``)."""
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.train import create_train_state, train_step
    from dfvod_tpu_torch.utils.config import Config

    if clips:
        cfg = cs.video_train_cfg()
        batch = cs.clip_train_batch(0)
    else:
        # LateFusion_bf16.sh; the other modes' recipes train in f32
        cfg = Config.from_flat(
            fusion_type=fusion, dropout=0.2, lr=1e-5,
            weight_decay=2e-5, clip_max_norm=0.1,
            train_dtype="bfloat16" if fusion == "LateFusion" else "float32")
        batch = cs.train_batch(0)
    model, criterion, _ = build_model(cfg, device="cpu", seed=0)
    model = cs.randomize(model, seed=1).to("cuda")
    state = create_train_state(model, cfg)
    batch = {k: v.to("cuda") for k, v in batch.items()}

    def step():
        train_step(state, criterion, batch)
    for _ in range(2):                      # warm-up
        step()
    torch.cuda.synchronize()
    print(f"[time] host ms per step: "
          f"{', '.join(f'{t:.3f}' for t in host_ms(step, n))}", flush=True)
    profiler_window(step, n, "step")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3,
                    help="requests (or train steps) per measurement")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="profile the train step instead of serving")
    mode.add_argument("--clips", action="store_true",
                      help="profile TransVOD++ clip serving (2 clips x 5 "
                           "frames) instead of single frames")
    mode.add_argument("--train-clips", action="store_true",
                      help="profile the TransVOD++ train step (1 clip x 5 "
                           "frames, f32)")
    ap.add_argument("--fusion", default="LateFusion",
                    choices=("LateFusion", "Encoder_CrossFusion",
                             "Backbone_CrossFusion"),
                    help="the single-frame model's fusion mode (serving "
                         "and --train)")
    args = ap.parse_args()
    if args.fusion != "LateFusion" and (args.clips or args.train_clips):
        ap.error("--fusion applies to single-frame serving and --train")
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    print(f"[card] {cs.card_line()}; torch {torch.__version__}", flush=True)
    if args.train or args.train_clips:
        return profile_train(cs, args.requests, clips=args.train_clips,
                             fusion=args.fusion)
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.serve import Server
    from dfvod_tpu_torch.utils.config import Config, ModelConfig

    if args.clips:
        cfg = Config(model=ModelConfig(fusion_type="LateFusion",
                                       temporal_mode="transvod_pp",
                                       num_ref_frames=cs.CLIP_FRAMES - 1))
        x, s = (t.to("cuda") for t in cs.clip_frames(0))
    else:
        cfg = Config(model=ModelConfig(fusion_type=args.fusion))
        x, s = (t.to("cuda") for t in cs.frames(0))
    ref_model, _, _ = build_model(cfg, device="cpu", seed=0)
    cs.randomize(ref_model, seed=1)
    server = Server(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    server.model.load_state_dict(ref_model.state_dict())

    def request():
        server(x, s)
    for _ in range(2):                      # warm-up
        request()
    torch.cuda.synchronize()
    print(f"[time] host ms per request: "
          f"{', '.join(f'{t:.3f}' for t in host_ms(request, args.requests))}",
          flush=True)
    profiler_window(request, args.requests, "request")
    return 0


if __name__ == "__main__":
    sys.exit(main())
