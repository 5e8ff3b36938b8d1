"""Where the port's serving or training time goes on the card.

Serving (default): drives the same full-width LateFusion bf16 serving
request as ``chip_smoke.py`` (B=8 608x800 uint8 RGB-D, random weights from
a seed) through ``dfvod_tpu_torch.serve.Server`` and prints:

1. host ms per request (``torch.cuda.synchronize`` around each);
2. per-layer device time from CUDA events recorded by forward hooks on the
   model's top modules (backbone, depth backbone, input projections, depth
   fusion layer, encoder, decoder), with the rest of the request as "other";
3. a ``torch.profiler`` window over a few requests: device time by op, the
   ``msda_fwd`` kernel's share, and the device busy share (kernel time over
   the window's wall time).

Clip serving (``--clips``): the full-width TransVOD++ LateFusion request of
``chip_smoke.py``'s clip phase (2 clips x 5 frames at 608x800, bf16) and
the same three readings, with the layer groups of the trunk plus the
temporal head: the QRF's RoIAlign (K3), its RCNNHead, the temporal query
layers, the temporal decoders and the temporal heads.

Training (``--train``): the train step of ``chip_smoke.py``'s train phase
(the LateFusion_bf16.sh recipe, B=6 608x800, bf16 autocast) and prints:

1. host ms per step, and the step's phases by CUDA events: forward,
   criterion (with the matcher), backward, clip + optimizer;
2. the matcher's host time per step (its one device-to-host copy waits for
   the forward) and the scipy solves' share of it;
3. a ``torch.profiler`` window over a few steps: device busy share, the
   ``msda_fwd`` / ``msda_bwd`` kernels' time, the top kernels and ops.

    python3 scripts/profile_torch_serving.py [--requests 3]
    python3 scripts/profile_torch_serving.py --clips [--requests 3]
    python3 scripts/profile_torch_serving.py --train [--requests 3]

Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def layer_groups(model):
    if hasattr(model, "detr"):                  # TransVOD++
        groups = layer_groups(model.detr)
        groups.update({
            "QRF RCNNHead": [model.qrf_dynamic_layer1],
            "temporal query layers (3)": [
                getattr(model, f"temporal_query_layer{i}") for i in (1, 2, 3)],
            "temporal decoders (3)": [
                getattr(model, f"temporal_decoder{i}") for i in (1, 2, 3)],
            "temporal heads (3)": [getattr(model, f"temp_head_{i}")
                                   for i in (0, 1, 2)]})
        return groups
    t = model.transformer
    groups = {"backbone (ResNet-50 DC5)": [model.backbone],
              "depth backbone (DFormer)": [model.depth_backbone],
              "input projections": [model.input_proj_0,
                                    model.input_proj_depth_0],
              "LateFusion depth layer": [t.depth_encoder_layer],
              "encoder (6 layers)": [getattr(t, f"encoder_layers_{i}")
                                     for i in range(t.num_encoder_layers)],
              "decoder (6 layers)": [getattr(t, f"decoder_layers_{i}")
                                     for i in range(t.num_decoder_layers)]}
    return groups


def hook_events(groups):
    """Forward hooks recording a CUDA event pair per module call."""
    pairs = collections.defaultdict(list)
    handles = []
    for name, mods in groups.items():
        for m in mods:
            def pre(mod, args, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                pairs[name].append([ev, None])

            def post(mod, args, out, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                pairs[name][-1][1] = ev
            handles += [m.register_forward_pre_hook(pre),
                        m.register_forward_hook(post)]
    return pairs, handles


def is_device_activity(evt):
    """A kernel or copy on the card, not a CPU op and not a range
    (``record_function``, an autograd Function, ``Optimizer.step``) that
    the profiler mirrors onto the device timeline, which would count its
    kernels twice."""
    from torch.autograd import DeviceType
    return (getattr(evt, "device_type", None) == DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False)
            and device_time_us(evt, True) > 0)


def device_time_us(evt, self_only):
    for attr in (("self_device_time_total", "self_cuda_time_total")
                 if self_only else ("device_time_total",
                                    "cuda_time_total")):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def profiler_window(fn, n, label):
    """Run ``fn`` ``n`` times under ``torch.profiler``; print the device
    busy share, the MSDA kernels' time and the top kernels and ops per
    call. Returns the averages."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    kernels = [e for e in avgs if is_device_activity(e)]
    busy_ms = sum(device_time_us(e, True) for e in kernels) / 1e3
    if busy_ms == 0:
        raise RuntimeError("the profiler recorded no device activity")
    print(f"[prof] window {wall_ms:.3f} ms for {n} {label}s; kernel time "
          f"{busy_ms:.3f} ms; device busy {100 * busy_ms / wall_ms:.1f}%, "
          f"idle {100 - 100 * busy_ms / wall_ms:.1f}% (profiler on)",
          flush=True)
    for name in ("msda_fwd", "msda_bwd", "hat_sample_fwd"):
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
    return avgs


def profile_train(cs, n):
    """The training breakdown (module docstring, ``--train``)."""
    from dfvod_tpu_torch.models import build_model, criterion as crit_mod
    from dfvod_tpu_torch.models import matcher
    from dfvod_tpu_torch.train import create_train_state, train_step
    from dfvod_tpu_torch.train.engine import apply_gradients, forward
    from dfvod_tpu_torch.utils.config import Config

    cfg = Config.from_flat(
        fusion_type="LateFusion", dropout=0.2, lr=1e-5, weight_decay=2e-5,
        clip_max_norm=0.1, train_dtype="bfloat16")
    model, criterion, _ = build_model(cfg, device="cpu", seed=0)
    model = cs.randomize(model, seed=1).to("cuda")
    state = create_train_state(model, cfg)
    batch = {k: v.to("cuda") for k, v in cs.train_batch(0).items()}
    for _ in range(2):                      # warm-up
        train_step(state, criterion, batch)
    torch.cuda.synchronize()

    # host time of the matcher (its copy waits for the forward) and of the
    # scipy solves inside it
    host = collections.defaultdict(float)

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                host[key] += time.perf_counter() - t0
        return wrapper
    crit_mod.match_layers = timed(crit_mod.match_layers, "matcher")
    matcher.solve = timed(matcher.solve, "scipy")

    spans = collections.defaultdict(float)
    steps = []
    # the phases of ``train_step``, through the functions it composes
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        t0 = time.perf_counter()
        ev[0].record()
        state.optimizer.zero_grad(set_to_none=True)
        out, targets = forward(state, batch)
        ev[1].record()
        loss, _ = criterion(out, targets)
        ev[2].record()
        loss.backward()
        ev[3].record()
        apply_gradients(state)
        ev[4].record()
        torch.cuda.synchronize()
        steps.append(1e3 * (time.perf_counter() - t0))
        for name, a, b in (("forward", 0, 1), ("criterion + matcher", 1, 2),
                           ("backward", 2, 3), ("clip + AdamW", 3, 4)):
            spans[name] += ev[a].elapsed_time(ev[b])
    total = sum(spans.values()) / n
    print(f"[time] host ms per step: {', '.join(f'{t:.3f}' for t in steps)}"
          f"; device span {total:.3f} ms", flush=True)
    for name, ms in spans.items():
        print(f"[phase] {name:22s} {ms / n:8.3f} ms "
              f"{100 * ms / n / total:5.1f}%", flush=True)
    print(f"[matcher] host {1e3 * host['matcher'] / n:.3f} ms per step, of "
          f"which scipy solves {1e3 * host['scipy'] / n:.3f} ms (the rest "
          f"waits for the forward and copies the costs)", flush=True)
    profiler_window(lambda: train_step(state, criterion, batch), n, "step")
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    print(f"[card] {cs.card_line()}; torch {torch.__version__}", flush=True)
    if args.train:
        return profile_train(cs, args.requests)
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.models import temporal
    from dfvod_tpu_torch.serve import Server
    from dfvod_tpu_torch.utils.config import Config, ModelConfig

    if args.clips:
        cfg = Config(model=ModelConfig(fusion_type="LateFusion",
                                       temporal_mode="transvod_pp",
                                       num_ref_frames=cs.CLIP_FRAMES - 1))
        x, s = (t.to("cuda") for t in cs.clip_frames(0))
    else:
        cfg = Config(model=ModelConfig(fusion_type="LateFusion"))
        x, s = (t.to("cuda") for t in cs.frames(0))
    ref_model, _, _ = build_model(cfg, device="cpu", seed=0)
    cs.randomize(ref_model, seed=1)
    server = Server(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    server.model.load_state_dict(ref_model.state_dict())
    for _ in range(2):                      # warm-up
        server(x, s)
    torch.cuda.synchronize()

    # 1 + 2: host ms per request and per-layer device time; RoIAlign is a
    # function, timed by wrapping it
    pairs, handles = hook_events(layer_groups(server.model))
    roi_align = temporal.roi_align

    def timed_roi_align(*args, **kwargs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = roi_align(*args, **kwargs)
        ev[1].record()
        pairs["QRF RoIAlign (K3)"].append(ev)
        return out
    temporal.roi_align = timed_roi_align
    totals = []
    host = []
    for _ in range(args.requests):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        server(x, s)
        end.record()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        totals.append(start.elapsed_time(end))
    for h in handles:
        h.remove()
    temporal.roi_align = roi_align
    n = args.requests
    total = sum(totals) / n
    print(f"[time] host ms per request: "
          f"{', '.join(f'{t:.3f}' for t in host)}; device span "
          f"{total:.3f} ms", flush=True)
    accounted = 0.0
    for name, evs in pairs.items():
        ms = sum(a.elapsed_time(b) for a, b in evs) / n
        accounted += ms
        print(f"[layer] {name:28s} {ms:8.3f} ms {100 * ms / total:5.1f}%",
              flush=True)
    print(f"[layer] {'other (norm, sine, heads, post)':28s} "
          f"{total - accounted:8.3f} ms "
          f"{100 * (total - accounted) / total:5.1f}%", flush=True)

    # 3: profiler window
    profiler_window(lambda: server(x, s), n, "request")
    return 0

if __name__ == "__main__":
    sys.exit(main())
