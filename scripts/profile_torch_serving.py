"""Where the port's serving time goes on the card.

Drives the same full-width LateFusion bf16 serving request as
``chip_smoke.py`` (B=8 608x800 uint8 RGB-D, random weights from a seed)
through ``dfvod_tpu_torch.serve.Server`` and prints:

1. host ms per request (``torch.cuda.synchronize`` around each);
2. per-layer device time from CUDA events recorded by forward hooks on the
   model's top modules (backbone, depth backbone, input projections, depth
   fusion layer, encoder, decoder), with the rest of the request as "other";
3. a ``torch.profiler`` window over a few requests: device time by op, the
   ``msda_fwd`` kernel's share, and the device busy share (kernel time over
   the window's wall time).

    python3 scripts/profile_torch_serving.py [--requests 3]

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


def device_time_us(evt, self_only):
    for attr in (("self_device_time_total", "self_cuda_time_total")
                 if self_only else ("device_time_total",
                                    "cuda_time_total")):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.serve import Server
    from dfvod_tpu_torch.utils.config import Config, ModelConfig

    print(f"[card] {cs.card_line()}; torch {torch.__version__}", flush=True)
    cfg = Config(model=ModelConfig(fusion_type="LateFusion"))
    ref_model, _ = build_model(cfg, device="cpu", seed=0)
    cs.randomize(ref_model, seed=1)
    server = Server(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    server.model.load_state_dict(ref_model.state_dict())
    x, s = (t.to("cuda") for t in cs.frames(0))
    for _ in range(2):                      # warm-up
        server(x, s)
    torch.cuda.synchronize()

    # 1 + 2: host ms per request and per-layer device time
    pairs, handles = hook_events(layer_groups(server.model))
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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            server(x, s)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    kernels = [e for e in avgs if device_time_us(e, True) > 0
               and not e.key.startswith("aten::")
               and not e.key.startswith("cuda")]
    busy_ms = sum(device_time_us(e, True) for e in kernels) / 1e3
    print(f"[prof] window {wall_ms:.3f} ms for {n} requests; kernel time "
          f"{busy_ms:.3f} ms; device busy {100 * busy_ms / wall_ms:.1f}%, "
          f"idle {100 - 100 * busy_ms / wall_ms:.1f}% (profiler on)",
          flush=True)
    msda_us = sum(device_time_us(e, True) for e in kernels
                  if "msda_fwd" in e.key)
    print(f"[prof] msda_fwd kernels {msda_us / 1e3 / n:.3f} ms per request "
          f"({100 * msda_us / 1e3 / busy_ms:.1f}% of kernel time)",
          flush=True)
    ops = sorted((e for e in avgs if e.key.startswith("aten::")),
                 key=lambda e: -device_time_us(e, False))
    for e in ops[:12]:
        print(f"[prof] op {e.key:40s} {device_time_us(e, False) / 1e3 / n:8.3f}"
              f" ms/request (x{e.count // n})", flush=True)
    for e in sorted(kernels, key=lambda e: -device_time_us(e, True))[:12]:
        print(f"[prof] kernel {e.key[:70]:70s} "
              f"{device_time_us(e, True) / 1e3 / n:8.3f} ms/request "
              f"(x{e.count // n})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
