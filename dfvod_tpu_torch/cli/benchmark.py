"""Benchmark CLI (counterpart of ``dfvod_tpu/cli/benchmark.py``): the
average forward latency of any model the flags describe over
``--num_iters`` iterations after ``--warm_iters`` warm-up ones, synchronized
with the card (``benchmark.py:31-66`` of the reference), printed with the
frames per second.

    python -m dfvod_tpu_torch.cli.benchmark --fusion_type LateFusion \
        [--height 608 --width 800 --num_iters 100] [model flags]

The input is a seeded standard-normal (F, H, W, C) image with no padding,
F the frames of a clip (``--dataset_file vid_multi*``) or 1, fed to the
model in its dtype (bf16 under ``compute_dtype=bfloat16``, with every
weight cast). ``--profile_dir`` writes a ``torch.profiler`` trace of the
timed loop to ``trace.json`` there. On the card unless the caller passes
``device``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from dfvod_tpu_torch.cli.flags import config_from_args, get_args_parser
from dfvod_tpu_torch.models import build_model


def measure_average_inference_time(fn, num_iters: int = 100,
                                   warm_iters: int = 5,
                                   device=torch.device("cpu")) -> float:
    """Mean seconds of ``fn()`` over ``num_iters`` calls after
    ``warm_iters`` warm-up ones, the clock read after
    ``torch.cuda.synchronize`` on a CUDA ``device``
    (``benchmark.py:31-43``)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    for _ in range(warm_iters):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(num_iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / num_iters


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "dfvod_tpu_torch benchmark", parents=[get_args_parser(video=True)])
    parser.add_argument("--num_iters", default=100, type=int)
    parser.add_argument("--warm_iters", default=5, type=int)
    parser.add_argument("--height", default=608, type=int)
    parser.add_argument("--width", default=800, type=int)
    # --profile_dir comes with the shared flags (the training CLI's)
    return parser


def main(argv=None, device=None) -> float:
    """Prints and returns the average seconds per forward."""
    args = get_parser().parse_args(argv)
    video = "multi" in args.dataset_file
    cfg = config_from_args(args, video=video)
    model = build_model(cfg, device, seed=0)[0]
    device = next(model.parameters()).device
    dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
             else torch.float32)
    model = model.to(dtype=dtype, memory_format=torch.channels_last)
    frames = (1 + cfg.model.num_ref_frames) if video else 1
    C = 4 if cfg.data.use_depth or cfg.model.use_depth else 3
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal(
        (frames, args.height, args.width, C)).astype(np.float32)).to(
        device, dtype)
    mask = torch.zeros((frames, args.height, args.width), dtype=torch.bool,
                       device=device)

    @torch.no_grad()
    def fn():
        return model(images, mask)["pred_logits"]

    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t = measure_average_inference_time(
                fn, args.num_iters, args.warm_iters, device)
        os.makedirs(args.profile_dir, exist_ok=True)
        path = os.path.join(args.profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"profile written to {path}")
    else:
        t = measure_average_inference_time(fn, args.num_iters,
                                           args.warm_iters, device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"Average inference time: {t * 1e3:.3f} ms "
          f"({frames / t:.1f} frames/s, device {device.type} {name})")
    return t


if __name__ == "__main__":
    main()
