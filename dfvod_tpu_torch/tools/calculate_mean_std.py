"""Dataset mean/std calculator, counterpart of
``dfvod_tpu/tools/calculate_mean_std.py`` (the reference's
``depth_tools/calculate_mean_std.py``): streams an image tree and prints
per-channel mean/std in [0, 1], the numbers that feed
``DataConfig.rgb_mean`` / ``depth_mean``.

Each file is read as PIL's ``convert("RGB")`` (``image_io.read_rgb``) or,
with ``--grayscale``, ``convert("L")`` (``image_io.read_luma``).

    python -m dfvod_tpu_torch.tools.calculate_mean_std DIR [--grayscale]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dfvod_tpu_torch.data import image_io

EXTENSIONS = (".png", ".jpg", ".jpeg")


def compute_mean_std(input_dir: str, grayscale: bool = False):
    total = np.zeros(1 if grayscale else 3, np.float64)
    total_sq = np.zeros_like(total)
    count = 0
    read = image_io.read_luma if grayscale else image_io.read_rgb
    for f in sorted(Path(input_dir).rglob("*")):
        if f.suffix.lower() not in EXTENSIONS:
            continue
        a = read(f).astype(np.float64) / 255.0
        a = a.reshape(-1, 1 if grayscale else 3)
        total += a.sum(0)
        total_sq += (a ** 2).sum(0)
        count += a.shape[0]
    mean = total / max(count, 1)
    std = np.sqrt(np.maximum(total_sq / max(count, 1) - mean ** 2, 0))
    return mean, std


def main(argv=None):
    p = argparse.ArgumentParser("calculate_mean_std")
    p.add_argument("input_dir")
    p.add_argument("--grayscale", action="store_true",
                   help="single-channel (depth) statistics")
    a = p.parse_args(argv)
    mean, std = compute_mean_std(a.input_dir, a.grayscale)
    print(f"mean: {mean.tolist()}")
    print(f"std:  {std.tolist()}")


if __name__ == "__main__":
    main()
