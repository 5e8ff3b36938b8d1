"""Monocular depth map generation, counterpart of
``dfvod_tpu/tools/rgb2d.py`` (the reference's ``depth_tools/rgb2d.py``).

Runs a HuggingFace depth-estimation pipeline (default
``LiheYoung/depth-anything-small-hf``, ``rgb2d.py:27``) over an image tree
and writes min-max-normalized uint8 grayscale PNGs mirroring the input
layout, each under its image's own file name: the ``depth_pred/``
convention the datasets expect (``torchvision_datasets/coco.py:84``). The
port's readers take a PNG under any name.

The pipeline is handed each file's path (a HuggingFace pipeline opens it
itself); ``transformers`` is imported only when no ``pipe`` is given, and
the pipeline then runs on the card unless ``--device cpu`` is given (it
raises where CUDA is absent). The model download needs network access:
without it, pass a local ``--model`` path or generate the depth maps
elsewhere.

    python -m dfvod_tpu_torch.tools.rgb2d DIR --output_dir DIR [--device cpu]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from dfvod_tpu_torch.data import image_io
from dfvod_tpu_torch.utils.device import resolve_device

EXTENSIONS = (".png", ".jpg", ".jpeg")


def normalize_depth_to_uint8(depth: np.ndarray) -> np.ndarray:
    d = depth.astype(np.float32)
    rng = d.max() - d.min()
    if rng > 0:
        d = (d - d.min()) / rng
    else:
        d = np.zeros_like(d)
    return (d * 255).astype(np.uint8)


def convert_images_to_depth(input_dir: str, output_dir: str,
                            num_images: int | None = None,
                            model: str = "LiheYoung/depth-anything-small-hf",
                            pipe=None, device=None) -> int:
    """Returns the number of images processed. ``pipe`` (called with a
    file's path, returning ``{"depth": array-like}``) may be injected, e.g.
    a stub in tests; otherwise ``model``'s pipeline is built on ``device``
    (``utils/device.py::resolve_device``: the card when none is given)."""
    if pipe is None:
        device = resolve_device(device)
        from transformers import pipeline
        pipe = pipeline(task="depth-estimation", model=model, device=device)

    inp, out = Path(input_dir), Path(output_dir)
    files = sorted(f for f in inp.rglob("*")
                   if f.suffix.lower() in EXTENSIONS)
    if num_images:
        files = files[:num_images]
    for path in files:
        depth = np.array(pipe(str(path))["depth"])
        dst = out / path.relative_to(inp)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(image_io.encode_png(normalize_depth_to_uint8(depth)))
    return len(files)


def main(argv=None):
    p = argparse.ArgumentParser("rgb2d")
    p.add_argument("input_dir")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--num_images", type=int, default=None)
    p.add_argument("--model", default="LiheYoung/depth-anything-small-hf")
    p.add_argument("--device", default=None,
                   help="torch device of the depth pipeline (default: the "
                        "card)")
    a = p.parse_args(argv)
    n = convert_images_to_depth(a.input_dir, a.output_dir, a.num_images,
                                a.model, device=a.device)
    print(f"Depth conversion completed: {n} images.")


if __name__ == "__main__":
    main()
