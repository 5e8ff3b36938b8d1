"""Inference CLI / API (counterpart of ``dfvod_tpu/cli/inference.py``).

    python -m dfvod_tpu_torch.cli.inference --resume CKPT --img_folder DIR \
        [--depth_folder DIR] [--keep_prob 0.5] [model flags]

Builds the model, loads its weights (a port checkpoint directory, or a
reference ``.pth`` converted on the fly; then an optional
``--spatial_weights`` overlay), and runs it over a single image, a folder,
or a COCO json (with its image folder, an optional paired depth folder,
and video clips for a TransVOD / TransVOD++ model). Frames go through the
port's ``EvalTransform`` (short side 600, long side 1333), are padded
into a ``bucket_shape`` canvas as uint8 and normalized on the card
(``serve.Server.forward``). Detections are thresholded on the hand-class
probability on the host: softmax over the logits, class 1 above
``--keep_prob`` (``inference.py:918-922`` of the reference). Each frame
gives a YOLO-style txt file of ``Hand cx cy w h prob`` lines normalized to
the original size (``:948-956``), read by ``tools/yolo_eval.py``, and an
overlay PNG.

The card machine has neither PIL nor cv2: frames are read by
``data/image_io.py``, the overlay's rectangles are drawn in numpy with
PIL's ``ImageDraw.rectangle(width=3)`` pixels, its probability labels with
a bitmap font of this module's own (PIL's default font is not
reproduced), and the PNG is written by ``image_io.encode_png``. With
``compute_dtype=bfloat16`` every weight is cast to bf16, as the JAX CLI
casts its variables. The run is on the card unless the caller passes
``device``.

``--num_devices N`` > 1 serves clip-parallel over N processes, one per
card (the JAX CLI's ``('clip', 'data')`` mesh with the frames sharded over
both axes): each runs the trunk on its rows of a clip's frames
(``serve.Server(group=...)``), and rank 0 writes the files. A forward
whose frames do not divide over N raises the JAX sharding's divisibility
error, a single-frame model's one frame among them.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from dfvod_tpu_torch import parallel
from dfvod_tpu_torch.cli.flags import config_from_args, get_args_parser
from dfvod_tpu_torch.cli.main import load_state
from dfvod_tpu_torch.data.dataset import (
    CocoDetectionDataset,
    CocoVideoDataset,
    load_depth,
)
from dfvod_tpu_torch.data.image_io import encode_png, read_rgb
from dfvod_tpu_torch.data.transforms import (
    EvalTransform,
    Sample,
    bucket_shape,
    pad_u8,
)
from dfvod_tpu_torch.serve import Server
from dfvod_tpu_torch.utils import checkpoint as ckpt
from dfvod_tpu_torch.utils.config import Config
from dfvod_tpu_torch.utils.convert_reference import load_reference_checkpoint


class DeformableDETRInference:
    """``inference.py:355`` of the reference: the model on ``device`` (the
    card unless given) with the weights of ``resume`` and the
    ``spatial_weights`` overlay, in bf16 under ``compute_dtype=bfloat16``;
    ``infer_frames`` runs one clip (one frame for a single-frame model)."""

    def __init__(self, cfg: Config, resume: str = "",
                 spatial_weights: str = "", keep_prob: float = 0.5,
                 device=None, group=None):
        self.cfg = cfg
        self.keep_prob = keep_prob
        self.transform = EvalTransform(short_side=cfg.data.eval_short_side,
                                       max_size=cfg.data.max_size)
        dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
                 else torch.float32)
        self.server = Server(cfg, device=device, dtype=dtype,
                             seed=cfg.train.seed, group=group)
        self.frames = self.server.frames
        model = self.server.model
        if resume.endswith((".pth", ".pth.tar")):
            load_reference_checkpoint(resume, model)
        elif resume:
            load_state(model, ckpt.load_checkpoint(resume)[0]["model"])
        if spatial_weights:   # the overlay (``inference.py:812-815``)
            model.load_state_dict(ckpt.merge_temporal_weights(
                model.state_dict(), spatial_state=ckpt.load_checkpoint(
                    spatial_weights)[0]["model"]))

    def prep(self, frames: List[Sample]):
        """(uint8 (F, ph, pw, C) frames padded into their bucket, content
        sizes (F, 2)) after the eval transform."""
        frames = self.transform(frames)
        pad = bucket_shape(max(f.rgb.shape[0] for f in frames),
                           max(f.rgb.shape[1] for f in frames))
        C = 4 if self.cfg.data.use_depth else 3
        images = np.zeros((len(frames), *pad, C), np.uint8)
        sizes = np.stack([pad_u8(f, pad, self.cfg.data.use_depth, 1,
                                 out_img=images[i])["size"]
                          for i, f in enumerate(frames)])
        return images, sizes

    def infer_frames(self, frames: List[Sample]) -> Dict:
        """One clip (or single frame) -> the key frame's detections above
        ``keep_prob``: cxcywh boxes normalized to the frame, the hand-class
        probabilities, the original size and the image id."""
        out = self.server.forward(*self.prep(frames))
        logits = out["pred_logits"][0].float().cpu().numpy()
        boxes = out["pred_boxes"][0].float().cpu().numpy()
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        keep = probs[:, 1] > self.keep_prob
        return {"boxes_cxcywh": boxes[keep], "probs": probs[keep, 1],
                "orig_size": frames[0].orig_size,
                "image_id": frames[0].image_id}


def save_yolo_txt(dets: Dict, path: str, class_name: str = "Hand"):
    """YOLO-style output lines (``inference.py:948-956``)."""
    lines = [f"{class_name} {b[0]:.6f} {b[1]:.6f} {b[2]:.6f} {b[3]:.6f} "
             f"{p:.6f}" for b, p in zip(dets["boxes_cxcywh"], dets["probs"])]
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def draw_rectangle(img: np.ndarray, xyxy, color, width: int = 3):
    """The outline PIL's ``ImageDraw.rectangle(xyxy, outline=color,
    width=width)`` draws, in place on (H, W, C) ``img``: corners cut
    toward zero to integers, ``width`` rows at the top and bottom edges
    spanning x0..x1, and ``width`` columns at the sides from ``y0 + width``
    up to, not including, ``y1 - width + 1``, each clipped to the image."""
    H, W = img.shape[:2]
    x0, y0, x1, y1 = (int(v) for v in xyxy)
    if y0 > y1:
        y0, y1 = y1, y0

    def hline(y, a, b):
        a, b = max(min(a, b), 0), min(max(a, b), W - 1)
        if 0 <= y < H and a <= b:
            img[y, a:b + 1] = color

    def vline(x, start, stop):
        lo, hi = (start, stop - 1) if stop > start else (stop + 1, start)
        lo, hi = max(lo, 0), min(hi, H - 1)
        if 0 <= x < W and start != stop and lo <= hi:
            img[lo:hi + 1, x] = color

    for i in range(width):
        hline(y0 + i, x0, x1)
        hline(y1 - i, x0, x1)
        vline(x1 - i, y0 + width, y1 - width + 1)
        vline(x0 + i, y0 + width, y1 - width + 1)


# a 5x7 bitmap font for the probability labels ("0.87"): one string of
# five columns per row
GLYPHS = {
    "0": (".###.", "#...#", "#..##", "#.#.#", "##..#", "#...#", ".###."),
    "1": ("..#..", ".##..", "..#..", "..#..", "..#..", "..#..", ".###."),
    "2": (".###.", "#...#", "....#", "...#.", "..#..", ".#...", "#####"),
    "3": ("#####", "...#.", "..#..", "...#.", "....#", "#...#", ".###."),
    "4": ("...#.", "..##.", ".#.#.", "#..#.", "#####", "...#.", "...#."),
    "5": ("#####", "#....", "####.", "....#", "....#", "#...#", ".###."),
    "6": ("..##.", ".#...", "#....", "####.", "#...#", "#...#", ".###."),
    "7": ("#####", "....#", "...#.", "..#..", ".#...", ".#...", ".#..."),
    "8": (".###.", "#...#", "#...#", ".###.", "#...#", "#...#", ".###."),
    "9": (".###.", "#...#", "#...#", ".####", "....#", "...#.", ".##.."),
    ".": (".....", ".....", ".....", ".....", ".....", ".##..", ".##.."),
}
GLYPH_MASKS = {c: np.array([[p == "#" for p in row] for row in g])
               for c, g in GLYPHS.items()}


def draw_text(img: np.ndarray, xy, text: str, color):
    """``text`` (digits and '.') in the 5x7 font, its top-left corner at
    ``xy`` cut toward zero, one column between glyphs, clipped to the
    image."""
    H, W = img.shape[:2]
    x, y = int(xy[0]), int(xy[1])
    for c in text:
        m = GLYPH_MASKS[c]
        ys, xs = np.nonzero(m)
        ys, xs = ys + y, xs + x
        ok = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        img[ys[ok], xs[ok]] = color
        x += m.shape[1] + 1


def save_overlay(dets: Dict, rgb: np.ndarray, path: str):
    """The frame with each detection's box (red, 3 pixels wide) and its
    probability above it, as a PNG (``plot_results``, ``inference.py:491``
    of the reference; the JAX CLI draws with PIL)."""
    img = np.array(rgb[..., :3], np.uint8)
    h, w = dets["orig_size"]
    red = (255, 0, 0)
    for b, p in zip(dets["boxes_cxcywh"], dets["probs"]):
        cx, cy, bw, bh = (float(v) for v in b)
        xyxy = (np.array([cx - 0.5 * bw, cy - 0.5 * bh, cx + 0.5 * bw,
                          cy + 0.5 * bh], np.float32)
                * np.array([w, h, w, h], np.float32))
        draw_rectangle(img, xyxy.tolist(), red, width=3)
        draw_text(img, (float(xyxy[0]), max(float(xyxy[1]) - 12, 0)),
                  f"{p:.2f}", red)
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _frame_from_files(img_path: str, depth_path: Optional[str]) -> Sample:
    rgb = read_rgb(img_path)
    depth = load_depth(depth_path) if depth_path else None
    return Sample(rgb=rgb, depth=depth, boxes=np.zeros((0, 4), np.float32),
                  labels=np.zeros((0,), np.int64), orig_size=rgb.shape[:2])


def run_inference(*, resume: str = "", img_path: str = "",
                  img_folder: str = "", depth_folder: str = "",
                  inference_coco_path: str = "", coco_img_folder: str = "",
                  output_dir: str = "out", keep_prob: float = 0.5,
                  save_txt: bool = True, save_img: bool = True,
                  spatial_weights: str = "", cfg=None,
                  num_devices: int = 0, device=None, **cfg_kw) -> List:
    """Programmatic API (``inference.py:1169-1217``): the detections of
    each frame, in order, with their txt and PNG files written under
    ``output_dir`` (``img_<id>`` for a COCO json, the file's stem
    otherwise). ``num_devices`` > 1: clip-parallel over that many
    processes (see the module's docstring)."""
    cfg = cfg or Config.from_flat(**cfg_kw)
    kw = dict(resume=resume, img_path=img_path, img_folder=img_folder,
              depth_folder=depth_folder,
              inference_coco_path=inference_coco_path,
              coco_img_folder=coco_img_folder, output_dir=output_dir,
              keep_prob=keep_prob, save_txt=save_txt, save_img=save_img,
              spatial_weights=spatial_weights)
    if num_devices > 1:
        m = cfg.model
        parallel.check_divisible(
            1 if m.temporal_mode == "none" else 1 + m.num_ref_frames,
            num_devices)
        return parallel.spawn(_serve_rank, parallel.local_devices(
            num_devices, device), cfg, kw)
    return _serve(cfg, device=device, **kw)


def _serve_rank(device, cfg, kw):
    """One rank of clip-parallel serving, in the group ``parallel.spawn``
    formed."""
    return _serve(cfg, device=device, group=torch.distributed.group.WORLD,
                  **kw)


def _serve(cfg, *, resume, img_path, img_folder, depth_folder,
           inference_coco_path, coco_img_folder, output_dir, keep_prob,
           save_txt, save_img, spatial_weights, device, group=None):
    engine = DeformableDETRInference(cfg, resume=resume,
                                     spatial_weights=spatial_weights,
                                     keep_prob=keep_prob, device=device,
                                     group=group)
    writes = parallel.is_main_process()
    save_txt, save_img = save_txt and writes, save_img and writes
    if writes:
        os.makedirs(output_dir, exist_ok=True)

    jobs = []  # (name, clip)
    if inference_coco_path:
        kw = dict(use_depth=cfg.data.use_depth, train=False,
                  depth_folder=depth_folder or None)
        if engine.frames > 1:
            ds = CocoVideoDataset(coco_img_folder, inference_coco_path,
                                  num_ref_frames=cfg.model.num_ref_frames,
                                  **kw)
        else:
            ds = CocoDetectionDataset(coco_img_folder, inference_coco_path,
                                      **kw)
        for i in range(len(ds)):
            clip = ds[i]
            jobs.append((f"img_{clip[0].image_id}", clip))
    else:
        paths = ([img_path] if img_path else
                 sorted(os.path.join(img_folder, f)
                        for f in os.listdir(img_folder)
                        if f.lower().endswith((".jpg", ".png", ".jpeg"))))
        for p in paths:
            dp = (os.path.join(depth_folder, os.path.basename(p))
                  if depth_folder else None)
            jobs.append((os.path.splitext(os.path.basename(p))[0],
                         [_frame_from_files(p, dp)] * engine.frames))

    results = []
    for name, clip in jobs:
        dets = engine.infer_frames(clip)
        results.append(dets)
        if save_txt:
            save_yolo_txt(dets, os.path.join(output_dir, f"{name}.txt"))
        if save_img:
            save_overlay(dets, clip[0].rgb,
                         os.path.join(output_dir, f"{name}.png"))
    return results


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        "dfvod_tpu_torch inference", parents=[get_args_parser(video=True)])
    parser.add_argument("--img_path", default="", type=str)
    parser.add_argument("--img_folder", default="", type=str)
    parser.add_argument("--depth_folder", default="", type=str)
    parser.add_argument("--inference_coco_path", default="", type=str)
    parser.add_argument("--coco_img_folder", default="", type=str)
    parser.add_argument("--keep_prob", default=0.5, type=float)
    parser.add_argument("--save_txt", action="store_true", default=True)
    parser.add_argument("--no_save_img", dest="save_img",
                        action="store_false", default=True)
    return parser


def main(argv=None, device=None):
    args = get_parser().parse_args(argv)
    cfg = config_from_args(args, video=bool(args.num_ref_frames)
                           and "multi" in args.dataset_file)
    return run_inference(
        cfg=cfg, resume=args.resume, img_path=args.img_path,
        img_folder=args.img_folder, depth_folder=args.depth_folder,
        inference_coco_path=args.inference_coco_path,
        coco_img_folder=args.coco_img_folder,
        output_dir=args.output_dir or "out", keep_prob=args.keep_prob,
        save_txt=args.save_txt, save_img=args.save_img,
        spatial_weights=args.spatial_weights,
        num_devices=args.num_devices, device=device)


if __name__ == "__main__":
    main()
