"""Training CLI, single-frame models (counterpart of
``dfvod_tpu/cli/main.py``).

    python -m dfvod_tpu_torch.cli.main <a recipe's arguments>

Parity target: ``main.py:196-655`` of the reference, in the JAX package's
order: seed; model; datasets and loaders; train state; the resumes and
weight surgeries; evaluation only, or the epoch loop with a checkpoint
every epoch, the NaN exit, periodic evaluation keeping the best
checkpoint, and the final evaluation.

The run is on the card unless the caller passes ``device`` (``main(argv,
device="cpu")``, as the tests do); there is no flag for it, as the JAX CLI
has none. Frames go from the JPEG files through the port's loader as uint8
and are normalized on the device. Each epoch's line of ``log.txt`` also
holds ``timing``: the epoch's wall seconds and the loader's host seconds
(decode, transform, collate) and the seconds the loop waited for it.

Refused, naming the slice each waits for: ``--frozen_weights``
(segmentation), ``--num_devices`` > 1 and a multi-host environment
(``COORDINATOR_ADDRESS`` / ``DFVOD_MULTIHOST``: data parallelism, item 14).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

from dfvod_tpu_torch.cli.flags import config_from_args, get_args_parser
from dfvod_tpu_torch.data.dataset import build_dataset, make_transform
from dfvod_tpu_torch.data.loader import Loader, to_train_batch
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.train import create_train_state, train_step
from dfvod_tpu_torch.train.evaluate import eval_forward, evaluate
from dfvod_tpu_torch.utils import checkpoint as ckpt
from dfvod_tpu_torch.utils.convert_reference import (
    convert_reference_state_dict,
    load_torch_state_dict,
)
from dfvod_tpu_torch.utils.device import resolve_device
from dfvod_tpu_torch.utils.logging import (
    MetricLogger,
    WandbLogger,
    append_log,
    dump_args,
    setup_for_distributed,
)

# Deliberate NaN-divergence exit code, distinct from the rc=1 of any
# unhandled exception, so that a supervisor retries crashes and stops on
# divergence (the reference exits with 1, ``engine_single.py:56-59``).
NAN_EXIT_CODE = 42
HEARTBEAT_S = 120


def check_single_process(cfg):
    """Refuse what needs more than one process or device, or the
    segmentation head."""
    if cfg.model.frozen_weights:
        raise NotImplementedError(
            "--frozen_weights (segmentation-only training) waits for the "
            "segmentation slice")
    if cfg.train.num_devices > 1:
        raise NotImplementedError(
            f"--num_devices {cfg.train.num_devices}: training on more than "
            "one device waits for data parallelism (ROADMAP.md item 14)")
    for var in ("COORDINATOR_ADDRESS", "DFVOD_MULTIHOST"):
        if os.environ.get(var):
            raise NotImplementedError(
                f"{var} is set: multi-host training waits for data "
                "parallelism (ROADMAP.md item 14)")


def load_state(model, state: dict):
    """Overlay ``state`` on ``model``'s weights where names and shapes
    match (``load_state_dict(strict=False)`` semantics)."""
    merged, _ = ckpt.merge_matching(model.state_dict(), state)
    model.load_state_dict(merged)


def apply_weights(model, cfg, *, resume: str, del_class_weights: bool,
                  temporal_weights: str, spatial_weights: str):
    """The resumes and weight surgeries of ``main.py:468-540`` and
    ``main_multi.py:342-364``, in the JAX CLI's order: ``resume`` (a
    reference ``.pth``, converted, or a port checkpoint directory; the
    model's weights only, without ``class_embed`` under
    ``del_class_weights``), then the temporal / spatial checkpoints, then
    the DFormer pretrain into the depth stem."""
    video = cfg.model.temporal_mode != "none"
    if resume:
        if resume.endswith((".pth", ".pth.tar")):
            weights, _ = convert_reference_state_dict(
                load_torch_state_dict(resume), cfg.model.with_box_refine,
                video=video)
        else:
            weights = ckpt.load_checkpoint(resume)[0]["model"]
        if del_class_weights:
            weights = ckpt.drop_keys(weights, "class_embed")
        load_state(model, weights)
    if temporal_weights or spatial_weights:
        t = (ckpt.load_checkpoint(temporal_weights)[0]["model"]
             if temporal_weights else None)
        s = (ckpt.load_checkpoint(spatial_weights)[0]["model"]
             if spatial_weights else None)
        model.load_state_dict(ckpt.merge_temporal_weights(
            model.state_dict(), temporal_state=t, spatial_state=s))
    if cfg.model.dformer_weights:
        # the depth stem's convs and BNs from a DFormer pretrain
        # (``dformer_backbone.py:161-198``)
        stem = ckpt.convert_dformer_downsample_path(
            load_torch_state_dict(cfg.model.dformer_weights))
        prefix = ("backbone." if cfg.model.fusion_type ==
                  "Backbone_CrossFusion" else "depth_backbone.downsample_path.")
        if video:
            prefix = "detr." + prefix
        load_state(model, {prefix + k: v for k, v in stem.items()})


def eval_batches(loader):
    """``loader``'s batches as ``evaluate`` takes them."""
    return (to_train_batch(b) for b in loader)


class Heartbeat:
    """A daemon thread that prints a line every ``HEARTBEAT_S`` seconds
    while no step or evaluation has reported progress for 90 s, so that a
    supervisor's stall detector sees a long step or evaluation alive."""

    def __init__(self):
        self.t, self.msg = time.time(), "startup"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def mark(self, msg: str):
        self.t, self.msg = time.time(), msg

    def _run(self):
        while not self._stop.wait(HEARTBEAT_S):
            dt = time.time() - self.t
            if dt > 90:
                print(f"[heartbeat] alive: {self.msg} in flight {dt:.0f}s",
                      flush=True)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _stop_profile(prof, profile_dir):
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profile written to {path}")


def train_loop(cfg, *, video: bool = False, resume: str = "",
               start_epoch: int = 0, eval_only: bool = False,
               del_class_weights: bool = False,
               temporal_weights: str = "", spatial_weights: str = "",
               wandb_enabled: bool = False, auto_resume: bool = False,
               device=None):
    """Train (or, with ``eval_only``, evaluate) ``cfg`` on ``device`` (the
    card unless given). Returns the final evaluation's stats."""
    np.random.seed(cfg.train.seed)
    check_single_process(cfg)
    setup_for_distributed(True)
    device = resolve_device(device)
    frames = (1 + cfg.model.num_ref_frames) if video else 1
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name}), frames/clip: {frames}")

    model, criterion, _ = build_model(cfg, device, seed=cfg.train.seed)
    dump_args(cfg, cfg.output_dir)

    train_ds = build_dataset("train", cfg, temporal=video)
    val_ds = build_dataset("val", cfg, temporal=video)
    common = dict(max_boxes=cfg.data.max_boxes, use_depth=cfg.data.use_depth,
                  seed=cfg.train.seed, pack_s2d=cfg.data.pack_s2d,
                  num_workers=cfg.data.num_workers, device=device)
    train_loader = Loader(train_ds, make_transform(True, cfg),
                          batch_size=cfg.train.batch_size, shuffle=True,
                          drop_last=True, **common)
    val_loader = Loader(val_ds, make_transform(False, cfg),
                        batch_size=cfg.train.batch_size, shuffle=False,
                        **common)
    steps_per_epoch = max(len(train_loader), 1)
    state = create_train_state(model, cfg, steps_per_epoch)
    print(f"number of params: {sum(p.numel() for p in model.parameters())}")

    apply_weights(model, cfg, resume=resume,
                  del_class_weights=del_class_weights,
                  temporal_weights=temporal_weights,
                  spatial_weights=spatial_weights)

    # auto-resume: the full state (weights, optimizer, step, dropout
    # generator) of the newest checkpoint under output_dir, and the
    # best-mAP watermark, so that a worse evaluation after a restart
    # cannot overwrite best/
    best_meta_path = os.path.join(cfg.output_dir or ".", "best_meta.json")
    best_map50 = -1.0
    if auto_resume and cfg.output_dir:
        try:
            state, last_epoch = ckpt.load_checkpoint(
                cfg.output_dir, state, weights_only=False)
            start_epoch = max(start_epoch, last_epoch + 1)
            print(f"auto-resume: epoch {last_epoch} restored, "
                  f"continuing at {start_epoch}")
        except FileNotFoundError:
            print("auto-resume: no checkpoint yet, fresh start")
        if os.path.exists(best_meta_path):
            with open(best_meta_path) as f:
                best_map50 = json.load(f).get("best_map50", -1.0)
            print(f"auto-resume: best mAP_50 watermark {best_map50:.4f}")

    if eval_only:
        stats = evaluate(model, eval_batches(val_loader), val_ds.coco,
                         frames=frames)
        append_log(cfg.output_dir, {"eval": stats})
        return stats

    wandb = WandbLogger(wandb_enabled, config={"cfg": str(cfg)})
    hb = Heartbeat()
    try:
        # one eval forward before the loop (the JAX CLI compiles the eval
        # program here; the port meets its first eval shape)
        if cfg.train.eval_every and cfg.train.epochs - start_epoch > 1:
            wb = val_loader.first_batch()
            tw = time.time()
            hb.mark("eval-shape warm-up")
            eval_forward(model, wb["image"], wb["size"])
            print(f"eval-shape warm-up: {time.time() - tw:.1f}s")

        print("Start training")
        t0 = time.time()
        profile_dir = cfg.train.profile_dir
        prof = None
        step_idx = 0
        profile_start = 2 if steps_per_epoch > 2 else 0
        for epoch in range(start_epoch, cfg.train.epochs):
            train_loader.set_epoch(epoch)
            train_loader.reset_timings()
            t_epoch = time.time()
            logger = MetricLogger(print_freq=10)
            for sample in logger.log_every(train_loader,
                                           header=f"Epoch: [{epoch}]"):
                # a trace of 10 steps after the first two
                if profile_dir and step_idx == profile_start and \
                        prof is None:
                    prof = _profiler(device)
                    prof.start()
                if prof is not None and step_idx == profile_start + 10:
                    _stop_profile(prof, profile_dir)
                    prof, profile_dir = None, ""
                step_idx += 1
                hb.mark(f"train step {step_idx - 1} (epoch {epoch})")
                metrics = train_step(state, criterion, to_train_batch(sample))
                loss = float(metrics["loss"])
                hb.mark(f"after train step {step_idx - 1}")
                if not np.isfinite(loss):
                    print(f"Loss is {loss}, stopping training")
                    print({k: float(v) for k, v in metrics.items()})
                    sys.exit(NAN_EXIT_CODE)
                logger.update(loss=loss,
                              grad_norm=float(metrics["grad_norm"]),
                              loss_ce=float(metrics.get("loss_ce", 0.0)),
                              loss_bbox=float(metrics.get("loss_bbox", 0.0)),
                              loss_giou=float(metrics.get("loss_giou", 0.0)))
            epoch_s = time.time() - t_epoch

            if cfg.output_dir:
                ckpt.save_checkpoint(cfg.output_dir, state, epoch)
            stats = {"epoch": epoch,
                     **{f"train_{k}": m.global_avg
                        for k, m in logger.meters.items()},
                     "timing": {"epoch_s": epoch_s,
                                "loader_s": dict(train_loader.timings)}}
            ev = cfg.train.eval_every
            if ev and ((epoch + 1) % ev == 0
                       or epoch + 1 == cfg.train.epochs):
                hb.mark(f"eval after epoch {epoch}")
                val_stats = evaluate(model, eval_batches(val_loader),
                                     val_ds.coco, frames=frames)
                stats.update({f"test_{k}": v for k, v in val_stats.items()})
                if val_stats.get("mAP_50", 0.0) > best_map50:
                    best_map50 = val_stats["mAP_50"]
                    if cfg.output_dir:
                        ckpt.save_checkpoint(
                            os.path.join(cfg.output_dir, "best"), state,
                            epoch)
                        with open(best_meta_path, "w") as f:
                            json.dump({"best_map50": best_map50,
                                       "epoch": epoch}, f)
                    print(f"new best mAP_50={best_map50:.4f} @ epoch {epoch}")
            append_log(cfg.output_dir, stats)
            wandb.log(stats)

        if prof is not None:  # the run ended before step 12
            _stop_profile(prof, profile_dir)
        print(f"Training time {time.time() - t0:.0f}s")
        hb.mark("final evaluation")
        eval_stats = evaluate(model, eval_batches(val_loader), val_ds.coco,
                              frames=frames)
        append_log(cfg.output_dir, {"eval": eval_stats})
        wandb.finish()
        return eval_stats
    finally:
        hb.stop()


def main(argv=None, video: bool = False, device=None):
    parser = argparse.ArgumentParser(
        "dfvod_tpu_torch training", parents=[get_args_parser(video=video)])
    args = parser.parse_args(argv)
    cfg = config_from_args(args, video=video)
    return train_loop(
        cfg, video=video, resume=args.resume, start_epoch=args.start_epoch,
        eval_only=args.eval, del_class_weights=args.del_class_weights,
        temporal_weights=getattr(args, "transvod_temporal_weights", ""),
        spatial_weights=getattr(args, "spatial_weights", ""),
        wandb_enabled=not args.no_wandb, auto_resume=args.auto_resume,
        device=device)


if __name__ == "__main__":
    main()
