"""Chip smoke test of the PyTorch/CUDA port (``dfvod_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, serves and trains on
the card.

    python3 chip_smoke.py

Phases, each on lines of its own:

1. the card: name and power limit (``nvidia-smi``), TF32 off for every
   comparison;
2. build every CUDA kernel of the serving and training paths from
   ``dfvod_tpu_torch/csrc``, one ``nvcc`` per source, all at once, with
   each kernel's registers and spills;
3. each kernel against its plain PyTorch version on the card, in f32 and
   the bf16 mixes the paths feed, at their shapes and edge cases, with
   times: kernel, plain version, a PyTorch yardstick, and the least time
   the card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s
   f32), each timing beside the card line. K1 (``msda_fwd``, timed at the
   encoder, decoder and 5-level TDAM shapes, with every point outside
   the map, and at ``cf_stage2``, Backbone_CrossFusion's stage-2 fusion
   site: 76x100 queries onto a 152x200 map), then K2 (``msda_bwd``, timed
   at the encoder, decoder and TDAM shapes, in f32 at the video-training
   shape and at ``cf_stage2`` (B=6), and by the gradients asked for:
   grad_value alone, the point gradients alone, all), each K1 and K2 case
   with the kernel (vector or scalar) its C entry counted; then K3
   (``hat_sample_fwd``, the bilinear sampling under RoIAlign) at the QRF
   shape and edge cases, then K4 (``hat_sample_bwd``, its backward) at
   the QRF training shape with real and uniform points, in the bf16 mix
   and at the edge cases, with and without the point gradients; beside
   each K3/K4 timing the corners of its points and the distinct tokens
   per query and per tile of K4's merged path (counted with torch ops, off
   the main path), and the tiles that K4's C entry launched on that path
   in the checked call; then the opt-in forms: K5b/c
   (``corner_gather_fwd``, the folded-corner gather of MSDA's ``flat``,
   ``pallas`` and ``pallas_onehot`` forms) at the B=8 encoder shape and 4
   levels, with indices out of range, timed beside one
   ``F.embedding_bag``, with the path (vector or scalar kernel) its C
   entry counted; K5a (``hat_sample_sparse_fwd``, the level-stacked
   sampling of ``ms_deform_attn_hat(sparse=True)``) at the encoder shape
   and 4 levels with NaN queries, with the path its C entry counted, timed
   at the encoder shape beside ``F.grid_sample`` and at the 4 levels of a
   608x800 frame; K5d/e, the tiled and separable entries, launching K1;
   K6 (``fused_bottleneck``, ResNet-50's layer1 in bf16, a launch per
   block) on the serve model's real layer1 input and at borders, with the
   path (layer1 or generic kernel) its C entry counted and each path's
   shared memory, timed beside the unfused bf16 layer1;
4. the serving path at full width: LateFusion RGB-D DeformableDETR (ResNet-50
   DC5 + DFormer, hidden 256, 8 heads, 6+6 layers, 300 queries, box
   refinement) at B=8 608x800 from uint8 frames in bf16, random weights from
   a seed. The kernel launch counts are set to 0 just before and read just
   after; the detections must be finite and agree with the port's own f32
   forward; then the same served model with ``fused_stages`` on (K6, 3
   launches per request) under each ``DFVOD_MSDA_IMPL`` (13 K1 or 13 K5b/c
   launches per request), each within the same gate of the f32 forward;
   a small model on the card must agree with the same model on the CPU;
5. the clip serving path at full width: the TransVOD++ LateFusion model of
   ``configs/training/TransVOD++_withdepth.sh`` (the model above, 4
   reference frames, QRF + 3 temporal rounds) on 2 clips x 5 frames at
   608x800 in bf16: one warm-up and five timed requests with 16 K1 and 1
   K3 launches each (counts set to 0 just before, read just after), finite
   outputs, boxes in [0, 1], the key frames' single-frame outputs against
   the f32 forward; then small f32 TransVOD++ and TransVOD+TDAM (5
   reference frames) models on the card against the same on the CPU;
6. the training path at full width: the recipe of
   ``configs/training/LateFusion_bf16.sh`` at B=6 608x800, one warm-up and
   five timed ``train_step``s with 13 K1 and 13 K2 launches each (counts
   set to 0 just before, read just after), finite losses, the frozen
   ResNet-50 bitwise unchanged, every trainable group and the DFormer BN
   statistics moved; then a small f32 train step on the card against the
   same step on the CPU (loss, components and every gradient), and one of
   a 6+6-layer model under ``DFVOD_MSDA_IMPL=pallas_onehot`` (13 K5b/c and
   13 K2 launches);
7. the video training path at full width: the TransVOD++ recipe on 1 clip
   x 5 frames at 608x800 in f32, one warm-up and five timed ``train_step``s
   with 16 K1, 1 K3, 16 K2 and 1 K4 launches each (counts set to 0 just
   before each step, read just after), finite losses, every group moved,
   the ResNet-50 included, and the DFormer BN statistics; one step in the
   bf16 mix and one with ``fixed_pretrained_model`` (16 / 1 / 3 / 0
   launches, the trunk bitwise unchanged); then small f32 TransVOD++ and
   TransVOD+TDAM train steps on the card against the same on the CPU;
8. the paper's other two fusion modes, Encoder_CrossFusion (4 fusion
   layers in the encoder) and Backbone_CrossFusion (fusion at ResNet
   stages 2-4), each: the full-width B=8 608x800 bf16 serve (one warm-up,
   then timed requests with 16 or 15 K1 launches each, the boxes against
   the f32 forward under the serve gate), a small model's forward and
   train step on the card against the CPU, and the recipe's full-width
   B=6 f32 train step (one warm-up, then timed steps with 16/16 or 15/15
   K1/K2 launches each; Encoder_CrossFusion's ResNet-50 bitwise
   unchanged, Backbone_CrossFusion's trained, every group and the DFormer
   BN statistics moved); each full-width model freed before the next;
   then the bidirectional ``CrossFusionBackbone`` alone, card against CPU
   (6 K1 launches);
9. evaluation, checkpoints, reference weights and remat: an oracle
   detector whose outputs encode the ground truth of
   ``datasets/synth_rgbd/coco/annotations/val.json`` through ``evaluate``
   on the card (single frames and 5-frame clips, mAP 1.0); the serve
   configuration in f32 evaluated over val.json's 60 images at 608x800
   (13 K1 per batch of 8) and the TransVOD++ model over 2 clips x 5
   frames per batch (16 K1 + 1 K3 per batch), with ms per image and the
   evaluator's host ms; a small model's evaluation card vs CPU; the
   ``LateFusion_bf16.sh`` state at B=6 saved, restored into a state from
   another seed and stepped beside the unbroken one, then restored
   weights only, with the file's size and save and load ms; the
   reference's LateFusion model (``tests/torch_ref.py``) converted into
   the port, small against the replica within atol 1e-4 / rtol 1e-3 and
   at full width within the serve gate; a small remat step against the
   plain one, then the ``LateFusion_bf16.sh`` step with ``remat=True``
   (19 K1 + 13 K2 per step) and its peak memory below the plain step's;
10. the data path and the training CLI (``phase_data_cli``): the host
   libraries (JPEG decoder, resize) built with g++; the 600 JPEGs of
   ``datasets/synth_rgbd`` decoded, their SHA-256 against the constant
   that PIL and cv2 give on the CPU; the first batches of the
   ``Synth_LateFusion.sh`` loader against the CPU's digest, and copied to
   the card; then three recipes' argument lists through
   ``dfvod_tpu_torch.cli.main`` / ``main_multi`` in this process:
   ``LateFusion_bf16.sh`` for 1 epoch (40 steps of B=6 at short sides
   480-800, 13 K1 + 13 K2 per step, 13 K1 per eval batch), with ms per
   step, the loader's host ms per batch and the share of the epoch the
   loop waited for it; ``Synth_LateFusion.sh`` for 2 epochs, evaluated
   again by ``--eval --resume`` (the same stats) and continued by
   ``--auto_resume`` for exactly one epoch; and ``SynthHard_Temporal.sh``'s
   video stage (TransVOD++, 2 reference frames, B=4,
   ``--fixed_pretrained_model``: 16 K1 + 1 K3 + 3 K2 + 0 K4 per step),
   the frozen parameters bitwise the spatial checkpoint's;
11. the card line, JSON lines of the train, video-train, clip-serve,
   serve-variant, fusion-mode, evaluation/checkpoint and data/CLI phases,
   a JSON line of the kernels and the serving path, and the final line
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, exits non-zero and never prints the final line.
Without a CUDA device, or without the repo around it, the script fails.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, BATCH = 608, 800, 8
TRAIN_BATCH = 6                    # configs/training/LateFusion_bf16.sh
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
F32_OPS_PER_S = 67e12              # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor cores
# bf16 serve vs the port's own f32 forward, normalized cxcywh box
# coordinates (see PERF.md): bf16 keeps 8 bits of mantissa, so every
# Linear/conv output carries ~0.4% relative error through ResNet-50 and
# 12 transformer layers; the boxes pass six refinement steps.
BOX_MAX_TOL, BOX_MEAN_TOL = 5e-2, 5e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """(least ms, 'bytes' | 'operations') of work that moves ``nbytes``
    and does ``ops`` operations at ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ~25 ms of GPU clock cycles: long enough for the host to queue every timed
# launch before the card reaches the first one
QUEUE_CYCLES = 50_000_000


def cuda_ms(fn, iters, warmup=3):
    """Mean device ms of ``fn`` over ``iters`` launches, CUDA events, after
    ``warmup`` calls. The launches are queued behind a sleep kernel, so the
    card runs them back to back and the time excludes the host's launch
    overhead (which exceeds the kernel at small shapes)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def path_counts(module, fn):
    """(fn(), {path: launches}): the launches of each kernel path that the
    C entry behind ``module`` counted during ``fn``, or None where the
    package under test has no such count (a tree older than the counts)."""
    read = getattr(module, "kernel_paths", None)
    before = read() if read else None
    out = fn()
    torch.cuda.synchronize()
    if read is None:
        return out, None
    after = read()
    return out, {k: after[k] - before[k] for k in after}


# ------------------------------------------------------------------ MSDA
def grid_sample_msda(value, shapes, loc, attw):
    """Yardstick only, never called by the port: the reference's
    ``ms_deform_attn_core_pytorch`` (``F.grid_sample`` per level)."""
    import torch.nn.functional as F
    N, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    value_list = value.split([h * w for h, w in shapes], dim=1)
    grids = (2 * loc - 1).to(value.dtype)
    samples = []
    for lid, (h, w) in enumerate(shapes):
        v = value_list[lid].flatten(2).transpose(1, 2).reshape(
            N * M, D, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        samples.append(F.grid_sample(v, g, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))
    attw = attw.to(value.dtype).transpose(1, 2).reshape(N * M, 1, Lq, L * P)
    out = (torch.stack(samples, dim=-2).flatten(-2) * attw).sum(-1)
    return out.view(N, M * D, Lq).transpose(1, 2).contiguous()


def msda_inputs(gen, shapes, B, Lq, M, D, P, dtypes, oob=False):
    """value, loc, attw on the card: value N(0, 1), loc U(-0.1, 1.1)
    (or every sample outside each level), attw softmaxed."""
    value_dt, loc_dt, attw_dt = dtypes
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    dev = torch.device("cuda")
    value = torch.randn((B, S, M, D), generator=gen, device=dev)
    loc = torch.rand((B, Lq, M, L, P, 2), generator=gen, device=dev)
    loc = loc * 1.2 - 0.1
    if oob:
        loc = torch.where(loc < 0.5, -0.6, 1.6)
    logits = torch.randn((B, Lq, M, L * P), generator=gen, device=dev)
    attw = logits.softmax(-1).reshape(B, Lq, M, L, P)
    return value.to(value_dt), loc.to(loc_dt), attw.to(attw_dt)


def msda_bound(value, loc, attw, out, outside=False):
    """(least ms, 'bytes' | 'operations'): each input read once, the output
    written once; per sample point ~20 coordinate ops and 10 per channel
    (4 corner multiply-adds + the attention weight). With every point
    ``outside`` the map, the value is not read and no channel is summed."""
    B, Lq, M, L, P = attw.shape
    if outside:
        return bound(nbytes(loc, attw, out), B * Lq * M * L * P * 20)
    return bound(nbytes(value, loc, attw, out),
                 B * Lq * M * L * P * (10 * value.shape[-1] + 20))


# K1's timed shapes in the serving mix; cf_stage2 is Backbone_CrossFusion's
# stage-2 fusion site at 608x800: 76x100 RGB queries onto the 152x200 depth
# stem, 4x the queries and 16x the value tokens of the encoder's shape
TIMED_FWD = ("enc", "dec", "tdam_l5", "enc_oob", "cf_stage2")


def cf_stage2(B):
    """(spatial_shapes, B, Lq, M, D, P) of the stage-2 fusion site."""
    return (((H // 4, W // 4),), B, (H // 8) * (W // 8), 8, 32, 4)


def msda_paths(name):
    """``path_counts``' view of the path counts of ``csrc/<name>.cu``
    (``msda_fwd`` or ``msda_bwd``), or None for a package without them (a
    tree older than the counts, under ``scripts/time_msda_kernels.py``)."""
    from types import SimpleNamespace

    from dfvod_tpu_torch.ops import msda
    if not hasattr(msda, "kernel_paths"):
        return None
    return SimpleNamespace(kernel_paths=lambda: msda.kernel_paths(name))


def kernel_path(paths):
    """'vector' or 'scalar': the one kernel a single call launched, by the
    counts of its C entry ('not counted' without counts)."""
    if paths is None:
        return "not counted"
    check(sorted(paths.values()) == [0, 1],
          f"expected one launch of one kernel, got {paths}")
    return max(paths, key=paths.get)


def phase_msda_kernel():
    from dfvod_tpu_torch.ops import msda
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = (torch.float32,) * 3
    serve = (torch.bfloat16, torch.float32, torch.bfloat16)  # serving mix
    enc = (((38, 50),), BATCH, 1900, 8, 32, 4)
    dec = (((38, 50),), BATCH, 300, 8, 32, 4)
    multi = (((19, 25), (10, 13)), 2, 301, 8, 24, 4)
    # TDAM with 5 reference frames: the key frame's tokens into 5 levels
    tdam = (((38, 50),) * 5, 2, 1900, 8, 32, 4)
    cases = [("cf_stage2", cf_stage2(BATCH), serve, False),
             ("enc", enc, f32, False), ("enc", enc, serve, False),
             ("dec", dec, f32, False), ("dec", dec, serve, False),
             ("tdam_l5", tdam, f32, False), ("tdam_l5", tdam, serve, False),
             ("multi_d24", multi, f32, False),
             ("multi_d24", multi, serve, False),
             ("multi_d24", multi, (torch.bfloat16,) * 3, False),
             ("multi_d24", multi,
              (torch.bfloat16, torch.bfloat16, torch.float32), False),
             ("oob", (((38, 50),), 2, 64, 8, 32, 4), f32, True),
             ("oob", (((38, 50),), 2, 64, 8, 32, 4), serve, True),
             # every point outside the map: the cost of the coordinates
             # and of the loc / attw traffic alone
             ("enc_oob", enc, serve, True)]
    results = {}
    for name, (shapes, *dims), dtypes, oob in cases:
        value, loc, attw = msda_inputs(gen, shapes, *dims, dtypes, oob)
        got, paths = path_counts(msda_paths("msda_fwd"),
                                 lambda: msda.ms_deform_attn(
                                     value, shapes, loc, attw))
        # the plain version in f32 on the same (bf16-rounded) inputs
        ref = msda.ms_deform_attn_plain(value.float(), shapes, loc.float(),
                                        attw.float())
        err = (got.float() - ref).abs()
        tag = "f32" if dtypes == f32 else "/".join(
            str(d).replace("torch.", "") for d in dtypes)
        if oob:
            ok = bool(torch.count_nonzero(got) == 0)
            tol = "exact zeros"
        elif value.dtype == torch.float32:
            ok = bool((err <= 1e-5 + 1e-5 * ref.abs()).all())
            tol = "atol 1e-5 rtol 1e-5"
        else:
            ok = bool((err <= 3e-2).all())
            tol = "atol 3e-2 (bf16 output rounding)"
        max_err = float(err.max())
        print(f"[msda] {name:9s} {tag:28s} shape={tuple(value.shape)} "
              f"Lq={loc.shape[1]} max_abs_err={max_err:.3e} ({tol}) "
              f"path {kernel_path(paths)} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"msda_fwd disagrees with its plain version: {name} "
                  f"{tag} max_abs_err {max_err}")
        if name in TIMED_FWD and dtypes == serve:
            r = results[name] = {
                "max_abs_err": max_err, "paths": paths,
                "ms": cuda_ms(lambda: msda.ms_deform_attn(
                    value, shapes, loc, attw), 50),
                "plain_ms": cuda_ms(lambda: msda.ms_deform_attn_plain(
                    value, shapes, loc, attw), 10),
                "shape": f"B={value.shape[0]} Lq={loc.shape[1]} "
                         f"S={value.shape[1]} L={len(shapes)}",
            }
            r["bound_ms"], r["bound_by"] = msda_bound(value, loc, attw, got,
                                                      outside=oob)
            yardstick = ""
            if name in ("enc", "dec", "cf_stage2"):
                r["yardstick_ms"] = cuda_ms(lambda: grid_sample_msda(
                    value, shapes, loc, attw), 20)
                yardstick = (f" grid_sample yardstick "
                             f"{r['yardstick_ms']:.4f} ms,")
            print(f"[msda] time {name} {r['shape']} bf16 value/f32 loc/bf16 "
                  f"attw: kernel {r['ms']:.4f} ms ({kernel_path(paths)} "
                  f"path), plain "
                  f"{r['plain_ms']:.4f} ms,{yardstick} bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}); card "
                  f"{card_line()}", flush=True)
    return results



BWD_OPS_PER_POINT, BWD_OPS_PER_CHANNEL = 30, 30


def msda_bwd_bound(tensors):
    """(least ms, 'bytes' | 'operations') of the MSDA backward: value, go,
    loc and attw read once, the three gradients written once; per sample
    point ~30 coordinate and reduction ops and ~30 per channel (the sample,
    both location derivatives, 4 weighted gradient adds)."""
    value, loc, attw = tensors[:3]
    B, Lq, M, L, P = attw.shape
    return bound(nbytes(*tensors, value, loc, attw),
                 B * Lq * M * L * P * (BWD_OPS_PER_CHANNEL * value.shape[-1]
                                       + BWD_OPS_PER_POINT))


def backward_ms(fwd, inputs, go, iters):
    """Mean ms of the backward alone of ``fwd(*inputs)`` through autograd
    (the graph is built once, the VJP run ``iters`` times)."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fwd(*leaves)
    return cuda_ms(lambda: torch.autograd.grad(out, leaves, go,
                                               retain_graph=True), iters)


def training_mix():
    """The dtypes (value, loc, attw) that MSDeformAttn feeds the kernels in
    a bf16 autocast forward, read from a small module on the card."""
    from dfvod_tpu_torch.models import layers
    seen = []
    kernel = layers.ms_deform_attn

    def spy(value, shapes, loc, attw, **kw):
        seen.append((value.dtype, loc.dtype, attw.dtype))
        return kernel(value, shapes, loc, attw, **kw)

    attn = layers.MSDeformAttn(64, 1, 4, 4).cuda()
    query = torch.randn(2, 30, 64, device="cuda")
    ref = torch.rand(2, 30, 1, 2, device="cuda")
    layers.ms_deform_attn = spy
    try:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            attn(query, ref, query, ((5, 6),))
    finally:
        layers.ms_deform_attn = kernel
    return seen[0]


# cf_stage2's f32 case: 1e-6 of each gradient's largest entry on top of
# atol 1e-4 / rtol 1e-4. Its 152x200 map makes grad_loc (W or H times the
# pixel gradient) reach 4.6e3 where the encoder's 38x50 map gives 1.3e3,
# and summation order alone moves a few of its 3.9M entries by up to 1e-3
# (2e-7 of the largest), beyond 1e-4 + 1e-4 |ref| where |ref| is small;
# the f32 plain version differs from a float64 one by more
# (scripts/msda_precision.py, PERF.md)
SCALE_RTOL = {"cf_stage2": 1e-6}


def grads_agree(got, ref, exact_zero, bf16, scale_rtol=0.0):
    """(ok, tolerance, max abs error) of the kernel's three gradients
    against the plain backward's; ``scale_rtol`` adds that share of each
    gradient's largest entry to the tolerance."""
    errs = [float((g.float() - r).abs().max()) for g, r in zip(got, ref)]
    if exact_zero:
        return (all(bool(torch.count_nonzero(g) == 0) for g in got),
                "exact zeros", max(errs))
    atol, rtol = (3e-2, 2e-2) if bf16 else (1e-4, 1e-4)
    ok = all(bool(((g.float() - r).abs() <= atol + rtol * r.abs()
                   + scale_rtol * float(r.abs().max())).all())
             for g, r in zip(got, ref))
    tol = f"atol {atol:g} rtol {rtol:g}"
    if scale_rtol:
        tol += f" + {scale_rtol:g} of max |ref|"
    return ok, tol, max(errs)


def integer_pixel_loc(gen, B, Lq, M, L, P, shapes):
    """Locations on exact integer pixels (px = loc * W - 0.5 an integer,
    exactly, for power-of-two W and H), where the derivative is
    one-sided."""
    loc = torch.empty((B, Lq, M, L, P, 2), device="cuda")
    for lvl, (h, w) in enumerate(shapes):
        for c, n in ((0, w), (1, h)):
            k = torch.randint(-1, n + 1, (B, Lq, M, P), generator=gen,
                              device="cuda")
            loc[:, :, :, lvl, :, c] = (k + 0.5) / n
    return loc


def phase_msda_bwd_kernel():
    """K2 (``csrc/msda_bwd.cu``) against the plain backward on the card;
    K1 in the training mix too."""
    from dfvod_tpu_torch.ops import msda
    gen = torch.Generator(device="cuda").manual_seed(1)
    f32 = (torch.float32,) * 3
    train = training_mix()
    serve = (torch.bfloat16, torch.float32, torch.bfloat16)
    print(f"[msda_bwd] training mix fed by bf16 autocast: "
          f"{'/'.join(str(d).replace('torch.', '') for d in train)} "
          f"(value/loc/attw)", flush=True)
    enc = (((38, 50),), TRAIN_BATCH, 1900, 8, 32, 4)
    dec = (((38, 50),), TRAIN_BATCH, 300, 8, 32, 4)
    multi = (((19, 25), (10, 13)), 2, 301, 8, 24, 4)
    oob = (((38, 50),), 2, 64, 8, 32, 4)
    integer = (((32, 64), (16, 8)), 2, 128, 8, 32, 4)
    tdam = (((38, 50),) * 5, 1, 1900, 8, 32, 4)
    # the TransVOD++ f32 training step: 1 clip x 5 frames
    video = (((38, 50),), CLIP_TRAIN_FRAMES, 1900, 8, 32, 4)
    # the recipes train Backbone_CrossFusion in f32 at B=6
    cases = [("cf_stage2", cf_stage2(TRAIN_BATCH), f32)] + [
        (name, dims, dt) for name, dims in
        (("enc", enc), ("dec", dec), ("multi_d24", multi), ("oob", oob),
         ("integer_px", integer), ("tdam_l5", tdam))
        for dt in (f32, train, serve)] + [("video_f32", video, f32)]
    timed = {("enc", train), ("dec", train), ("tdam_l5", train),
             ("video_f32", f32), ("cf_stage2", f32)}
    results = {}
    for name, (shapes, B, Lq, M, D, P), dtypes in cases:
        value, loc, attw = msda_inputs(gen, shapes, B, Lq, M, D, P, dtypes,
                                       oob=name == "oob")
        if name == "integer_px":
            loc = integer_pixel_loc(gen, B, Lq, M, len(shapes), P,
                                    shapes).to(dtypes[1])
        go = torch.randn((B, Lq, M * D), generator=gen, device="cuda"
                         ).to(value.dtype)
        got, paths = path_counts(msda_paths("msda_bwd"),
                                 lambda: msda.ms_deform_attn_bwd(
                                     value, shapes, loc, attw, go))
        ref = msda.ms_deform_attn_plain_bwd(
            value.float(), shapes, loc.float(), attw.float(), go.float())
        ok, tol, max_err = grads_agree(got, ref, name == "oob",
                                       value.dtype == torch.bfloat16,
                                       SCALE_RTOL.get(name, 0.0))
        tag = "/".join(str(d).replace("torch.", "") for d in dtypes)
        print(f"[msda_bwd] {name:10s} {tag:24s} shape={tuple(value.shape)} "
              f"Lq={Lq} max_abs_err={max_err:.3e} ({tol}) path "
              f"{kernel_path(paths)} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"msda_bwd disagrees with its plain version: {name} "
                  f"{tag} max_abs_err {max_err}")
        check(all(g.dtype == t.dtype for g, t in zip(got, (value, loc,
                                                           attw))),
              "msda_bwd gradients not in their inputs' dtypes")
        if name == "enc" and dtypes == train:
            out = msda.ms_deform_attn(value, shapes, loc, attw)
            torch.cuda.synchronize()
            fref = msda.ms_deform_attn_plain(value.float(), shapes,
                                             loc.float(), attw.float())
            ferr = float((out.float() - fref).abs().max())
            print(f"[msda] enc       {tag:28s} (training mix) "
                  f"max_abs_err={ferr:.3e} (atol 3e-2) "
                  f"{'ok' if ferr <= 3e-2 else 'FAIL'}", flush=True)
            check(ferr <= 3e-2, "msda_fwd disagrees in the training mix")
        if (name, dtypes) in timed:
            inputs = (value, loc, attw)
            r = results[name] = {
                "max_abs_err": max_err, "paths": paths,
                "ms": cuda_ms(lambda: msda.ms_deform_attn_bwd(
                    value, shapes, loc, attw, go), 50),
                "plain_ms": backward_ms(
                    lambda v, l, a: msda.ms_deform_attn_plain(
                        v, shapes, l, a), inputs, go, 10),
                "shape": f"B={B} Lq={Lq} S={value.shape[1]} "
                         f"L={len(shapes)} {tag}",
            }
            r["bound_ms"], r["bound_by"] = msda_bwd_bound(
                (value, loc, attw, go))
            yardstick = ""
            if name in ("enc", "dec", "cf_stage2"):
                r["yardstick_ms"] = backward_ms(
                    lambda v, l, a: grid_sample_msda(v, shapes, l, a),
                    inputs, go, 10)
                yardstick = (f" grid_sample backward yardstick "
                             f"{r['yardstick_ms']:.4f} ms,")
            print(f"[msda_bwd] time {name} {r['shape']}: kernel "
                  f"{r['ms']:.4f} ms ({kernel_path(paths)} path), plain "
                  f"backward {r['plain_ms']:.4f} ms,"
                  f"{yardstick} bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); card {card_line()}", flush=True)
        if (name, dtypes) == ("enc", train):
            results[name]["needs"] = needs_split(msda, shapes, value, loc,
                                                 attw, go, ref, tag)
    results["training_mix"] = "/".join(str(d).replace("torch.", "")
                                       for d in train)
    return results


# K2's gradients by ``needs`` (value, loc, attw): whether the atomics into
# grad_value or the corner gathers of the point gradients set its pace
NEEDS_SPLIT = {"value": (True, False, False), "points": (False, True, True),
               "all": (True, True, True)}


def needs_split(msda, shapes, value, loc, attw, go, ref, tag):
    """{needs: ms} of K2 asked for grad_value alone, the point gradients
    alone and all three, each checked against the plain backward ``ref``
    (bf16 atol 3e-2 / rtol 2e-2, f32 1e-4)."""
    times = {}
    for key, needs in NEEDS_SPLIT.items():
        got = msda.ms_deform_attn_bwd_cuda(value, shapes, loc, attw, go,
                                           needs)
        torch.cuda.synchronize()
        ok, tol, err = grads_agree([g for g in got if g is not None],
                                   [r for r, n in zip(ref, needs) if n],
                                   False, value.dtype == torch.bfloat16)
        check(ok and [g is not None for g in got] == list(needs),
              f"msda_bwd with needs {needs} disagrees: max_abs_err {err}")
        times[key] = cuda_ms(lambda: msda.ms_deform_attn_bwd_cuda(
            value, shapes, loc, attw, go, needs), 50)
        print(f"[msda_bwd] time enc {tag} needs {key:6s}: kernel "
              f"{times[key]:.4f} ms, max_abs_err={err:.3e} ({tol}); card "
              f"{card_line()}", flush=True)
    return times


# ------------------------------------------------- K3: RoIAlign's sampling
QRF_FRAMES, QRF_ROIS = 10, 300     # 2 clips x 5 frames, 300 queries each
HAT_OPS_PER_POINT, HAT_OPS_PER_CHANNEL = 25, 8


def grid_sample_hat(value, px, py, aw):
    """Yardstick only, never called by the port: ``F.grid_sample``
    (``align_corners=True`` maps pixel indices exactly, zeros outside) over
    the PL points, then the weighted sum. value (BM, H, W, D); the grid is
    in the value's dtype, as grid_sample requires."""
    import torch.nn.functional as F
    BM, H, W, D = value.shape
    grid = torch.stack([px / (W - 1) * 2 - 1, py / (H - 1) * 2 - 1], -1)
    s = F.grid_sample(value.permute(0, 3, 1, 2), grid.to(value.dtype),
                      mode="bilinear", padding_mode="zeros",
                      align_corners=True)                  # (BM, D, Lq, PL)
    return (s * aw[:, None].to(value.dtype)).sum(-1).transpose(1, 2)


def hat_bound(value, px, py, aw, out):
    """(least ms, 'bytes' | 'operations') of K3: each input read once, the
    output written once; per sample point ~25 coordinate and corner-weight
    ops and 8 per channel (4 corner multiply-adds)."""
    return bound(nbytes(value, px, py, aw, out),
                 px.numel() * (HAT_OPS_PER_CHANNEL * value.shape[-1]
                               + HAT_OPS_PER_POINT))


def qrf_points(gen, frames=QRF_FRAMES):
    """px, py, aw of the QRF RoIAlign at full width: 300 random boxes per
    frame on the 608x800 image, sampled on the 38x50 stride-16 memory with
    the model's spatial_scale 1/32, 7x7 bins, 2x2 points per bin."""
    from dfvod_tpu_torch.ops.roi_align import roi_sample_points
    from dfvod_tpu_torch.utils.box_ops import box_cxcywh_to_xyxy
    cxcy = torch.rand((frames, QRF_ROIS, 2), generator=gen,
                      device="cuda") * 0.9 + 0.05
    wh = torch.rand((frames, QRF_ROIS, 2), generator=gen,
                    device="cuda") * 0.6 + 0.02
    whwh = torch.tensor([W, H, W, H], dtype=torch.float32, device="cuda")
    boxes = box_cxcywh_to_xyxy(torch.cat([cxcy, wh], -1)) * whwh
    return roi_sample_points(boxes, H // 16, W // 16, output_size=7,
                             spatial_scale=1 / 32, sampling_ratio=2)


def edge_points(gen, BM, Lq, PL, h, w):
    """Points outside the grid, in (-1, 0) and (h-1, h), on integer
    coordinates, with aw = 0, the -1e6 padding, NaN and inf, at exactly -1
    and exactly w or h."""
    dev = "cuda"
    px = torch.rand((BM, Lq, PL), generator=gen, device=dev) * (w + 4) - 2.5
    py = torch.rand((BM, Lq, PL), generator=gen, device=dev) * (h + 4) - 2.5
    aw = torch.randn((BM, Lq, PL), generator=gen, device=dev)
    px[:, :10] = torch.floor(px[:, :10])
    py[:, 5:15] = torch.floor(py[:, 5:15])
    px[:, 15:20] = -0.5
    py[:, 20:25] = h - 0.5
    px[:, 25:30] = w - 0.25
    aw[:, 30:35] = 0.0
    px[:, 35:40] = -1e6
    py[:, 35:40] = -1e6
    px[:, 40:42, 0] = float("nan")
    py[:, 42:44, 1] = float("inf")
    px[:, 44:47] = -1.0                # exactly -1: value 0, derivative kept
    py[:, 47:50] = -1.0
    px[:, 50:52] = float(w)            # exactly W and H: outside
    py[:, 52:54] = float(h)
    return px, py, aw


def corner_stats(value, px, py, tile_rows=None):
    """What the merged paths of K3 and K4 find at these points, counted
    with torch ops off the main path: the valid corners (point inside
    [-1, W) x [-1, H), corner on the grid), the distinct tokens per query
    (the rows K3 gathers after its merge in registers) and, given K4's rows
    per tile, per tile of that many consecutive rows (bm, q) (the rows K4's
    merged path adds into gv) and the number of tiles."""
    BM, H, W, D = value.shape
    _, Lq, PL = px.shape
    inside = (px >= -1) & (px < W) & (py >= -1) & (py < H)
    x0 = torch.floor(torch.where(inside, px, 0.0)).long()
    y0 = torch.floor(torch.where(inside, py, 0.0)).long()
    frame = torch.arange(BM, device=px.device).view(BM, 1, 1) * (H * W)
    keys = []
    for dy in (0, 1):
        for dx in (0, 1):
            cx, cy = x0 + dx, y0 + dy
            ok = inside & (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
            keys.append(torch.where(ok, frame + cy * W + cx, -1))
    keys = torch.stack(keys, -1).reshape(BM * Lq, PL * 4)

    def distinct(rows):
        s = rows.sort(-1).values
        first = s[:, :1] >= 0
        new = (s[:, 1:] >= 0) & (s[:, 1:] != s[:, :-1])
        return int(first.sum() + new.sum())

    stats = {"corners": int((keys >= 0).sum()),
             "distinct_per_query": distinct(keys)}
    if tile_rows:
        pad = keys.new_full(((-keys.shape[0]) % tile_rows, PL * 4), -1)
        tiles = torch.cat([keys, pad]).reshape(-1, tile_rows * PL * 4)
        stats.update(tile_rows=tile_rows, distinct_per_tile=distinct(tiles),
                     tiles=tiles.shape[0])
    return stats


def stats_line(stats, merged_tiles=None):
    """The corner counts of ``corner_stats`` as one line of text, with the
    tiles that K4's C entry counted on its merged path in one call."""
    n, per_query = stats["corners"], stats["distinct_per_query"]
    line = (f"corners {n}, distinct tokens per query {per_query} "
            f"({n / max(1, per_query):.2f}x fewer)")
    if "tiles" not in stats:
        return line
    per_tile, tiles = stats["distinct_per_tile"], stats["tiles"]
    return (line + f", per tile of {stats['tile_rows']} rows {per_tile} "
            f"({n / max(1, per_tile):.2f}x fewer); tiles launched on the "
            f"merged path {merged_tiles} of {tiles} "
            f"({merged_tiles / tiles:.3f})")


def hat_agrees(got, ref):
    """(ok, tolerance): f32 atol/rtol 1e-5; bf16 against the f32 plain
    version on the same bf16 value, where rounding the output once costs
    at most 2^-8 of it."""
    if got.dtype == torch.float32:
        tol = 1e-5 + 1e-5 * ref.abs()
        return bool(((got - ref).abs() <= tol).all()), "atol 1e-5 rtol 1e-5"
    tol = 1e-5 + 2.0 ** -8 * ref.abs()
    return (bool(((got.float() - ref).abs() <= tol).all()),
            "atol 1e-5 rtol 2^-8 (bf16 output rounding)")


def phase_hat_kernel():
    """K3 (``csrc/hat_sample_fwd.cu``) against its plain version at the QRF
    shape and at edge cases, f32 and bf16; times at the QRF shape."""
    from dfvod_tpu_torch.ops import hat_sample as hs
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [("qrf", dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [(f"edge_d{d}", dt) for d in (8, 40, 256)
              for dt in (torch.float32, torch.bfloat16)]
    result = {}
    for name, dt in cases:
        if name == "qrf":
            value = torch.randn((QRF_FRAMES, H // 16, W // 16, 256),
                                generator=gen, device="cuda").to(dt)
            px, py, aw = qrf_points(gen)
        else:
            d = int(name[len("edge_d"):])
            value = torch.randn((3, 7, 9, d), generator=gen,
                                device="cuda").to(dt)
            px, py, aw = edge_points(gen, 3, 133, 5, 7, 9)
        got = hs.hat_sample(value, px, py, aw)
        torch.cuda.synchronize()
        ref = hs.hat_sample_plain(value.float(), px, py, aw)
        ok, tol = hat_agrees(got, ref)
        ok = ok and bool(torch.isfinite(got.float()).all())
        max_err = float((got.float() - ref).abs().max())
        print(f"[hat] {name:9s} {str(dt).replace('torch.', ''):9s} "
              f"value={tuple(value.shape)} Lq={px.shape[1]} PL={px.shape[2]}"
              f" max_abs_err={max_err:.3e} ({tol}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"hat_sample_fwd disagrees with its plain version: {name} "
                  f"{dt} max_abs_err {max_err}")
        if name == "qrf" and dt == torch.bfloat16:
            yard = grid_sample_hat(value, px, py, aw)
            result = {
                "max_abs_err": max_err,
                "ms": cuda_ms(lambda: hs.hat_sample(value, px, py, aw), 50),
                "plain_ms": cuda_ms(
                    lambda: hs.hat_sample_plain(value, px, py, aw), 5),
                "yardstick_ms": cuda_ms(
                    lambda: grid_sample_hat(value, px, py, aw), 20),
                "yardstick_max_abs_err": float(
                    (yard.float() - ref).abs().max()),
            }
            result["bound_ms"], result["bound_by"] = hat_bound(
                value, px, py, aw, got)
            r = result
            print(f"[hat] time qrf bf16 value, f32 points: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"grid_sample yardstick {r['yardstick_ms']:.4f} ms "
                  f"(max_abs_err {r['yardstick_max_abs_err']:.3e}: a bf16 "
                  f"grid), bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
                  f"card {card_line()}", flush=True)
            print(f"[hat] corners qrf: "
                  f"{stats_line(corner_stats(value, px, py))}", flush=True)
    return result


# ------------------------------------- K4: the backward of RoIAlign's sampling
CLIP_TRAIN_FRAMES = 5   # TransVOD++_withdepth.sh: batch_size 1, 4 ref frames
# per sample point ~30 coordinate, weight and reduction ops; per channel 8
# for gv (4 corners x scale and add), 8 more for the 4 corner dot products
HAT_BWD_OPS_PER_POINT, HAT_BWD_OPS_PER_CHANNEL = 30, 8


def hat_bwd_bound(value, px, py, aw, go, point_grads):
    """(least ms, 'bytes' | 'operations') of K4: go, px, py, aw read once
    and gv written once in the value's dtype; with the point gradients the
    value read once more and gpx, gpy, gaw (f32) written once."""
    moved = nbytes(go, px, py, aw, value)
    per_channel = HAT_BWD_OPS_PER_CHANNEL
    if point_grads:
        moved += nbytes(value, px, py, aw)
        per_channel *= 2
    return bound(moved, px.numel() * (per_channel * value.shape[-1]
                                      + HAT_BWD_OPS_PER_POINT))


def hat_bwd_agrees(got, ref):
    """(ok, tolerance, {output: max abs err}) of K4's outputs against the
    plain backward's in f32 on the same (bf16-rounded) inputs: atol 1e-4
    rtol 1e-4, since the atomics add gv in another order on every run and
    the dot products sum lane by lane; a bf16 gv also rounded once
    (rtol 2^-8 more)."""
    ok, errs = True, {}
    for name, g, r in zip(("gv", "gpx", "gpy", "gaw"), got, ref):
        if g is None:
            continue
        rtol = 1e-4 + (2.0 ** -8 if g.dtype == torch.bfloat16 else 0.0)
        e = (g.float() - r.reshape(g.shape)).abs()
        ok &= bool((e <= 1e-4 + rtol * r.reshape(g.shape).abs()).all())
        errs[name] = float(e.max())
    return ok, "atol 1e-4 rtol 1e-4 (+2^-8 for a bf16 gv)", errs


def uniform_points(gen, BM, Lq, PL, h, w):
    """Points spread uniformly over the grid, aw 1/4: RoIAlign's weights
    without its clustering."""
    px = torch.rand((BM, Lq, PL), generator=gen, device="cuda") * (w - 1)
    py = torch.rand((BM, Lq, PL), generator=gen, device="cuda") * (h - 1)
    return px, py, torch.full_like(px, 0.25)


def phase_hat_bwd_kernel():
    """K4 (``csrc/hat_sample_bwd.cu``) against the plain backward on the
    card: at the f32 training shape (1 clip x 5 frames, 300 RoIs x 49 bins
    x 4 points on the 38x50 memory, D=256) with real QRF points and with
    uniform ones, in the bf16 mix (bf16 value and go, as autocast feeds
    it), and at the edge points at D=256 and D=40; with and without the
    point gradients. Times at the training shape."""
    from dfvod_tpu_torch.ops import hat_sample as hs
    gen = torch.Generator(device="cuda").manual_seed(3)
    h, w = H // 16, W // 16
    value_only, every = (True, False, False, False), (True,) * 4
    cases = [(pts, dt, needs)
             for pts in ("qrf", "uniform", "edge_d256", "edge_d40")
             for dt in (torch.float32, torch.bfloat16)
             for needs in (value_only, every)]
    result = {}
    for pts, dt, needs in cases:
        if pts in ("qrf", "uniform"):
            value = torch.randn((CLIP_TRAIN_FRAMES, h, w, 256), generator=gen,
                                device="cuda").to(dt)
            px, py, aw = (qrf_points(gen, CLIP_TRAIN_FRAMES) if pts == "qrf"
                          else uniform_points(gen, CLIP_TRAIN_FRAMES,
                                              QRF_ROIS * 49, 4, h, w))
        else:
            value = torch.randn((3, 7, 9, int(pts[len("edge_d"):])),
                                generator=gen, device="cuda").to(dt)
            px, py, aw = edge_points(gen, 3, 133, 5, 7, 9)
        go = torch.randn((value.shape[0], px.shape[1], value.shape[-1]),
                         generator=gen, device="cuda").to(dt)
        # (rows per tile, tiles launched) of the merged path, as the C entry
        # counts them; a source without that path counts nothing
        tiles_of = getattr(hs, "bwd_merged_tiles", lambda: (None, 0))
        tiles0 = tiles_of()[1]
        got = hs.hat_sample_bwd(value, px, py, aw, go, needs=needs)
        torch.cuda.synchronize()
        tile_rows, merged = tiles_of()[0], tiles_of()[1] - tiles0
        ref = hs.hat_sample_plain_bwd(value.float(), px, py, aw, go.float())
        ok, tol, errs = hat_bwd_agrees(got, ref)
        ok &= all(g is None or bool(torch.isfinite(g.float()).all())
                  for g in got)
        ok &= [g is not None for g in got] == list(needs)
        ok &= got[0].dtype == dt and got[0].shape == value.shape
        form = "gv" if needs == value_only else "gv+points"
        tag = str(dt).replace("torch.", "")
        print(f"[hat_bwd] {pts:9s} {tag:8s} {form:9s} "
              f"value={tuple(value.shape)} Lq={px.shape[1]} PL={px.shape[2]} "
              f"max_abs_err {', '.join(f'{k} {v:.3e}' for k, v in errs.items())}"
              f" ({tol}) {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"hat_sample_bwd disagrees with its plain version: {pts} "
                  f"{tag} {form} {errs}")
        if pts not in ("qrf", "uniform") or (pts == "uniform"
                                             and needs != value_only):
            continue
        # the plain version's and the yardstick's backward for the same
        # gradients, through autograd
        if needs == value_only:
            leaves = (value,)

            def plain(v):
                return hs.hat_sample_plain(v, px, py, aw)

            def yard(v):
                return grid_sample_hat(v, px, py, aw)
        else:
            leaves, plain, yard = ((value, px, py, aw), hs.hat_sample_plain,
                                   grid_sample_hat)
        r = {"max_abs_err": max(errs.values()),
             "ms": cuda_ms(lambda: hs.hat_sample_bwd(value, px, py, aw, go,
                                                     needs=needs), 20),
             "plain_ms": backward_ms(plain, leaves, go, 5),
             "yardstick_ms": backward_ms(yard, leaves, go, 10)}
        r["bound_ms"], r["bound_by"] = hat_bwd_bound(
            value, px, py, aw, go, needs != value_only)
        result[f"{pts}_{tag}_{form}"] = r
        print(f"[hat_bwd] time {pts} {tag} {form}: kernel {r['ms']:.4f} ms, "
              f"plain backward {r['plain_ms']:.4f} ms, grid_sample backward "
              f"yardstick {r['yardstick_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); card "
              f"{card_line()}", flush=True)
        stats = corner_stats(value, px, py, tile_rows)
        print(f"[hat_bwd] corners {pts}: {stats_line(stats, merged)}",
              flush=True)
    return result


# ------------------------------------------- K5b/c: the folded-corner gather
def embedding_bag_gather(table, gidx, gw):
    """Yardstick only, never called by the port: the same weighted row
    gather as one ``F.embedding_bag(mode="sum")`` over the flat table."""
    import torch.nn.functional as F
    return F.embedding_bag(gidx, table, per_sample_weights=gw, mode="sum")


def phase_corner_gather_kernel():
    """K5b/c (``csrc/corner_gather_fwd.cu``) against its plain version: the
    MSDA dispatch's folded corners at the B=8 encoder shape and at 4
    levels, f32 and the serving mix (each on the vector path by the C
    entry's count), and direct calls with indices outside [0, S); times at
    the encoder shape in bf16, with one ``F.embedding_bag`` over the same
    rows as the library yardstick."""
    from dfvod_tpu_torch.ops import corner_gather as cg
    from dfvod_tpu_torch.ops import msda
    gen = torch.Generator(device="cuda").manual_seed(5)
    f32 = (torch.float32,) * 3
    serve = (torch.bfloat16, torch.float32, torch.bfloat16)
    enc = (((38, 50),), BATCH, 1900, 8, 32, 4)
    multi = (((76, 100), (38, 50), (19, 25), (10, 13)), 2, 300, 8, 32, 4)
    result = {}
    for name, (shapes, *dims), dtypes in [("enc", enc, f32),
                                          ("enc", enc, serve),
                                          ("multi_l4", multi, f32),
                                          ("multi_l4", multi, serve)]:
        value, loc, attw = msda_inputs(gen, shapes, *dims, dtypes)
        B, S, M, D = value.shape
        idx, w = cg.corner_indices_weights(shapes, loc, attw)
        got, paths = path_counts(cg, lambda: cg.corner_gather(value, idx, w))
        ref = cg.corner_gather_plain(value.float(), idx, w)
        ok, tol = hat_agrees(got, ref)
        via = msda.ms_deform_attn(value, shapes, loc, attw, impl="flat")
        torch.cuda.synchronize()
        ok &= torch.equal(via, got.reshape(via.shape))
        max_err = float((got.float() - ref).abs().max())
        tag = "f32" if dtypes == f32 else "bf16 value/f32 loc/bf16 attw"
        print(f"[gather] {name:8s} {tag:28s} value={tuple(value.shape)} "
              f"Lq={loc.shape[1]} K={idx.shape[-1]} max_abs_err={max_err:.3e}"
              f" ({tol}; the dispatch's output bit-equal) path {paths} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"corner_gather_fwd disagrees with its plain version: "
                  f"{name} {tag} max_abs_err {max_err}")
        check(paths in (None, {"vector": 1, "scalar": 0}),
              f"corner_gather_fwd took the paths {paths} at {name} {tag}")
        if name == "enc" and dtypes == serve:
            table = value.permute(0, 2, 1, 3).reshape(B * M * S, D)
            off = (torch.arange(B * M, device="cuda").reshape(B, 1, M, 1)
                   * S).int()
            gidx = (idx + off).reshape(-1, idx.shape[-1])
            lib_dtype = table.dtype
            try:
                embedding_bag_gather(table, gidx, w.reshape(gidx.shape).to(
                    table.dtype))
            except RuntimeError:
                lib_dtype = torch.float32      # refused bf16: time f32
            lt, lw = table.to(lib_dtype), w.reshape(gidx.shape).to(lib_dtype)
            r = {"max_abs_err": max_err, "paths": paths,
                 "ms": cuda_ms(lambda: cg.corner_gather(value, idx, w), 50),
                 "dispatch_ms": cuda_ms(lambda: msda.ms_deform_attn(
                     value, shapes, loc, attw, impl="flat"), 20),
                 "plain_ms": cuda_ms(lambda: cg.corner_gather_plain(
                     value, idx, w), 10),
                 "library_ms": cuda_ms(lambda: embedding_bag_gather(
                     lt, gidx, lw), 50),
                 "library_dtype": str(lib_dtype).replace("torch.", "")}
            r["bound_ms"], r["bound_by"] = bound(
                nbytes(value, idx, w, got), idx.numel() * 2 * D)
            result = r
            print(f"[gather] time enc bf16: kernel {r['ms']:.4f} ms (with "
                  f"the corner folding, tensor code: {r['dispatch_ms']:.4f} "
                  f"ms), plain {r['plain_ms']:.4f} ms, F.embedding_bag "
                  f"({r['library_dtype']}) {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
                  f"{nbytes(value, idx, w, got) / 1e6:.1f} MB)", flush=True)
    # indices outside [0, S) contribute 0; the JAX layout (BM, S, D)
    for dt in (torch.float32, torch.bfloat16):
        v = torch.randn((6, 50, 40), generator=gen, device="cuda").to(dt)
        idx = torch.randint(-5, 55, (6, 133, 12), generator=gen,
                            device="cuda", dtype=torch.int32)
        w = torch.randn((6, 133, 12), generator=gen, device="cuda")
        got, paths = path_counts(cg, lambda: cg.onehot_sample(v, idx, w))
        ref = cg.onehot_sample(v.float().cpu(), idx.cpu(), w.cpu()).cuda()
        ok, tol = hat_agrees(got, ref)
        max_err = float((got.float() - ref).abs().max())
        print(f"[gather] oob_d40  {str(dt).replace('torch.', ''):28s} "
              f"v=(6, 50, 40) Lq=133 K=12 idx in [-5, 55) max_abs_err="
              f"{max_err:.3e} ({tol}) path {paths} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"corner_gather_fwd disagrees out of range: {dt}")
    return result


# ------------------------------------------ K5a: the level-stacked sampling
def sparse_points(gen, shapes, B, Lq, M, P, nan_rows=0):
    """The pixel coordinates ``ms_deform_attn_hat(sparse=True)`` builds
    (level-stacked, ``py`` offset per level) from U(-0.1, 1.1) locations,
    (BM, Lq, L * P); the first ``nan_rows`` queries all NaN."""
    L = len(shapes)
    loc = torch.rand((B, Lq, M, L, P, 2), generator=gen, device="cuda")
    loc = loc * 1.2 - 0.1
    loc[:, :nan_rows] = float("nan")
    pxs, pys, y_off = [], [], 0.0
    for lvl, (h, w) in enumerate(shapes):
        pxs.append(loc[:, :, :, lvl, :, 0] * w - 0.5)
        pys.append(loc[:, :, :, lvl, :, 1] * h - 0.5 + y_off)
        y_off += h + 2.0
    aw = torch.randn((B, Lq, M, L * P), generator=gen, device="cuda"
                     ).softmax(-1)

    def bm(t):
        return t.transpose(1, 2).reshape(B * M, Lq, L * P).contiguous()

    return bm(torch.cat(pxs, -1)), bm(torch.cat(pys, -1)), bm(aw)


# the strides 8-64 of a 608x800 frame, MSDA's 4 levels
SPARSE_L4 = ((76, 100), (38, 50), (19, 25), (10, 13))


def phase_hat_sparse_kernel():
    """K5a (``csrc/hat_sample_sparse_fwd.cu``) against the plain version at
    the B=8 encoder shape (one level) and at 4 levels, f32 and bf16, each
    on the vector path by its C entry's count; a query whose every point is
    NaN gives 0. The encoder shape through ``ms_deform_attn_hat(sparse=
    True)`` with the counts set to 0 just before. Times in bf16 at the
    encoder shape, beside ``F.grid_sample`` and the weighted sum, and at
    the 4 levels of a B=8 608x800 frame (``enc_l4``: S = Lq = 10105, PL =
    16)."""
    from dfvod_tpu_torch.ops import hat_sample as hs
    from dfvod_tpu_torch.ops import msda_forms as mf
    gen = torch.Generator(device="cuda").manual_seed(6)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("enc", ((38, 50),), BATCH, 1900, f32),
             ("enc", ((38, 50),), BATCH, 1900, bf16),
             ("multi_l4", SPARSE_L4, 2, 300, f32),
             ("multi_l4", SPARSE_L4, 2, 300, bf16),
             ("enc_l4", SPARSE_L4, BATCH, 10105, bf16)]
    results = {}
    for name, shapes, B, Lq, dt in cases:
        S = sum(h * w for h, w in shapes)
        v = torch.randn((B * 8, S, 32), generator=gen, device="cuda").to(dt)
        px, py, aw = sparse_points(gen, shapes, B, Lq, 8, 4, nan_rows=3)
        got, paths = path_counts(hs, lambda: hs.hat_sample_sparse(
            v, shapes, px, py, aw))
        ref = hs.hat_sample_sparse_plain(v.float(), shapes, px, py, aw)
        ok, tol = hat_agrees(got, ref)
        ok &= bool((got[:, :3] == 0).all()) and bool(
            torch.isfinite(got.float()).all())
        max_err = float((got.float() - ref).abs().max())
        tag = str(dt).replace("torch.", "")
        print(f"[hat_sparse] {name:8s} {tag:8s} v={tuple(v.shape)} Lq={Lq} "
              f"PL={px.shape[-1]} max_abs_err={max_err:.3e} ({tol}; 3 NaN "
              f"queries exactly 0) path {paths} {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"hat_sample_sparse_fwd disagrees with its plain "
                  f"version: {name} {tag} max_abs_err {max_err}")
        check(paths in (None, {"vector": 1, "scalar": 0}),
              f"hat_sample_sparse_fwd took the paths {paths} at {name} "
              f"{tag}")
        if dt != bf16 or name == "multi_l4":
            continue
        r = {"max_abs_err": max_err, "paths": paths,
             "ms": cuda_ms(lambda: hs.hat_sample_sparse(
                 v, shapes, px, py, aw), 50),
             "plain_ms": cuda_ms(lambda: hs.hat_sample_sparse_plain(
                 v, shapes, px, py, aw), 10),
             "shape": f"BM={v.shape[0]} S={S} Lq={Lq} D=32 "
                      f"PL={px.shape[-1]} L={len(shapes)}"}
        r["bound_ms"], r["bound_by"] = bound(
            nbytes(v, px, py, aw, got),
            px.numel() * (HAT_OPS_PER_CHANNEL * 32 + HAT_OPS_PER_POINT))
        entry = ""
        if name == "enc":
            # one level: F.grid_sample on the (BM, H, W, D) value
            r["yardstick_ms"] = cuda_ms(lambda: grid_sample_hat(
                v.view(B * 8, *shapes[0], 32), px, py, aw), 20)
            value, loc, attw = msda_inputs(
                gen, shapes, BATCH, 1900, 8, 32, 4,
                (torch.bfloat16, torch.float32, torch.bfloat16))
            (out, counts), entry_paths = path_counts(hs, lambda: counted(
                lambda: mf.ms_deform_attn_hat(value, shapes, loc, attw,
                                              sparse=True)))
            k1 = msda_plain_f32(value, shapes, loc, attw)
            entry_err = float((out.float() - k1).abs().max())
            check(counts == want_launches(hat_sample_sparse=1)
                  and entry_paths in (None, {"vector": 1, "scalar": 0})
                  and entry_err <= 3e-2,
                  f"ms_deform_attn_hat(sparse=True) launched {counts} on "
                  f"{entry_paths}, max_abs_err {entry_err} against the "
                  f"per-level form")
            r["launches"] = counts["hat_sample_sparse"]
            entry = (f"entry ms_deform_attn_hat(sparse=True): launches "
                     f"{counts}, path {entry_paths}, max_abs_err "
                     f"{entry_err:.3e} against the per-level plain form "
                     f"(atol 3e-2); grid_sample yardstick "
                     f"{r['yardstick_ms']:.4f} ms, ")
        results[name] = r
        print(f"[hat_sparse] time {name} {r['shape']} bf16: {entry}kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{nbytes(v, px, py, aw, got) / 1e6:.1f} MB); card "
              f"{card_line()}", flush=True)
    return results


def msda_plain_f32(value, shapes, loc, attw):
    from dfvod_tpu_torch.ops import msda
    return msda.ms_deform_attn_plain(value.float(), shapes, loc.float(),
                                     attw.float())


def phase_single_level_hat_entries():
    """K5d/e: ``ms_deform_attn_hat_tiled`` and ``_sep`` launch K1 at the
    B=8 encoder shape (one launch each, counts set to 0 just before), held
    against the plain version, f32 and the serving mix; in the serving mix
    timed through the entry, beside the plain version and K1's bound on
    these inputs."""
    from dfvod_tpu_torch.ops import msda
    from dfvod_tpu_torch.ops import msda_forms as mf
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = ((38, 50),)
    result = {}
    for form, fn in (("tiled", mf.ms_deform_attn_hat_tiled),
                     ("sep", mf.ms_deform_attn_hat_sep)):
        for dtypes in ((torch.float32,) * 3,
                       (torch.bfloat16, torch.float32, torch.bfloat16)):
            value, loc, attw = msda_inputs(gen, shapes, BATCH, 1900, 8, 32,
                                           4, dtypes)
            got, counts = counted(lambda: fn(value, shapes, loc, attw))
            ref = msda_plain_f32(value, shapes, loc, attw)
            err = float((got.float() - ref).abs().max())
            f32 = value.dtype == torch.float32
            ok = (bool(((got.float() - ref).abs()
                        <= 1e-5 + 1e-5 * ref.abs()).all()) if f32
                  else err <= 3e-2)
            ok &= counts == want_launches(msda_fwd=1)
            tag = "f32" if f32 else "bf16 value/f32 loc/bf16 attw"
            print(f"[hat_{form}] enc {tag:28s} launches {counts['msda_fwd']} "
                  f"msda_fwd max_abs_err={err:.3e} "
                  f"({'atol 1e-5 rtol 1e-5' if f32 else 'atol 3e-2'}) "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"ms_deform_attn_hat_{form}: launches {counts}, "
                      f"max_abs_err {err}")
            if not f32:
                r = {"max_abs_err": err, "launches": counts["msda_fwd"],
                     "ms": cuda_ms(lambda: fn(value, shapes, loc, attw), 50),
                     "plain_ms": cuda_ms(lambda: msda.ms_deform_attn_plain(
                         value, shapes, loc, attw), 10)}
                r["bound_ms"], r["bound_by"] = msda_bound(value, loc, attw,
                                                          got)
                result[form] = r
                print(f"[hat_{form}] time enc {tag}: through the entry "
                      f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return result


# ----------------------------------------- K6: the fused ResNet layer1
def layer1_input(backbone, img):
    """The (B, H/4, W/4, 64) NHWC view of layer1's input: the stem on the
    normalized frames, in the backbone's dtype and channels-last memory."""
    import torch.nn.functional as F
    x = img.to(next(backbone.parameters()).dtype).permute(0, 3, 1, 2)
    x = F.max_pool2d(torch.relu(backbone.bn1(backbone.conv1(x))), 3, 2, 1)
    return x.permute(0, 2, 3, 1)


def k6_agrees(got, ref):
    """(ok, tolerance, max abs err, relative L2): K6 sums each product on
    the tensor cores, the plain version with f32 FMAs, so a bf16 rounding
    of t, u or a block's output may fall one step (2^-8 relative) the
    other way and carry into the next block. The phase prints both sides'
    relative L2 from the f64-summed form, which shows how much of the
    difference each side's rounding makes (PERF.md has the readings; the
    largest, K6 against the plain version, was 1.1e-3). Gate: relative L2
    within 2e-3 and every entry within 2^-5 of the largest output."""
    d = (got.float() - ref.float()).abs()
    rel = relative_l2(got, ref)
    max_err = float(d.max())
    ok = rel <= 2e-3 and max_err <= 2.0 ** -5 * float(ref.float().abs().max())
    return ok, "relative L2 2e-3, max 2^-5 of max|ref|", max_err, rel


def relative_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def k6_bound(x, weights):
    """((least ms, 'bytes' | 'operations') of the stage, the same of the
    stage as K6 runs it) from the multiply-adds at the bf16 tensor-core
    peak and the bytes over HBM. The stage reads x and the weights once and
    writes its output once; K6's launch per block also writes each block's
    output and reads it back in the next block."""
    B, H, W, _ = x.shape
    params = nbytes(*[t for blk in weights for t in blk if t is not None])
    cin = x.shape[-1]
    acts, macs = 0, 0
    for w1, _, _, _, w3, _, wd, _ in weights:
        cm, cout = w1.shape[1], w3.shape[1]
        acts += B * H * W * (cin + cout) * x.element_size()
        macs += B * H * W * (cin * cm + 9 * cm * cm + cm * cout
                             + (cin * cout if wd is not None else 0))
        cin = cout
    stage_bytes = (x.numel() + B * H * W * cin) * x.element_size() + params
    return (bound(stage_bytes, 2 * macs, BF16_OPS_PER_S),
            bound(acts + params, 2 * macs, BF16_OPS_PER_S))


def phase_fused_bottleneck_kernel():
    """K6 (``csrc/fused_bottleneck.cu``, one launch per block) against the
    plain fused form on the card: the serve model's layer1 (folded from its
    bf16-cast FrozenBN constants, as ``Server`` holds them) on its real
    input, the stem of eight 608x800 frames; then borders and a height that
    is no multiple of the tile. Each call's kernel paths as the C entry
    counts them (the serve shape takes the layer1 path three times) and
    each path's shared memory. Times at the serving shape; the yardstick
    is the port's unfused bf16 layer1 (cuDNN convolutions and elementwise
    passes, not one call)."""
    from dfvod_tpu_torch.data.device_pipeline import device_normalize
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.ops import fused_bottleneck as fb
    from dfvod_tpu_torch.utils.config import Config, ModelConfig
    model, _, _ = build_model(Config(model=ModelConfig(
        fusion_type="LateFusion")), device="cpu", seed=0)
    randomize(model, seed=1)
    backbone = model.backbone.to(device="cuda", dtype=torch.bfloat16,
                                 memory_format=torch.channels_last)
    del model
    weights = [getattr(backbone.layer1, f"block_{i}").folded_weights(
        torch.bfloat16) for i in range(3)]
    img, _ = device_normalize(*(t.cuda() for t in frames(0)))
    with torch.no_grad():
        x = layer1_input(backbone, img[..., :3])
    check(tuple(x.shape) == (BATCH, H // 4, W // 4, 64)
          and x.is_contiguous(), f"layer1 input {tuple(x.shape)} is not a "
                                 f"contiguous NHWC view")
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases = [("serve", x)] + [
        (f"rand_{tuple(shape)}", torch.relu(torch.randn(
            shape, generator=gen, device="cuda")).bfloat16())
        for shape in ((2, 149, 37, 64), (1, 8, 16, 64), (3, 5, 3, 64))]
    result = {}
    for name, xx in cases:
        with torch.no_grad():
            got, paths = path_counts(
                fb, lambda: fb.fused_bottleneck_stage(xx, weights))
            ref = fb.fused_stage_plain(xx, weights)
            ref64 = fb.fused_stage_plain(xx, weights, torch.float64)
        ok, tol, max_err, rel = k6_agrees(got, ref)
        ok &= bool(torch.isfinite(got.float()).all())
        rel64, plain_rel64 = relative_l2(got, ref64), relative_l2(ref, ref64)
        print(f"[fused] {name:22s} x={tuple(xx.shape)} max_abs_err="
              f"{max_err:.3e} relative L2 {rel:.3e} max|ref| "
              f"{float(ref.float().abs().max()):.3f} ({tol}) "
              f"{'ok' if ok else 'FAIL'}; relative L2 from the f64-summed "
              f"form: kernel {rel64:.3e}, plain {plain_rel64:.3e}; path "
              f"{paths}", flush=True)
        check(ok, f"fused_bottleneck disagrees with its plain version: "
                  f"{name} max_abs_err {max_err} relative L2 {rel}")
        check(name != "serve"
              or paths in (None, {"layer1": 3, "generic": 0}),
              f"layer1 at the serve shape took the paths {paths}")
        del ref64
        if name == "serve":
            layer1 = backbone.layer1
            layer1.allow_fused = False
            xn = xx.permute(0, 3, 1, 2)          # NCHW, channels-last memory
            with torch.no_grad():
                unfused = layer1(xn).permute(0, 2, 3, 1)
                r = {"max_abs_err": max_err, "relative_l2": rel,
                     "paths": paths,
                     "relative_l2_f64": rel64,
                     "plain_relative_l2_f64": plain_rel64,
                     "unfused_relative_l2": relative_l2(unfused, ref),
                     "ms": cuda_ms(lambda: fb.fused_stage_cuda(
                         xx, weights), 20),
                     "plain_ms": cuda_ms(lambda: fb.fused_stage_plain(
                         xx, weights), 5),
                     "yardstick_ms": cuda_ms(lambda: layer1(xn), 20)}
            ((r["bound_ms"], r["bound_by"]),
             (r["design_bound_ms"], r["design_bound_by"])) = k6_bound(
                xx, weights)
            if hasattr(fb, "smem_bytes"):   # the C entry's paths' budgets
                r["smem_bytes"] = {f"cin{c}": fb.smem_bytes(c, 64, 256)
                                   for c in (64, 256)}
                print(f"[fused] shared memory per CTA at layer1's widths "
                      f"(Cm 64, Cout 256): {r['smem_bytes']}", flush=True)
            result = r
            print(f"[fused] time serve (8, 152, 200, 64) bf16: kernel "
                  f"{r['ms']:.4f} ms (3 launches), plain {r['plain_ms']:.4f}"
                  f" ms, unfused bf16 layer1 yardstick (cuDNN, not one call;"
                  f" relative L2 {r['unfused_relative_l2']:.3e} from the "
                  f"plain fused form) {r['yardstick_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}; with the "
                  f"traffic of a launch per block "
                  f"{r['design_bound_ms']:.4f} ms, {r['design_bound_by']})",
                  flush=True)
    return result


# ----------------------------------------------------------- serving path
@torch.no_grad()
def randomize(model, seed):
    """Give the zero-initialized projections random weights so that
    sampling points are fractional and varied (as ``tests/torch_ref.py``'s
    ``randomize`` does). The model lies on the CPU."""
    from dfvod_tpu_torch.models.backbone_dformer import BatchNorm
    from dfvod_tpu_torch.models.layers import MSDeformAttn
    from dfvod_tpu_torch.models.transformer import DetectionHead
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, MSDeformAttn):
            m.sampling_offsets.weight.normal_(0, 0.02, generator=gen)
            m.attention_weights.weight.normal_(0, 0.2, generator=gen)
            m.attention_weights.bias.normal_(0, 0.2, generator=gen)
        elif isinstance(m, DetectionHead):
            m.bbox_layers_2.weight.normal_(0, 0.02, generator=gen)
        elif isinstance(m, BatchNorm):
            m.running_mean.normal_(0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model


def frames(seed, B=BATCH):
    """uint8 RGB-D frames padded bottom/right, with their content sizes:
    six full frames and two padded ones."""
    gen = torch.Generator().manual_seed(seed)
    imgs = torch.randint(0, 256, (B, H, W, 4), generator=gen,
                         dtype=torch.uint8)
    sizes = torch.tensor([[H, W]] * (B - 2) + [[600, 750], [450, 800]])
    for i, (h, w) in enumerate(sizes.tolist()):
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    return imgs, sizes


# MSDA layers per forward at 6+6 layers: the encoder and decoder, plus
# LateFusion's depth layer, Encoder_CrossFusion's 4 fusion layers or
# Backbone_CrossFusion's 3 fusion sites
MSDA_LAYERS = {"LateFusion": 13, "Encoder_CrossFusion": 16,
               "Backbone_CrossFusion": 15}
TAGS = {"LateFusion": "serve", "Encoder_CrossFusion": "serve-ecf",
        "Backbone_CrossFusion": "serve-bcf"}


def phase_serve(requests=6, fusion="LateFusion", warmup=0):
    """The ``fusion`` recipe's model at full width, B=8 608x800 bf16
    through ``Server``: ``warmup`` requests, then ``requests`` timed ones
    with every kernel count set to 0 just before and read just after (the
    first timed request is left out of the mean); the bf16 boxes against
    the port's own f32 forward."""
    from dfvod_tpu_torch.data.device_pipeline import device_normalize
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.serve import Server
    from dfvod_tpu_torch.utils.config import Config, ModelConfig

    tag = TAGS[fusion]
    cfg = Config(model=ModelConfig(fusion_type=fusion))
    m = cfg.model
    print(f"[{tag}] {fusion} hidden={m.hidden_dim} heads={m.nheads} "
          f"enc={m.enc_layers} dec={m.dec_layers} queries={m.num_queries} "
          f"dc5={m.dilation} refine={m.with_box_refine} B={BATCH} {H}x{W} "
          f"bf16", flush=True)
    t0 = time.perf_counter()
    ref_model, _, _ = build_model(cfg, device="cpu", seed=0)
    randomize(ref_model, seed=1)
    ref_model = ref_model.to("cuda")
    server = Server(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    server.model.load_state_dict(ref_model.state_dict())
    print(f"[{tag}] built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in server.model.parameters())} params",
          flush=True)
    reqs = [frames(seed) for seed in range(requests)]
    reqs = [(x.to("cuda"), s.to("cuda")) for x, s in reqs]
    for _ in range(warmup):
        server(*reqs[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    times, dets = [], []

    def run():
        for x, s in reqs:
            t0 = time.perf_counter()
            dets.append(server(x, s))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    (_, counts), paths = path_counts(msda_paths("msda_fwd"),
                                     lambda: counted(run))
    launches = counts["msda_fwd"]
    n = MSDA_LAYERS[fusion]
    print(f"[{tag}] msda_fwd launches over {requests} requests: {launches}"
          f" ({launches / requests:g} per forward; K1 paths {paths})",
          flush=True)
    check(counts == want_launches(msda_fwd=n * requests),
          f"expected {n} msda_fwd launches per forward and no other kernel, "
          f"got {counts}")

    for d in dets:
        check(d["scores"].shape == (BATCH, 100)
              and d["boxes"].shape == (BATCH, 100, 4),
              f"detections of shape {tuple(d['boxes'].shape)}")
        check(bool(torch.isfinite(d["scores"]).all()
                   and torch.isfinite(d["boxes"].float()).all()),
              "non-finite detections")
    steady = times[1:]
    ms = 1e3 * sum(steady) / len(steady)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] ms per batch of {BATCH}: mean {ms:.3f} (first request "
          f"{1e3 * times[0]:.1f}; per request "
          f"{', '.join(f'{1e3 * t:.3f}' for t in steady)}) -> "
          f"{BATCH / (ms / 1e3):.1f} frames/s; peak memory "
          f"{peak:.2f} GiB", flush=True)

    # bf16 serve against the port's own f32 forward, same weights/inputs
    x, s = reqs[0]
    with torch.no_grad():
        out16 = server.forward(x, s)
        img, mask = device_normalize(x, s)
        out32 = ref_model(img, mask)
    diff = (out16["pred_boxes"].float() - out32["pred_boxes"]).abs()
    print(f"[{tag}] bf16 vs f32 boxes (normalized cxcywh): max "
          f"{float(diff.max()):.3e} mean {float(diff.mean()):.3e} "
          f"(tolerance max {BOX_MAX_TOL}, mean {BOX_MEAN_TOL}); logits "
          f"max diff {float((out16['pred_logits'].float() - out32['pred_logits']).abs().max()):.3e}",
          flush=True)
    check(bool(torch.isfinite(out32["pred_boxes"]).all()), "f32 not finite")
    check(float(diff.max()) <= BOX_MAX_TOL
          and float(diff.mean()) <= BOX_MEAN_TOL,
          "bf16 serve disagrees with the f32 forward")
    return ({"ms_per_batch": ms, "frames_per_s": BATCH / (ms / 1e3),
             "launches": launches, "requests": requests,
             "peak_memory_gib": peak, "box_max": float(diff.max()),
             "box_mean": float(diff.mean()), "paths": paths},
            server, ref_model, reqs[0], out32)


def phase_serve_variants(server, ref_model, req, out32, requests=3):
    """The serving path at full width with ``fused_stages=True`` on the
    served model's ResNet-50 (layer1 through K6), under each
    ``DFVOD_MSDA_IMPL`` (unset first; the variable is read on every call):
    one warm-up and ``requests`` timed requests each, counts set to 0 just
    before the timed requests and read just after; 13 K1 or 13 K5b/c and 3
    K6 launches per request, every K6 launch on its layer1 path and each
    K5b/c launch's path by the C entries' counts; the boxes against the
    port's own f32 forward on the same weights and frames under the serve
    gate."""
    from dfvod_tpu_torch.ops import corner_gather, fused_bottleneck, msda
    x, s = req
    backbone = server.model.backbone
    backbone.fused_stages = True
    results = {}
    try:
        for impl in (None, *msda.IMPLS):
            if impl is None:
                os.environ.pop("DFVOD_MSDA_IMPL", None)
            else:
                os.environ["DFVOD_MSDA_IMPL"] = impl
            server(x, s)
            torch.cuda.synchronize()
            times = []

            def run():
                for _ in range(requests):
                    t0 = time.perf_counter()
                    server(x, s)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            paths = {}
            inner, paths["fused_bottleneck"] = path_counts(
                fused_bottleneck, lambda: path_counts(
                    corner_gather, lambda: counted(run)))
            (_, counts), paths["corner_gather_fwd"] = inner
            gather = impl in msda.GATHER_IMPLS
            want = want_launches(
                msda_fwd=0 if gather else 13 * requests,
                corner_gather_fwd=13 * requests if gather else 0,
                fused_bottleneck=3 * requests)
            with torch.no_grad():
                out16 = server.forward(x, s)
            diff = (out16["pred_boxes"].float() - out32["pred_boxes"]).abs()
            ms = 1e3 * sum(times) / len(times)
            name = impl or "unset"
            ok = (counts == want and float(diff.max()) <= BOX_MAX_TOL
                  and float(diff.mean()) <= BOX_MEAN_TOL
                  and paths["fused_bottleneck"] == {
                      "layer1": 3 * requests, "generic": 0})
            print(f"[serve-var] fused_stages DFVOD_MSDA_IMPL={name:13s} "
                  f"launches per request: msda_fwd "
                  f"{counts['msda_fwd'] / requests:g}, corner_gather_fwd "
                  f"{counts['corner_gather_fwd'] / requests:g}, "
                  f"fused_bottleneck {counts['fused_bottleneck'] / requests:g}"
                  f" (paths over {requests}: {paths});"
                  f" ms per batch of {BATCH} {ms:.3f} "
                  f"({', '.join(f'{1e3 * t:.3f}' for t in times)}); bf16 vs "
                  f"f32 boxes max {float(diff.max()):.3e} mean "
                  f"{float(diff.mean()):.3e} {'ok' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"serve with fused_stages under DFVOD_MSDA_IMPL={name}"
                      f": launches {counts} (want {want}), K6 paths "
                      f"{paths['fused_bottleneck']}, boxes max "
                      f"{float(diff.max())} mean {float(diff.mean())}")
            results[name] = {"ms_per_batch": ms, "launches": counts,
                             "paths": paths,
                             "box_max": float(diff.max()),
                             "box_mean": float(diff.mean())}
    finally:
        os.environ.pop("DFVOD_MSDA_IMPL", None)
        backbone.fused_stages = False
    results["requests"] = requests
    return results


def small_cfg(fusion="LateFusion", layers=2, **kw):
    """A small model of ``fusion``: hidden 64, 4 heads, ``layers`` encoder
    and decoder layers, 12 queries."""
    from dfvod_tpu_torch.utils.config import Config, ModelConfig
    return Config(model=ModelConfig(
        fusion_type=fusion, num_queries=12, hidden_dim=64, nheads=4,
        enc_layers=layers, dec_layers=layers, dim_feedforward=128, **kw))


def small_msda_layers(fusion, layers=2):
    """MSDA layers per forward of ``small_cfg(fusion, layers)``."""
    extra = {"LateFusion": 1, "Encoder_CrossFusion": min(layers, 4),
             "Backbone_CrossFusion": 3}[fusion]
    return 2 * layers + extra


def phase_small_cpu_reference(fusion="LateFusion"):
    """A small model on the card (CUDA kernel) against the same model on
    the CPU (plain MSDA), f32, padded inputs: atol 1e-4 / rtol 1e-3 (TF32
    off; only summation order differs); K1 once per MSDA layer."""
    from dfvod_tpu_torch.data.device_pipeline import device_normalize
    from dfvod_tpu_torch.models import build_model
    cfg = small_cfg(fusion)
    cpu_model, _, _ = build_model(cfg, device="cpu", seed=3)
    randomize(cpu_model, seed=4)
    gpu_model, _, _ = build_model(cfg, device="cuda", seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    x, s = frames(5, B=2)
    x, s = x[:, :96, :128].contiguous(), torch.tensor([[96, 128], [60, 84]])
    with torch.no_grad():
        ref = cpu_model(*device_normalize(x, s))
        got, launches = counted(lambda: gpu_model(*device_normalize(
            x.cuda(), s.cuda())))
    want = want_launches(msda_fwd=small_msda_layers(fusion))
    check(launches == want, f"small {fusion} forward on the card launched "
                            f"{launches}, not {want}")
    for k in ("pred_logits", "pred_boxes"):
        err = (got[k].cpu() - ref[k]).abs()
        ok = bool((err <= 1e-4 + 1e-3 * ref[k].abs()).all())
        print(f"[small] {fusion} card vs cpu {k}: max_abs_err "
              f"{float(err.max()):.3e} {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"small {fusion} model on the card disagrees with the CPU "
                  f"on {k}")


# ------------------------------------------------------ clip serving path
CLIPS, CLIP_FRAMES = 2, 5          # TransVOD++_withdepth.sh: 4 ref frames


def clip_frames(seed, n_clips=CLIPS, F=CLIP_FRAMES, h=H, w=W):
    """uint8 RGB-D frames of ``n_clips`` contiguous clips of F frames,
    [key, ref_1, ...] each, with their content sizes: a reference frame of
    the first clip and the key frame of the second are padded
    bottom/right."""
    gen = torch.Generator().manual_seed(seed)
    n = n_clips * F
    imgs = torch.randint(0, 256, (n, h, w, 4), generator=gen,
                         dtype=torch.uint8)
    sizes = torch.tensor([[h, w]] * n)
    sizes[2] = torch.tensor([h * 3 // 4, w])
    if n_clips > 1:
        sizes[F] = torch.tensor([h - 8, w * 15 // 16])
    for i, (hh, ww) in enumerate(sizes.tolist()):
        imgs[i, hh:] = 0
        imgs[i, :, ww:] = 0
    return imgs, sizes


def phase_clip_serve(requests=5):
    """The TransVOD++ LateFusion recipe at full width, 2 clips x 5 frames
    at 608x800 in bf16: one warm-up, then ``requests`` timed requests."""
    from dfvod_tpu_torch.data.device_pipeline import device_normalize
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.ops import hat_sample, msda
    from dfvod_tpu_torch.serve import Server
    from dfvod_tpu_torch.utils.config import Config, ModelConfig

    cfg = Config(model=ModelConfig(fusion_type="LateFusion",
                                   temporal_mode="transvod_pp",
                                   num_ref_frames=CLIP_FRAMES - 1))
    m = cfg.model
    print(f"[clip] TransVOD++ LateFusion hidden={m.hidden_dim} heads="
          f"{m.nheads} enc={m.enc_layers} dec={m.dec_layers} queries="
          f"{m.num_queries} dc5={m.dilation} refine={m.with_box_refine} "
          f"ref_frames={m.num_ref_frames} temporal_dec="
          f"{m.n_temporal_decoder_layers}; {CLIPS} clips x {CLIP_FRAMES} "
          f"frames {H}x{W} bf16", flush=True)
    t0 = time.perf_counter()
    ref_model, _, _ = build_model(cfg, device="cpu", seed=0)
    randomize(ref_model, seed=1)
    ref_model = ref_model.to("cuda")
    server = Server(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    server.model.load_state_dict(ref_model.state_dict())
    print(f"[clip] built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in server.model.parameters())} params",
          flush=True)
    reqs = [tuple(t.to("cuda") for t in clip_frames(seed))
            for seed in range(requests + 1)]
    t0 = time.perf_counter()
    server(*reqs[0])                                # warm-up
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()

    msda.ms_deform_attn.launches = 0
    hat_sample.hat_sample.launches = 0
    times, dets = [], []
    for x, s in reqs[1:]:
        t0 = time.perf_counter()
        dets.append(server(x, s))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    k1, k3 = msda.ms_deform_attn.launches, hat_sample.hat_sample.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[clip] launches over {requests} requests: msda_fwd {k1}, "
          f"hat_sample_fwd {k3} ({k1 / requests:g} and {k3 / requests:g} "
          f"per request)", flush=True)
    check(k1 == 16 * requests and k3 == requests,
          f"expected 16 msda_fwd and 1 hat_sample_fwd launches per request, "
          f"got {k1} and {k3} over {requests}")
    for d in dets:
        check(d["scores"].shape == (CLIPS, 100)
              and d["boxes"].shape == (CLIPS, 100, 4),
              f"clip detections of shape {tuple(d['boxes'].shape)}")
        check(bool(torch.isfinite(d["scores"]).all()
                   and torch.isfinite(d["boxes"].float()).all()),
              "non-finite clip detections")
    ms = 1e3 * sum(times) / len(times)
    n = CLIPS * CLIP_FRAMES
    print(f"[clip] ms per request of {CLIPS} clips x {CLIP_FRAMES} frames: "
          f"mean {ms:.3f} (first request {first_ms:.1f}; per request "
          f"{', '.join(f'{1e3 * t:.3f}' for t in times)}) -> "
          f"{n / (ms / 1e3):.1f} frames/s, {CLIPS / (ms / 1e3):.2f} clips/s;"
          f" peak memory {peak:.2f} GiB", flush=True)

    # outputs: finite, boxes in [0, 1]; the key frames' single-frame
    # outputs against the port's own f32 forward (same weights and input)
    x, s = reqs[1]
    with torch.no_grad():
        out16 = server.forward(x, s)
        out32 = ref_model(*device_normalize(x, s))
    heads = [("final", out16, out32)] + [
        (f"aux{i}", a, b) for i, (a, b) in
        enumerate(zip(out16["aux_outputs"], out32["aux_outputs"]))]
    for tag, o16, _ in heads + [("single_frame", out16["_single_frame"],
                                 None)]:
        boxes = o16["pred_boxes"].float()
        check(bool(torch.isfinite(o16["pred_logits"].float()).all()
                   and torch.isfinite(boxes).all()
                   and (boxes >= 0).all() and (boxes <= 1).all()),
              f"clip {tag} outputs not finite or boxes outside [0, 1]")
    diff = (out16["_single_frame"]["pred_boxes"].float()
            - out32["_single_frame"]["pred_boxes"]).abs()
    print(f"[clip] key frames' single-frame boxes, bf16 vs f32: max "
          f"{float(diff.max()):.3e} mean {float(diff.mean()):.3e} "
          f"(tolerance max {BOX_MAX_TOL}, mean {BOX_MEAN_TOL})", flush=True)
    check(float(diff.max()) <= BOX_MAX_TOL
          and float(diff.mean()) <= BOX_MEAN_TOL,
          "bf16 clip serve's key-frame trunk disagrees with the f32 forward")
    drift = {}
    for tag, o16, o32 in heads:
        for k in ("pred_logits", "pred_boxes"):
            e = (o16[k].float() - o32[k]).abs()
            drift[f"{tag}_{k}"] = (float(e.max()), float(e.mean()))
    print("[clip] temporal outputs, bf16 vs f32 (not gated: top-k may "
          "select other reference queries in bf16): " + ", ".join(
              f"{k} max {a:.3e} mean {b:.3e}" for k, (a, b) in drift.items()),
          flush=True)
    return {"ms_per_request": ms, "frames_per_s": n / (ms / 1e3),
            "clips_per_s": CLIPS / (ms / 1e3), "first_request_ms": first_ms,
            "peak_memory_gib": peak, "launches_msda_fwd": k1,
            "launches_hat_sample_fwd": k3, "requests": requests}


def phase_small_temporal_reference():
    """Small f32 TransVOD++ and TransVOD+TDAM (5 reference frames, so K1
    takes 5 levels) models on the card against the same weights on the
    CPU, padded clips: atol 1e-4 / rtol 1e-3, TF32 off."""
    from dfvod_tpu_torch.data.device_pipeline import device_normalize
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.ops import hat_sample, msda
    from dfvod_tpu_torch.utils.config import Config, ModelConfig
    small = dict(fusion_type="LateFusion", num_queries=100, hidden_dim=64,
                 nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=128)
    variants = (("transvod_pp", dict(temporal_mode="transvod_pp",
                                     num_ref_frames=2), 8, 1),
                ("transvod_tdam", dict(temporal_mode="transvod",
                                       use_tdam=True, num_ref_frames=5), 7,
                 0))
    for name, kw, k1_want, k3_want in variants:
        cfg = Config(model=ModelConfig(**small, **kw))
        cpu_model, _, _ = build_model(cfg, device="cpu", seed=3)
        randomize(cpu_model, seed=4)
        gpu_model, _, _ = build_model(cfg, device="cuda", seed=3)
        gpu_model.load_state_dict(cpu_model.state_dict())
        x, s = clip_frames(7, n_clips=2, F=1 + kw["num_ref_frames"], h=96,
                           w=128)
        msda.ms_deform_attn.launches = hat_sample.hat_sample.launches = 0
        with torch.no_grad():
            ref = cpu_model(*device_normalize(x, s))
            got = gpu_model(*device_normalize(x.cuda(), s.cuda()))
        k1, k3 = msda.ms_deform_attn.launches, hat_sample.hat_sample.launches
        check(k1 == k1_want and k3 == k3_want,
              f"small {name} on the card launched msda_fwd {k1} and "
              f"hat_sample_fwd {k3} times, not {k1_want} and {k3_want}")
        pairs = [("final", got, ref),
                 ("single_frame", got["_single_frame"],
                  ref["_single_frame"])]
        pairs += [(f"aux{i}", a, b) for i, (a, b) in
                  enumerate(zip(got.get("aux_outputs", []),
                                ref.get("aux_outputs", [])))]
        worst = 0.0
        for tag, g, r in pairs:
            for k in ("pred_logits", "pred_boxes"):
                err = (g[k].cpu() - r[k]).abs()
                worst = max(worst, float(err.max()))
                check(bool((err <= 1e-4 + 1e-3 * r[k].abs()).all()),
                      f"small {name} on the card disagrees with the CPU on "
                      f"{tag} {k}: max_abs_err {float(err.max()):.3e}")
        print(f"[small-clip] {name} card vs cpu, {len(pairs)} heads: "
              f"max_abs_err {worst:.3e} (atol 1e-4 rtol 1e-3) ok; launches "
              f"msda_fwd {k1} hat_sample_fwd {k3}", flush=True)


# ------------------------------------------------------------ training path
def train_batch(seed, B=TRAIN_BATCH, max_boxes=64):
    """The batch dict of ``cli/main.py::to_batch`` on the host: uint8 RGB-D
    frames (two padded, as ``frames`` makes them) with their sizes, and
    targets padded to ``max_boxes`` with 1..8 valid boxes per image."""
    imgs, sizes = frames(seed, B)
    return {"images": imgs, "sizes": sizes,
            **random_targets(seed, B, max_boxes)}


def clip_train_batch(seed, F=CLIP_TRAIN_FRAMES, h=H, w=W, max_boxes=64):
    """The ``to_batch`` dict of one clip of F frames (a reference frame
    padded, as ``clip_frames`` makes it), with targets on every frame row;
    the train step reads the key frame's."""
    imgs, sizes = clip_frames(seed, n_clips=1, F=F, h=h, w=w)
    return {"images": imgs, "sizes": sizes,
            **random_targets(seed, F, max_boxes)}


def random_targets(seed, B, max_boxes):
    """labels, boxes (normalized cxcywh), valid of B rows padded to
    ``max_boxes``, with 1..8 valid boxes per row."""
    gen = torch.Generator().manual_seed(1000 + seed)
    n_valid = torch.randint(1, 9, (B,), generator=gen)
    valid = torch.arange(max_boxes)[None] < n_valid[:, None]
    labels = torch.randint(0, 2, (B, max_boxes), generator=gen,
                           dtype=torch.int32) * valid
    cxcy = torch.rand((B, max_boxes, 2), generator=gen) * 0.6 + 0.2
    wh = torch.rand((B, max_boxes, 2), generator=gen) * 0.3 + 0.05
    boxes = torch.cat([cxcy, wh], -1) * valid[..., None]
    return {"labels": labels, "boxes": boxes, "valid": valid}


def batchnorms(model):
    """The model's trainable (DFormer) BatchNorms, wherever they live: the
    depth backbone, or Backbone_CrossFusion's fused backbone."""
    from dfvod_tpu_torch.models.backbone_dformer import BatchNorm
    return [mod for mod in model.modules() if isinstance(mod, BatchNorm)]


TRAIN_TAGS = {"LateFusion": "train", "Encoder_CrossFusion": "train-ecf",
              "Backbone_CrossFusion": "train-bcf"}


def phase_train(steps=5, fusion="LateFusion", train_dtype="bfloat16"):
    """The recipe of configs/training/LateFusion_bf16.sh (or, by
    ``fusion``, Encoder_CrossFusion.sh / Backbone_CrossFusion.sh) at full
    width: one warm-up step, then ``steps`` timed ones with every kernel
    count set to 0 just before and read just after. Every trainable group
    and the DFormer BN statistics move; a frozen ResNet-50 (LateFusion,
    Encoder_CrossFusion) stays bitwise unchanged, Backbone_CrossFusion's
    trains."""
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.train import create_train_state, train_step

    tag = TRAIN_TAGS[fusion]
    cfg = train_cfg(fusion, train_dtype)
    m = cfg.model
    print(f"[{tag}] {fusion} hidden={m.hidden_dim} heads={m.nheads} "
          f"enc={m.enc_layers} dec={m.dec_layers} queries={m.num_queries} "
          f"dropout={m.dropout} lr={cfg.train.lr} clip="
          f"{cfg.train.clip_max_norm} B={TRAIN_BATCH} {H}x{W} "
          f"{cfg.train.train_dtype}"
          f"{' autocast' if train_dtype == 'bfloat16' else ''}", flush=True)
    model, criterion, _ = build_model(cfg, device="cpu", seed=0)
    model = randomize(model, seed=1).to("cuda")
    state = create_train_state(model, cfg, steps_per_epoch=1000)
    groups = [g["label"] for g in state.optimizer.param_groups]
    for g in state.optimizer.param_groups:
        print(f"[{tag}] group {g['label']}: "
              f"{sum(p.numel() for p in g['params'])} params, lr "
              f"{g['lr']:g}", flush=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    bns = batchnorms(model)
    bn_before = [(b.running_mean.clone(), b.running_var.clone())
                 for b in bns]
    batches = [{k: v.to("cuda") for k, v in train_batch(seed).items()}
               for seed in range(steps + 1)]
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    metrics = [train_step(state, criterion, batches[0])]
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    n = MSDA_LAYERS[fusion]
    want = want_launches(msda_fwd=n, msda_bwd=n)
    times = []
    fwd = bwd = 0
    for i, batch in enumerate(batches[1:]):
        t0 = time.perf_counter()
        mt, launches = counted(lambda: train_step(state, criterion, batch))
        times.append(time.perf_counter() - t0)
        metrics.append(mt)
        check(launches == want,
              f"{tag} step {i + 1} launched {launches}, not {want}")
        fwd += launches["msda_fwd"]
        bwd += launches["msda_bwd"]
    print(f"[{tag}] launches over {steps} steps: msda_fwd {fwd}, msda_bwd "
          f"{bwd} ({n} and {n} per step; counts set to 0 before each "
          f"step, read after)", flush=True)
    for i, mt in enumerate(metrics):
        loss, gn = float(mt["loss"]), float(mt["grad_norm"])
        print(f"[{tag}] step {i}: loss {loss:.4f} grad_norm {gn:.4f} "
              f"loss_ce {float(mt['loss_ce']):.4f} loss_bbox "
              f"{float(mt['loss_bbox']):.4f} loss_giou "
              f"{float(mt['loss_giou']):.4f}", flush=True)
        check(math.isfinite(loss) and math.isfinite(gn),
              f"non-finite loss or grad_norm at step {i}")

    changed = {n: not torch.equal(p.detach(), before[n])
               for n, p in model.named_parameters()}
    frozen = [n for n, lab in state.labels.items() if lab == "frozen"]
    resnet = [n for n in changed if n.startswith(("backbone.conv1",
                                                  "backbone.layer"))]
    if fusion == "Backbone_CrossFusion":
        check(not frozen, f"frozen parameters {frozen[:4]}")
        for part in ("conv1", *(f"layer{i}" for i in range(1, 5)),
                     *(f"d2r_fusion{i}" for i in (2, 3, 4))):
            names = [n for n in changed
                     if n.startswith(f"backbone.{part}.")]
            check(names and any(changed[n] for n in names),
                  f"backbone.{part} did not train")
        trunk = (f"ResNet-50 trains: {sum(changed[n] for n in resnet)} of "
                 f"{len(resnet)} tensors changed")
    else:
        check(frozen and all(n.startswith("backbone.") for n in frozen)
              and not any(changed[n] for n in frozen),
              "a frozen ResNet-50 parameter changed")
        check(all(n in frozen for n, _ in model.backbone.named_parameters(
            prefix="backbone")), "a ResNet-50 parameter is not frozen")
        if fusion == "Encoder_CrossFusion":
            for i in range(4):
                names = [n for n in changed if n.startswith(
                    f"transformer.fusion_layers_{i}.")]
                check(names and any(changed[n] for n in names),
                      f"fusion_layers_{i} did not train")
        trunk = f"ResNet-50: {len(frozen)} tensors bitwise unchanged"
    for label in groups:
        names = [n for n, lab in state.labels.items() if lab == label]
        n_changed = sum(changed[n] for n in names)
        print(f"[{tag}] group {label}: {n_changed} of {len(names)} "
              f"tensors changed", flush=True)
        check(n_changed > 0, f"no parameter of group {label} changed")
    bn_moved = sum(not (torch.equal(b.running_mean, m0)
                        and torch.equal(b.running_var, v0))
                   for b, (m0, v0) in zip(bns, bn_before))
    print(f"[{tag}] {trunk}; DFormer BN running statistics changed in "
          f"{bn_moved} of {len(bns)} layers", flush=True)
    check(len(bns) == 4 and bn_moved == len(bns),
          "DFormer BN running statistics unchanged")
    ms = 1e3 * sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[{tag}] ms per step of {TRAIN_BATCH}: mean {ms:.3f} (first step "
          f"{first_ms:.1f}; per step "
          f"{', '.join(f'{1e3 * t:.3f}' for t in times)}) -> "
          f"{TRAIN_BATCH / (ms / 1e3):.1f} frames/s; peak memory "
          f"{peak:.2f} GiB", flush=True)
    return {"ms_per_step": ms, "frames_per_s": TRAIN_BATCH / (ms / 1e3),
            "first_step_ms": first_ms, "steps_ms": [1e3 * t for t in times],
            "peak_memory_gib": peak, "launches_fwd": fwd,
            "launches_bwd": bwd, "steps": steps}


KERNELS = ("msda_fwd", "hat_sample_fwd", "msda_bwd", "hat_sample_bwd",
           "corner_gather_fwd", "hat_sample_sparse", "fused_bottleneck")


def kernel_counters():
    """{kernel: the wrapper whose ``launches`` counts its launches}."""
    from dfvod_tpu_torch.ops import (corner_gather, fused_bottleneck,
                                     hat_sample, msda)
    return dict(zip(KERNELS, (
        msda.ms_deform_attn, hat_sample.hat_sample, msda.ms_deform_attn_bwd,
        hat_sample.hat_sample_bwd, corner_gather.corner_gather,
        hat_sample.hat_sample_sparse,
        fused_bottleneck.fused_bottleneck_stage)))


def want_launches(**nonzero):
    """Expected launch counts: 0 for every kernel but those named."""
    return {k: nonzero.get(k, 0) for k in KERNELS}


def counted(fn):
    """(fn(), {kernel: launches}): every kernel's count set to 0 just before
    ``fn`` and read just after."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def step_on_cpu_and_card(cfg, batch):
    """One train-step loss and backward of a small model (seeded weights,
    ``randomize``d) on the CPU and, with the same weights, batch and
    generator seed, on the card: ((parts, grads) on the CPU, (parts, grads)
    on the card, the card's launches)."""
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.train.engine import create_train_state, forward
    cpu_model, criterion, _ = build_model(cfg, device="cpu", seed=3)
    randomize(cpu_model, seed=4)
    gpu_model, _, _ = build_model(cfg, device="cuda", seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    results = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        state = create_train_state(model, cfg)

        def step():
            loss, parts = criterion(*forward(
                state, {k: v.to(dev) for k, v in batch.items()}))
            loss.backward()
            return {k: v.detach() for k, v in {"loss": loss, **parts}.items()}
        parts, launches = counted(step)
        results.append((parts, {n: p.grad for n, p in model.named_parameters()
                                if p.grad is not None}))
    return results[0], results[1], launches


def check_parts(ref_parts, parts, tag):
    """Loss and components, card against CPU: atol 1e-5 rtol 1e-4. Returns
    the largest error."""
    worst = 0.0
    for k, r in ref_parts.items():
        err = abs(float(parts[k]) - float(r))
        worst = max(worst, err)
        check(err <= 1e-5 + 1e-4 * abs(float(r)),
              f"{tag}: card {k} {float(parts[k])} vs cpu {float(r)}")
    return worst


def phase_small_train_reference(impl=None, fusion="LateFusion"):
    """One train-step loss and every gradient, a small model on the card
    (CUDA kernels) against the same model on the CPU (plain MSDA): f32, TF32
    off, the same weights, batch and generator seed, dropout 0. Loss and
    components atol 1e-5 / rtol 1e-4, gradients atol 1e-4 / rtol 1e-3:
    summation order and the backward's atomics are the only differences.
    With ``impl`` (a ``DFVOD_MSDA_IMPL`` of the gather forms) the model has
    6+6 layers, so all 13 MSDA layers take K5b/c forward and K2 backward
    on the card, the flat form's plain version and autograd on the CPU.
    ``fusion`` picks the model's fusion mode (2+2 layers); with
    Backbone_CrossFusion the backbone trains, and its gradients are held
    in relative L2 norm within 1e-2 (``grads_close``, the video step's
    gate: ResNet-50 gradients differ by up to 5e-4 entry by entry, 9e-4 in
    relative L2, on an H100)."""
    layers = 6 if impl else 2
    cfg = small_cfg(fusion, layers, dropout=0.0)
    n_msda = small_msda_layers(fusion, layers)
    want = (want_launches(corner_gather_fwd=n_msda, msda_bwd=n_msda) if impl
            else want_launches(msda_fwd=n_msda, msda_bwd=n_msda))
    batch = train_batch(5, B=2, max_boxes=8)
    batch["images"] = batch["images"][:, :96, :128].contiguous()
    batch["sizes"] = torch.tensor([[96, 128], [60, 84]])
    if impl:
        os.environ["DFVOD_MSDA_IMPL"] = impl
    try:
        (ref_parts, ref_grads), (parts, grads), launches = (
            step_on_cpu_and_card(cfg, batch))
    finally:
        os.environ.pop("DFVOD_MSDA_IMPL", None)
    tag = f"small train step under DFVOD_MSDA_IMPL={impl}" if impl else (
        f"small {fusion} train step")
    check(launches == want, f"the {tag} on the card launched {launches}, "
                            f"not {want}")
    worst = check_parts(ref_parts, parts, tag)
    check(grads.keys() == ref_grads.keys(), f"{tag}: gradients on different "
                                            f"sets")
    check(sum(n.endswith("value_proj.weight") for n in grads) == n_msda,
          f"{tag}: not every MSDA layer's value_proj has a gradient")
    # Backbone_CrossFusion trains its whole backbone: there, as in the
    # video step, the ResNet's ReLUs make the gradients ill-conditioned,
    # and its tensors are held in relative L2 norm (``grads_close``)
    trunk = fusion == "Backbone_CrossFusion"
    gworst, rworst, n_trunk, bad = 0.0, 0.0, 0, []
    for n, r in ref_grads.items():
        g = grads[n].cpu()
        if trunk and n.startswith("backbone."):
            ok, rel = grads_close(g, r)
            n_trunk += 1
            rworst = max(rworst, rel if float(r.abs().max()) >= 1e-4 else 0)
            if not ok:
                bad.append(f"{n} (relative L2 {rel:.3e})")
            continue
        err = (g - r).abs()
        gworst = max(gworst, float(err.max()))
        if not bool((err <= 1e-4 + 1e-3 * r.abs()).all()):
            bad.append(f"{n} (max {float(err.max()):.3e})")
    check(not bad, f"{tag}: {len(bad)} gradients differ: {bad[:6]}")
    norm_line = (f"; {n_trunk} backbone gradients in relative L2, worst "
                 f"{rworst:.3e} (1e-2)" if trunk else "")
    print(f"[small-train] {'impl=' + impl if impl else fusion} card vs "
          f"cpu: loss {float(parts['loss']):.6f} vs "
          f"{float(ref_parts['loss']):.6f}, max component err {worst:.3e} "
          f"(atol 1e-5 rtol 1e-4); {len(grads) - n_trunk} gradients, max "
          f"abs err {gworst:.3e} (atol 1e-4 rtol 1e-3){norm_line}; "
          f"launches { {k: v for k, v in launches.items() if v} } ok",
          flush=True)
    return launches


# ------------------------------------------------------ video training path
# launches per TransVOD++ step: 13 trunk + 3 temporal decoder layers (K1,
# K2), the QRF RoIAlign (K3, K4); with fixed_pretrained_model the trunk
# gets no gradient, so K2 runs for the temporal decoders only and K4 not
VIDEO_LAUNCHES = want_launches(msda_fwd=16, hat_sample_fwd=1, msda_bwd=16,
                               hat_sample_bwd=1)
FIXED_LAUNCHES = dict(VIDEO_LAUNCHES, msda_bwd=3, hat_sample_bwd=0)


def video_train_cfg(**kw):
    """configs/training/TransVOD++_withdepth.sh (f32: the recipe sets no
    train_dtype)."""
    from dfvod_tpu_torch.utils.config import Config
    return Config.from_flat(**{
        "fusion_type": "LateFusion", "temporal_mode": "transvod_pp",
        "num_ref_frames": CLIP_TRAIN_FRAMES - 1, "num_classes": 3,
        "num_queries": 300, "num_feature_levels": 1, "dilation": True,
        "with_box_refine": True, "dropout": 0.2, "lr": 1e-4,
        "weight_decay": 2e-5, "clip_max_norm": 0.1, "epochs": 7,
        "train_dtype": "float32", **kw})


def check_finite(metrics, tag):
    bad = [k for k, v in metrics.items() if not math.isfinite(float(v))]
    check(not bad, f"{tag}: non-finite {bad}")


def phase_train_clips(steps=5):
    """The TransVOD++ recipe at full width, 1 clip x 5 frames at 608x800 in
    f32: one warm-up step, then ``steps`` timed ones; then one step in the
    bf16 mix of configs/training/SynthHard_Temporal.sh and one with
    fixed_pretrained_model (that recipe's default)."""
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.train import create_train_state, train_step

    cfg = video_train_cfg()
    m = cfg.model
    print(f"[train_clips] TransVOD++ LateFusion hidden={m.hidden_dim} heads="
          f"{m.nheads} enc={m.enc_layers} dec={m.dec_layers} queries="
          f"{m.num_queries} ref_frames={m.num_ref_frames} dropout="
          f"{m.dropout} lr={cfg.train.lr} clip={cfg.train.clip_max_norm}; 1 "
          f"clip x {CLIP_TRAIN_FRAMES} frames {H}x{W} "
          f"{cfg.train.train_dtype}", flush=True)
    model, criterion, _ = build_model(cfg, device="cpu", seed=0)
    model = randomize(model, seed=1).to("cuda")
    state = create_train_state(model, cfg, steps_per_epoch=1000)
    for g in state.optimizer.param_groups:
        print(f"[train_clips] group {g['label']}: "
              f"{sum(p.numel() for p in g['params'])} params, lr "
              f"{g['lr']:g}", flush=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    bns = batchnorms(model)
    bn_before = [(b.running_mean.clone(), b.running_var.clone())
                 for b in bns]
    batches = [{k: v.to("cuda") for k, v in clip_train_batch(seed).items()}
               for seed in range(steps + 1)]
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    metrics = [train_step(state, criterion, batches[0])]
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    times, totals = [], dict.fromkeys(VIDEO_LAUNCHES, 0)
    for i, batch in enumerate(batches[1:]):
        t0 = time.perf_counter()
        mt, launches = counted(lambda: train_step(state, criterion, batch))
        times.append(time.perf_counter() - t0)
        metrics.append(mt)
        check(launches == VIDEO_LAUNCHES,
              f"step {i + 1} launched {launches}, not {VIDEO_LAUNCHES}")
        totals = {k: totals[k] + launches[k] for k in totals}
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train_clips] launches over {steps} steps: {totals} (counts set "
          f"to 0 before each step, read after)", flush=True)
    for i, mt in enumerate(metrics):
        check_finite(mt, f"train_clips step {i}")
        print(f"[train_clips] step {i}: loss {float(mt['loss']):.4f} "
              f"grad_norm {float(mt['grad_norm']):.4f} loss_ce "
              f"{float(mt['loss_ce']):.4f} loss_ce_0 "
              f"{float(mt['loss_ce_0']):.4f} loss_ce_1 "
              f"{float(mt['loss_ce_1']):.4f} loss_bbox "
              f"{float(mt['loss_bbox']):.4f}", flush=True)

    changed = {n: not torch.equal(p.detach(), before[n])
               for n, p in model.named_parameters()}
    check(set(state.labels.values()) == {"base", "linear_proj"},
          f"temporal label groups {set(state.labels.values())}")
    for label in ("base", "linear_proj"):
        names = [n for n, lab in state.labels.items() if lab == label]
        n_changed = sum(changed[n] for n in names)
        print(f"[train_clips] group {label}: {n_changed} of {len(names)} "
              f"tensors changed", flush=True)
        check(n_changed > 0, f"no parameter of group {label} changed")
    resnet = [n for n in changed if n.startswith("detr.backbone.")]
    print(f"[train_clips] ResNet-50 (trains here): "
          f"{sum(changed[n] for n in resnet)} of {len(resnet)} tensors "
          f"changed", flush=True)
    check(any(changed[n] for n in resnet), "the ResNet-50 did not train")
    bn_moved = sum(not (torch.equal(b.running_mean, m0)
                        and torch.equal(b.running_var, v0))
                   for b, (m0, v0) in zip(bns, bn_before))
    print(f"[train_clips] DFormer BN running statistics changed in "
          f"{bn_moved} of {len(bns)} layers", flush=True)
    check(bn_moved == len(bns), "DFormer BN running statistics unchanged")
    ms = 1e3 * sum(times) / len(times)
    result = {"ms_per_step": ms, "clips_per_s": 1e3 / ms,
              "frames_per_s": CLIP_TRAIN_FRAMES * 1e3 / ms,
              "first_step_ms": first_ms, "steps_ms": [1e3 * t for t in times],
              "peak_memory_gib": peak, "launches": totals, "steps": steps}
    print(f"[train_clips] ms per step of 1 clip x {CLIP_TRAIN_FRAMES} frames:"
          f" mean {ms:.3f} (first step {first_ms:.1f}; per step "
          f"{', '.join(f'{1e3 * t:.3f}' for t in times)}) -> "
          f"{result['clips_per_s']:.2f} clips/s, "
          f"{result['frames_per_s']:.1f} frames/s; peak memory "
          f"{peak:.2f} GiB", flush=True)

    # one step in the bf16 mix, on a fresh optimizer
    del state
    cfg16 = video_train_cfg(train_dtype="bfloat16")
    state = create_train_state(model, cfg16, steps_per_epoch=1000)
    t0 = time.perf_counter()
    mt, launches = counted(lambda: train_step(state, criterion, batches[1]))
    result["bf16_step_ms"] = 1e3 * (time.perf_counter() - t0)
    check_finite(mt, "train_clips bf16 step")
    check(launches == VIDEO_LAUNCHES,
          f"the bf16 step launched {launches}, not {VIDEO_LAUNCHES}")
    print(f"[train_clips] bf16 autocast step: loss {float(mt['loss']):.4f}, "
          f"{result['bf16_step_ms']:.1f} ms (its first), launches {launches}"
          f" ok", flush=True)

    # one step with fixed_pretrained_model: the trunk frozen
    del state
    cfg_fixed = video_train_cfg(fixed_pretrained_model=True)
    fixed, criterion, _ = build_model(cfg_fixed, device="cuda", seed=0)
    fixed.load_state_dict(model.state_dict())
    del model
    state = create_train_state(fixed, cfg_fixed, steps_per_epoch=1000)
    trunk = {n: p.detach().clone() for n, p in fixed.named_parameters()
             if n.startswith("detr.")}
    check(all(state.labels[n] == "frozen" for n in trunk)
          and not any(lab == "frozen" for n, lab in state.labels.items()
                      if n not in trunk), "fixed_pretrained_model labels")
    head = {n: p.detach().clone() for n, p in fixed.named_parameters()
            if n not in trunk}
    mt, launches = counted(lambda: train_step(state, criterion, batches[1]))
    check_finite(mt, "train_clips fixed_pretrained_model step")
    check(launches == FIXED_LAUNCHES,
          f"the fixed_pretrained_model step launched {launches}, not "
          f"{FIXED_LAUNCHES}")
    params = dict(fixed.named_parameters())
    check(all(torch.equal(params[n], p) for n, p in trunk.items()),
          "a frozen trunk parameter changed")
    n_head = sum(not torch.equal(params[n], p) for n, p in head.items())
    check(n_head > 0, "no temporal-head parameter changed")
    print(f"[train_clips] fixed_pretrained_model step: loss "
          f"{float(mt['loss']):.4f}, {len(trunk)} trunk tensors bitwise "
          f"unchanged, {n_head} of {len(head)} temporal-head tensors changed,"
          f" launches {launches} ok", flush=True)
    return result


def grads_close(got, ref):
    """(ok, relative L2 error) of a gradient on the card against the
    CPU's: within 1e-2 in relative L2 norm, or atol 1e-4 where the CPU's
    is structurally zero (largest entry below 1e-4)."""
    rel = float((got - ref).norm() / ref.norm().clamp_min(1e-30))
    tiny = float(ref.abs().max()) < 1e-4
    return rel <= 1e-2 or (tiny and float((got - ref).abs().max()) <= 1e-4), rel


def phase_small_video_train_reference():
    """One train-step loss and every gradient of small f32 TransVOD++ (one
    padded clip) and TransVOD+TDAM (5 reference frames) models on the card
    against the same weights, batch and dropout 0 on the CPU, TF32 off.
    Loss and components atol 1e-5 / rtol 1e-4. Gradients per tensor in
    relative L2 norm within 1e-2 (structurally zero ones atol 1e-4;
    measured worst 3.1e-3 TransVOD++, 4.9e-3 TransVOD+TDAM on an H100):
    the trunk trains, and at these weights its ReLUs and the QRF head's
    make the gradients ill-conditioned, so summation order alone moves them
    beyond the single-frame step's elementwise tolerance
    (``tests/test_torch_temporal_train.py``)."""
    from dfvod_tpu_torch.utils.config import Config, ModelConfig
    small = dict(fusion_type="LateFusion", num_queries=100, hidden_dim=64,
                 nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=128,
                 dropout=0.0)
    variants = (("transvod_pp", dict(temporal_mode="transvod_pp",
                                     num_ref_frames=2),
                 want_launches(msda_fwd=8, hat_sample_fwd=1, msda_bwd=8,
                               hat_sample_bwd=1)),
                ("transvod_tdam", dict(temporal_mode="transvod",
                                       use_tdam=True, num_ref_frames=5),
                 want_launches(msda_fwd=7, msda_bwd=7)))
    for name, kw, want in variants:
        batch = clip_train_batch(7, F=1 + kw["num_ref_frames"], h=96, w=128,
                                 max_boxes=8)
        (ref_parts, ref_grads), (parts, grads), launches = (
            step_on_cpu_and_card(Config(model=ModelConfig(**small, **kw)),
                                 batch))
        check(launches == want, f"small {name} train step on the card "
                                f"launched {launches}, not {want}")
        worst = check_parts(ref_parts, parts, f"small {name} train step")
        check(grads.keys() == ref_grads.keys(),
              f"small {name}: gradients on different sets")
        gworst = 0.0
        for n, r in ref_grads.items():
            ok, rel = grads_close(grads[n].cpu(), r)
            gworst = max(gworst, rel if float(r.abs().max()) >= 1e-4 else 0)
            check(ok, f"small {name} train step: gradient of {n} differs, "
                      f"relative L2 {rel:.3e}")
        print(f"[small-train-clips] {name} card vs cpu: loss "
              f"{float(parts['loss']):.6f} vs {float(ref_parts['loss']):.6f},"
              f" max component err {worst:.3e} (atol 1e-5 rtol 1e-4); "
              f"{len(grads)} gradients, worst relative L2 {gworst:.3e} "
              f"(1e-2); launches {launches} ok", flush=True)


# ------------------------------------------------- the other fusion modes
FUSION_MODES = ("Encoder_CrossFusion", "Backbone_CrossFusion")


def free_card():
    """Give the memory of the models just dropped back to the card."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def phase_bidirectional_backbone():
    """``CrossFusionBackbone(bidirectional=True)`` alone, small (d_model 64,
    4 heads, 96x128, one padded image) on the card against the same module
    on the CPU, f32, 6 K1 launches (d2r and r2d at each of 3 sites). Held
    within 1e-4 in relative L2 norm: the output of each site's
    cross-attention (the K1 result through its output projection, O(1)),
    the RGB stage-4 feature and the depth feature. The raw ResNet feature
    reaches 5.6e3 at these weights (FrozenBN at identity), so its norm is
    the trunk's and it would hide an error in the fused part: the
    per-site outputs are the witnesses of K1 here."""
    from dfvod_tpu_torch.models import init_parameters
    from dfvod_tpu_torch.models.backbone_crossfusion import (
        FUSION_STAGES,
        CrossFusionBackbone,
    )
    from dfvod_tpu_torch.data.device_pipeline import device_normalize
    cpu = CrossFusionBackbone(d_model=64, n_heads=4, dropout=0.0,
                              bidirectional=True)
    init_parameters(cpu, torch.Generator().manual_seed(3))
    randomize(cpu, seed=4).eval()
    gpu = CrossFusionBackbone(d_model=64, n_heads=4, dropout=0.0,
                              bidirectional=True).cuda().eval()
    gpu.load_state_dict(cpu.state_dict())
    x, s = frames(6, B=2)
    x, s = x[:, :96, :128].contiguous(), torch.tensor([[96, 128], [60, 84]])
    img, mask = device_normalize(x, s)
    sites = [f"{d}_fusion{st}" for st in FUSION_STAGES for d in ("d2r", "r2d")]
    seen = {}

    def keep(key, site):
        def hook(_mod, _args, out):
            seen[key, site] = out.detach().cpu()
        return hook
    hooks = [getattr(m, site).cross_attn.register_forward_hook(keep(k, site))
             for k, m in (("cpu", cpu), ("gpu", gpu)) for site in sites]
    with torch.no_grad():
        ref = cpu(img[..., :3], img[..., 3:], mask)
        got, launches = counted(lambda: gpu(img[..., :3].cuda(),
                                            img[..., 3:].cuda(), mask.cuda()))
    for h in hooks:
        h.remove()
    check(launches == want_launches(msda_fwd=6),
          f"the bidirectional backbone launched {launches}, not 6 msda_fwd")
    worst, line = 0.0, []
    for tag, g, r in (*((site, seen["gpu", site], seen["cpu", site])
                        for site in sites),
                      ("rgb", got[0][0], ref[0][0]),
                      ("depth", got[2], ref[2])):
        g = g.cpu()
        rel = relative_l2(g, r)
        worst = max(worst, rel)
        line.append(f"{tag} relative L2 {rel:.3e} (max abs err "
                    f"{float((g - r).abs().max()):.3e}, max |ref| "
                    f"{float(r.abs().max()):.3e})")
        check(rel <= 1e-4, f"bidirectional backbone {tag} feature: card vs "
                           f"cpu relative L2 {rel:.3e}")
    print(f"[small-bidir] CrossFusionBackbone(bidirectional) card vs cpu: "
          f"{'; '.join(line)} (1e-4); launches msda_fwd 6 ok", flush=True)
    return worst


def phase_fusion_modes(serve_requests=3, train_steps=3):
    """Encoder_CrossFusion and Backbone_CrossFusion, each: the full-width
    bf16 serve (one warm-up, ``serve_requests`` timed requests), a small
    model's forward and train step on the card against the CPU, then the
    recipe's full-width f32 train step (one warm-up, ``train_steps`` timed
    ones). Each full-width model is freed before the next is built. Then
    the bidirectional backbone alone."""
    results = {}
    for mode in FUSION_MODES:
        serve, server, ref_model, _, _ = phase_serve(
            serve_requests + 1, fusion=mode, warmup=1)
        del server, ref_model
        free_card()
        phase_small_cpu_reference(mode)
        phase_small_train_reference(fusion=mode)
        train = phase_train(train_steps, fusion=mode, train_dtype="float32")
        free_card()
        results[mode] = {"serve": serve, "train": train}
    results["bidirectional_relative_l2"] = phase_bidirectional_backbone()
    return results


# ------------------------- evaluation, checkpoints, reference weights, remat
VAL_JSON = os.path.join(REPO, "datasets", "synth_rgbd", "coco", "annotations",
                        "val.json")
# the eval resize of val.json's 256x320 images (short side 600), padded to
# the serve shape
EVAL_CONTENT = (600, 750)
EVAL_BATCH = 8
EVAL_CLIPS = 2


def eval_frame(coco, img_id, size, content):
    """A seeded uint8 RGB-D frame for ``img_id``, ``content`` (h, w) of it
    filled and the rest padded; its first pixel carries the image's index
    in ``coco.getImgIds()`` (low byte in channel 0, high byte in 1) for
    ``OracleDetector``."""
    gen = torch.Generator().manual_seed(int(img_id))
    img = torch.randint(0, 256, (*size, 4), generator=gen, dtype=torch.uint8)
    img[content[0]:] = 0
    img[:, content[1]:] = 0
    index = coco.getImgIds().index(img_id)
    img[0, 0, 0], img[0, 0, 1] = index % 256, index // 256
    return img


def eval_batches(coco, img_ids=None, batch=EVAL_BATCH, frames=1,
                 size=(H, W), content=EVAL_CONTENT):
    """The evaluation batches of ``evaluate`` over ``img_ids`` (default:
    every image of ``coco``), ``batch`` key images each, the last padded
    with repeated ids from the first: uint8 frames, content sizes, the
    original sizes and ids. With ``frames`` > 1 every key frame is
    followed by its ``frames - 1`` eval reference frames, as the port's
    ``CocoVideoDataset._ref_ids`` picks them (``data/dataset.py::ref_ids``
    with ``train=False``)."""
    from dfvod_tpu_torch.data.dataset import ref_ids
    ids = list(coco.getImgIds() if img_ids is None else img_ids)
    groups = [ids[k:k + batch] for k in range(0, len(ids), batch)]
    groups[-1] = groups[-1] + ids[:batch - len(groups[-1])]
    for group in groups:
        rows = [r for i in group
                for r in [i, *(ref_ids(coco, i, frames - 1, train=False)
                               if frames > 1 else [])]]
        yield {"images": torch.stack([eval_frame(coco, r, size, content)
                                      for r in rows]),
               "sizes": torch.tensor([content] * len(rows)),
               "orig_size": torch.tensor([[coco.imgs[r]["height"],
                                           coco.imgs[r]["width"]]
                                          for r in rows]),
               "image_id": torch.tensor(rows)}


class OracleDetector(torch.nn.Module):
    """A detector whose outputs encode a COCO file's ground truth: for the
    image whose index ``eval_frame`` wrote into a key frame's first pixel,
    one query per ground-truth box (its normalized cxcywh box, logit +8 at
    its category) and logit -8 elsewhere. Through ``evaluate`` it must
    score mAP 1.0, which holds postprocess, the original sizes and the key
    rows to account. ``frames``: rows per prediction, key frame first."""

    def __init__(self, coco, frames=1, num_queries=8, num_classes=3):
        super().__init__()
        from dfvod_tpu_torch.data.transforms import RGB_MEAN, RGB_STD
        ids = coco.getImgIds()
        logits = torch.full((len(ids), num_queries, num_classes), -8.0)
        boxes = torch.tensor([0.05, 0.05, 0.02, 0.02]).repeat(
            len(ids), num_queries, 1)
        for i, img_id in enumerate(ids):
            h, w = coco.imgs[img_id]["height"], coco.imgs[img_id]["width"]
            for q, a in enumerate(coco.imgToAnns[img_id]):
                x, y, bw, bh = a["bbox"]
                boxes[i, q] = torch.tensor([(x + bw / 2) / w, (y + bh / 2) / h,
                                            bw / w, bh / h])
                logits[i, q, a["category_id"]] = 8.0
        self.register_buffer("table_logits", logits)
        self.register_buffer("table_boxes", boxes)
        self.register_buffer("mean", torch.from_numpy(RGB_MEAN[:2]))
        self.register_buffer("std", torch.from_numpy(RGB_STD[:2]))
        # eval_forward reads the device and dtype of a parameter
        self.scale = torch.nn.Parameter(torch.ones(()))
        self.frames = frames

    def forward(self, images, mask):
        key = images[::self.frames, 0, 0, :2] * self.std + self.mean
        code = torch.round(key * 255).long()
        index = code[:, 0] + 256 * code[:, 1]
        return {"pred_logits": self.table_logits[index] * self.scale,
                "pred_boxes": self.table_boxes[index]}


def timed_batches(batches, marks):
    """``batches``, appending the host clock to ``marks`` once they run
    out: after the last batch's postprocess and update."""
    yield from batches
    marks.append(time.perf_counter())


def phase_eval_oracle():
    """``OracleDetector`` on the card through ``evaluate``: single frames
    (60 images, 8 per batch, the last padded) and 5-frame clips; both must
    give mAP == mAP_50 == 1.0."""
    from dfvod_tpu_torch.data.coco import CocoVID
    from dfvod_tpu_torch.train.evaluate import evaluate
    coco = CocoVID(VAL_JSON)
    results = {}
    for frames, batch in ((1, EVAL_BATCH), (CLIP_FRAMES, EVAL_CLIPS)):
        oracle = OracleDetector(coco, frames).cuda()
        stats = evaluate(oracle, [{k: v.cuda() for k, v in b.items()}
                                  for b in eval_batches(
                                      coco, batch=batch, frames=frames,
                                      size=(64, 96), content=(60, 75))],
                         coco, frames=frames, print_freq=0)
        print(f"[eval-oracle] frames={frames}: mAP {stats['mAP']:.6f} "
              f"mAP_50 {stats['mAP_50']:.6f} (must be 1)", flush=True)
        check(stats["mAP"] == stats["mAP_50"] == 1.0,
              f"the oracle scored {stats} with frames={frames}")
        results[f"frames_{frames}"] = stats["mAP"]
    return results


def eval_full_width(cfg, coco, batches, frames, want, tag):
    """``evaluate`` of the f32 model of ``cfg`` (seeded, ``randomize``d)
    over ``batches`` on the card: launches, stats, and times (forward and
    postprocess per image, then accumulate + summarize on the host)."""
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.train.evaluate import evaluate
    model, _, _ = build_model(cfg, device="cpu", seed=0)
    model = randomize(model, seed=1).to("cuda")
    batches = [{k: v.to("cuda") for k, v in b.items()} for b in batches]
    n_images = sum(b["image_id"].shape[0] // frames for b in batches)
    evaluate(model, batches[:1], coco, frames=frames, print_freq=0)  # warm
    torch.cuda.synchronize()
    marks = [time.perf_counter()]
    stats, launches = counted(lambda: evaluate(
        model, timed_batches(batches, marks), coco, frames=frames,
        print_freq=0))
    marks.append(time.perf_counter())
    check(launches == want_launches(**{k: v * len(batches)
                                       for k, v in want.items()}),
          f"{tag}: {len(batches)} batches launched {launches}, not {want} "
          f"per batch")
    check(all(math.isfinite(v) and -1.0 <= v <= 1.0 for v in stats.values()),
          f"{tag}: stats {stats}")
    fwd_ms = 1e3 * (marks[1] - marks[0]) / n_images
    host_ms = 1e3 * (marks[2] - marks[1])
    print(f"[{tag}] {len(batches)} batches, {n_images} images: launches "
          f"{ {k: v for k, v in launches.items() if v} } ({want} per batch);"
          f" ms per image (forward + postprocess + update) {fwd_ms:.3f}; "
          f"accumulate + summarize {host_ms:.1f} ms (host); stats "
          f"{ {k: round(v, 6) for k, v in stats.items()} }", flush=True)
    del model
    free_card()
    return {"batches": len(batches), "images": n_images,
            "launches": {k: v for k, v in launches.items() if v},
            "ms_per_image": fwd_ms, "accumulate_summarize_ms": host_ms,
            "stats": stats}


def phase_eval_full():
    """The serve configuration (LateFusion, hidden 256, 8 heads, 6+6 layers,
    300 queries, DC5, box refinement) in f32, as the JAX package
    evaluates, over val.json's 60 images at 608x800 (600x750 content) in
    batches of 8: 13 K1 per batch. Then the TransVOD++ model of
    ``TransVOD++_withdepth.sh`` on 2 clips x 5 frames per batch over the
    first four videos' frames: 16 K1 and 1 K3 per batch."""
    from dfvod_tpu_torch.data.coco import CocoVID
    from dfvod_tpu_torch.utils.config import Config, ModelConfig
    coco = CocoVID(VAL_JSON)
    single = eval_full_width(
        Config(model=ModelConfig(fusion_type="LateFusion")), coco,
        list(eval_batches(coco)), 1, {"msda_fwd": 13}, "eval")
    ids = [i for v in coco.get_vid_ids()[:4]
           for i in coco.get_img_ids_from_vid(v)]
    clips = eval_full_width(
        Config(model=ModelConfig(fusion_type="LateFusion",
                                 temporal_mode="transvod_pp",
                                 num_ref_frames=CLIP_FRAMES - 1)),
        coco, list(eval_batches(coco, ids, batch=EVAL_CLIPS,
                                frames=CLIP_FRAMES)),
        CLIP_FRAMES, {"msda_fwd": 16, "hat_sample_fwd": 1}, "eval-clips")
    return {"single": single, "clips": clips}


def phase_eval_card_vs_cpu():
    """A small LateFusion model's ``eval_forward`` and ``evaluate`` on the
    card and on the CPU over val.json's first 16 images at 96x128 (90x112
    content; the other 44 count as missed): logits
    and boxes of every batch within atol 1e-4 / rtol 1e-3; the stats'
    largest difference is printed."""
    from dfvod_tpu_torch.data.coco import COCO
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.train.evaluate import eval_forward, evaluate
    coco = COCO(VAL_JSON)
    cpu_model, _, _ = build_model(small_cfg(), device="cpu", seed=3)
    randomize(cpu_model, seed=4)
    gpu_model, _, _ = build_model(small_cfg(), device="cuda", seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    batches = list(eval_batches(coco, coco.getImgIds()[:2 * EVAL_BATCH],
                                size=(96, 128), content=(90, 112)))
    worst = 0.0
    for b in batches:
        ref = eval_forward(cpu_model, b["images"], b["sizes"])
        got = eval_forward(gpu_model, b["images"].cuda(), b["sizes"].cuda())
        for g, r in zip(got, ref):
            err = (g.cpu() - r).abs()
            worst = max(worst, float(err.max()))
            check(bool((err <= 1e-4 + 1e-3 * r.abs()).all()),
                  f"small eval forward: card vs cpu max_abs_err "
                  f"{float(err.max()):.3e}")
    stats_cpu = evaluate(cpu_model, batches, coco, print_freq=0)
    stats_gpu = evaluate(gpu_model, batches, coco, print_freq=0)
    diff = max(abs(stats_gpu[k] - stats_cpu[k]) for k in stats_cpu)
    print(f"[eval-small] card vs cpu over {len(batches)} batches: logits and"
          f" boxes max_abs_err {worst:.3e} (atol 1e-4 rtol 1e-3) ok; stats "
          f"largest difference {diff:.3e} (mAP {stats_gpu['mAP']:.6f} vs "
          f"{stats_cpu['mAP']:.6f})", flush=True)
    return {"max_abs_err": worst, "stats_max_diff": diff}


def train_cfg(fusion="LateFusion", train_dtype="bfloat16", **kw):
    """The recipe of configs/training/LateFusion_bf16.sh (or, by
    ``fusion``, Encoder_CrossFusion.sh / Backbone_CrossFusion.sh) in
    ``train_dtype``."""
    from dfvod_tpu_torch.utils.config import Config
    return Config.from_flat(
        fusion_type=fusion, num_classes=3, num_queries=300,
        num_feature_levels=1, dilation=True, with_box_refine=True,
        dropout=0.2, lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1,
        epochs=20, train_dtype=train_dtype, **kw)


def params_agree(got, ref, lrs, tag):
    """Every entry of two state dicts after one more step from equal
    weights and optimizer state: within atol 1e-4 / rtol 1e-3 (the card's
    gradient gate), or within twice Adam's largest step, 2.01 times the
    learning rate ``lrs[key]`` of its group. At this step, Adam's step
    m/sqrt(v) is at most 1.0014 of the rate, and where K2's summation
    order flips the sign of a gradient at noise level, the two runs step
    the entry in opposite directions. Returns (the largest error, the
    entries held by the second bound)."""
    worst, flipped = 0.0, 0
    for k, r in ref.items():
        err = (got[k].float() - r.float()).abs()
        worst = max(worst, float(err.max()) if err.numel() else 0.0)
        close = err <= 1e-4 + 1e-3 * r.float().abs()
        flipped += int((~close).sum())
        check(bool((close | (err <= 2.01 * lrs.get(k, 0.0))).all()),
              f"{tag}: {k} max_abs_err {float(err.max()):.3e}")
    return worst, flipped


def phase_checkpoints():
    """``LateFusion_bf16.sh`` at B=6 608x800: one step, ``save_checkpoint``,
    a train state from another seed restored with ``weights_only=False``
    (weights, optimizer, step and dropout generator bitwise), then one
    more step on both: loss within atol 1e-5 / rtol 1e-4, every parameter
    within the card's gradient gate or twice Adam's step (``params_agree``:
    K2's atomics make two runs differ by summation order). Then
    ``weights_only=True``: the weights bitwise, the
    optimizer fresh. Prints the file's size and the save and load times."""
    import tempfile
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.train import create_train_state, train_step
    from dfvod_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                  save_checkpoint)
    cfg = train_cfg()
    other = train_cfg(seed=cfg.train.seed + 1)
    batches = [{k: v.to("cuda") for k, v in train_batch(seed).items()}
               for seed in (20, 21)]

    def fresh(c, seed):
        model, criterion, _ = build_model(c, device="cpu", seed=seed)
        model = randomize(model, seed=seed + 1).to("cuda")
        return create_train_state(model, c, steps_per_epoch=1000), criterion

    state, criterion = fresh(cfg, 0)
    train_step(state, criterion, batches[0])
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(out, state, 0)
        save_ms = 1e3 * (time.perf_counter() - t0)
        size = os.path.getsize(path)
        resumed, _ = fresh(other, 5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_checkpoint(out, resumed, weights_only=False)
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
        saved = {k: v.clone() for k, v in state.model.state_dict().items()}
        check(all(torch.equal(v, saved[k]) for k, v in
                  resumed.model.state_dict().items())
              and resumed.step == state.step == 1
              and torch.equal(resumed.generator.get_state(),
                              state.generator.get_state()),
              "the restored state differs from the saved one")
        a = train_step(state, criterion, batches[1])["loss"]
        b = train_step(resumed, criterion, batches[1])["loss"]
        loss_err = abs(float(a) - float(b))
        check(loss_err <= 1e-5 + 1e-4 * abs(float(a)),
              f"resumed step loss {float(b)} vs {float(a)}")
        lrs = {n: g["lr"] for g in state.optimizer.param_groups
               for n, p in state.model.named_parameters()
               if any(p is q for q in g["params"])}
        worst, flipped = params_agree(resumed.model.state_dict(),
                                      state.model.state_dict(), lrs,
                                      "resumed step")
        del resumed
        weights, _ = fresh(other, 7)
        load_checkpoint(out, weights)
        check(all(torch.equal(v, saved[k]) for k, v in
                  weights.model.state_dict().items()),
              "weights_only=True: the weights differ from the saved ones")
        check(weights.step == 0 and not weights.optimizer.state,
              "weights_only=True restored the optimizer")
    del state, weights
    free_card()
    print(f"[ckpt] LateFusion_bf16 B={TRAIN_BATCH}: checkpoint "
          f"{size / 2**20:.1f} MiB, save {save_ms:.1f} ms, load "
          f"{load_ms:.1f} ms; resumed step loss {float(b):.6f} vs unbroken "
          f"{float(a):.6f} (err {loss_err:.3e}, atol 1e-5 rtol 1e-4); "
          f"parameters max_abs_err {worst:.3e} (atol 1e-4 rtol 1e-3, or "
          f"2.01 lr: {flipped} entries); weights_only=True bitwise, "
          f"optimizer fresh", flush=True)
    return {"size_mib": size / 2**20, "save_ms": save_ms, "load_ms": load_ms,
            "resumed_loss_err": loss_err, "resumed_param_max_err": worst,
            "resumed_param_adam_flips": flipped}


def reference_pair(dims, cfg, seed):
    """``tests/torch_ref.py``'s LateFusion replica of the reference, built
    on the card with random weights, and the port model of ``cfg`` loaded
    through the reference converter."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_ref import TorchDeformableDETR
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.utils.checkpoint import merge_matching
    from dfvod_tpu_torch.utils.convert_reference import (
        convert_reference_state_dict,
    )
    torch.manual_seed(seed)
    # the replica makes its constants with factory calls and no device
    with torch.device("cuda"):
        tm = TorchDeformableDETR(
            with_box_refine=True, two_stage=False, dilation=True,
            depth_type="DepthDeform_latefusion_dformer", **dims).eval()
        tm.randomize()
    state, unmapped = convert_reference_state_dict(tm.state_dict(),
                                                   verbose=False)
    model, _, _ = build_model(cfg, device="cuda", seed=seed)
    merged, report = merge_matching(model.state_dict(), state, verbose=False)
    # the reference's DFormer path holds a fourth stage its forward never
    # runs; the port builds none
    check(not unmapped and not report["missing"]
          and not report["shape_mismatch"]
          and all(".stage3_" in k for k in report["unexpected"]),
          f"reference conversion: unmapped {unmapped[:4]}, {report}")
    model.load_state_dict(merged)
    return tm, model.eval()


def reference_outputs(tm, model, x, s):
    from dfvod_tpu_torch.data.device_pipeline import device_normalize
    img, mask = device_normalize(x.cuda(), s.cuda())
    with torch.no_grad():
        with torch.device("cuda"):
            ref = tm(img.permute(0, 3, 1, 2).contiguous(), mask)
        got, launches = counted(lambda: model(img, mask))
    return ref, got, launches


def phase_reference_weights():
    """The reference's LateFusion model (``tests/torch_ref.py``, its MSDA the
    reference's ``F.grid_sample`` oracle) on the card, converted into the
    port (K1). Small (``test_full_model_parity.py``'s dims, 96x128, one
    padded image): logits, boxes and every aux output within atol 1e-4 /
    rtol 1e-3. Full width (the serve configuration, B=2 608x800, one
    padded), f32, TF32 off: the errors printed, the boxes within the serve
    gate."""
    from dfvod_tpu_torch.utils.config import Config, ModelConfig
    small = dict(num_classes=3, num_queries=12, d_model=64, nhead=4,
                 enc_layers=2, dec_layers=2, dim_feedforward=128)
    cfg = small_cfg(dropout=0.0)
    tm, model = reference_pair(small, cfg, seed=0)
    x, s = frames(8, B=2)
    x, s = x[:, :96, :128].contiguous(), torch.tensor([[96, 128], [60, 84]])
    ref, got, launches = reference_outputs(tm, model, x, s)
    check(launches == want_launches(msda_fwd=5),
          f"the small converted model launched {launches}")
    worst = 0.0
    heads = [("final", got, ref), *((f"aux{i}", g, r) for i, (g, r) in
                                    enumerate(zip(got["aux_outputs"],
                                                  ref["aux_outputs"])))]
    for tag, g, r in heads:
        for k in ("pred_logits", "pred_boxes"):
            err = (g[k] - r[k]).abs()
            worst = max(worst, float(err.max()))
            check(bool((err <= 1e-4 + 1e-3 * r[k].abs()).all()),
                  f"converted small model vs the replica, {tag} {k}: "
                  f"max_abs_err {float(err.max()):.3e}")
    print(f"[ref-weights] small LateFusion, port (K1) vs replica "
          f"(grid_sample), {len(heads)} heads: max_abs_err {worst:.3e} (atol "
          f"1e-4 rtol 1e-3) ok", flush=True)
    del tm, model
    full = dict(num_classes=3, num_queries=300, d_model=256, nhead=8,
                enc_layers=6, dec_layers=6, dim_feedforward=1024)
    tm, model = reference_pair(
        full, Config(model=ModelConfig(fusion_type="LateFusion",
                                       dropout=0.0)), seed=1)
    x, s = frames(9, B=2)
    ref, got, launches = reference_outputs(tm, model, x, s)
    check(launches == want_launches(msda_fwd=13),
          f"the full-width converted model launched {launches}")
    errs = {k: (got[k] - ref[k]).abs() for k in ("pred_logits",
                                                 "pred_boxes")}
    reading = {f"{k}_{f}": float(getattr(e, f)()) for k, e in errs.items()
               for f in ("max", "mean")}
    print(f"[ref-weights] full-width LateFusion B=2 {H}x{W} f32, port (K1) "
          f"vs replica (grid_sample): logits max "
          f"{reading['pred_logits_max']:.3e} mean "
          f"{reading['pred_logits_mean']:.3e}, boxes max "
          f"{reading['pred_boxes_max']:.3e} mean "
          f"{reading['pred_boxes_mean']:.3e} (gate max {BOX_MAX_TOL}, mean "
          f"{BOX_MEAN_TOL})", flush=True)
    check(reading["pred_boxes_max"] <= BOX_MAX_TOL
          and reading["pred_boxes_mean"] <= BOX_MEAN_TOL,
          "the converted full-width model disagrees with the replica")
    del tm, model
    free_card()
    return {"small_max_abs_err": worst, **reading}


def phase_remat(steps=3, train_peak_gib=None):
    """Encoder remat. A small model's remat step on the card against its
    non-remat step, dropout 0.2, the same weights, batch and generator
    state: loss atol 1e-5 / rtol 1e-4, gradients atol 1e-4 / rtol 1e-3.
    Then ``LateFusion_bf16.sh`` with ``remat=True`` at B=6 608x800: one
    warm-up, then ``steps`` timed steps with 19 K1 (13 + 6 recomputed) and
    13 K2 launches each, finite losses, and a peak memory below the
    non-remat train phase's."""
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.train import create_train_state, train_step
    from dfvod_tpu_torch.train.engine import forward
    batch = train_batch(5, B=2, max_boxes=8)
    batch["images"] = batch["images"][:, :96, :128].contiguous()
    batch["sizes"] = torch.tensor([[96, 128], [60, 84]])
    batch = {k: v.cuda() for k, v in batch.items()}
    results = []
    for remat in (False, True):
        cfg = small_cfg(dropout=0.2, remat=remat)
        model, criterion, _ = build_model(cfg, device="cpu", seed=3)
        model = randomize(model, seed=4).cuda()
        state = create_train_state(model, cfg)

        def step():
            loss, parts = criterion(*forward(state, batch))
            loss.backward()
            return loss.detach()
        loss, launches = counted(step)
        results.append((loss, {n: p.grad for n, p in model.named_parameters()
                               if p.grad is not None}, launches))
    (l0, g0, k0), (l1, g1, k1) = results
    check(k0 == want_launches(msda_fwd=5, msda_bwd=5)
          and k1 == want_launches(msda_fwd=7, msda_bwd=5),
          f"small remat step launched {k1} (plain {k0})")
    check(abs(float(l1) - float(l0)) <= 1e-5 + 1e-4 * abs(float(l0)),
          f"small remat loss {float(l1)} vs {float(l0)}")
    check(g0.keys() == g1.keys(), "remat: gradients on different sets")
    worst = 0.0
    for n, r in g0.items():
        err = (g1[n] - r).abs()
        worst = max(worst, float(err.max()))
        check(bool((err <= 1e-4 + 1e-3 * r.abs()).all()),
              f"small remat gradient {n}: max_abs_err {float(err.max()):.3e}")
    print(f"[remat-small] remat vs plain step on the card, dropout 0.2: loss "
          f"{float(l1):.6f} vs {float(l0):.6f}; {len(g0)} gradients "
          f"max_abs_err {worst:.3e} (atol 1e-4 rtol 1e-3); launches "
          f"msda_fwd 7 / 5, msda_bwd 5 / 5 ok", flush=True)

    cfg = train_cfg(remat=True)
    model, criterion, _ = build_model(cfg, device="cpu", seed=0)
    model = randomize(model, seed=1).to("cuda")
    state = create_train_state(model, cfg, steps_per_epoch=1000)
    batches = [{k: v.to("cuda") for k, v in train_batch(seed).items()}
               for seed in range(steps + 1)]
    train_step(state, criterion, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = want_launches(msda_fwd=19, msda_bwd=13)
    times, fwd, bwd = [], 0, 0
    for i, b in enumerate(batches[1:]):
        t0 = time.perf_counter()
        mt, launches = counted(lambda: train_step(state, criterion, b))
        times.append(time.perf_counter() - t0)
        check(launches == want,
              f"remat step {i + 1} launched {launches}, not {want}")
        check_finite({k: mt[k] for k in ("loss", "grad_norm")},
                     f"remat step {i + 1}")
        fwd += launches["msda_fwd"]
        bwd += launches["msda_bwd"]
    ms = 1e3 * sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[remat] LateFusion_bf16 remat=True B={TRAIN_BATCH} {H}x{W}: "
          f"launches over {steps} steps msda_fwd {fwd}, msda_bwd {bwd} (19 "
          f"and 13 per step); ms per step mean {ms:.3f} (per step "
          f"{', '.join(f'{1e3 * t:.3f}' for t in times)}); peak memory "
          f"{peak:.3f} GiB (without remat {train_peak_gib:.3f})", flush=True)
    check(peak < train_peak_gib, f"remat peak {peak:.3f} GiB is not below "
                                 f"the plain step's {train_peak_gib:.3f}")
    del state, model
    free_card()
    return {"small_grad_max_abs_err": worst, "ms_per_step": ms,
            "steps_ms": [1e3 * t for t in times], "peak_memory_gib": peak,
            "plain_peak_memory_gib": train_peak_gib, "launches_fwd": fwd,
            "launches_bwd": bwd, "steps": steps}


def phase_eval_ckpt(train_peak_gib):
    """Evaluation, checkpoints, reference weights and remat, in that
    order; each full-width model freed before the next."""
    return {"oracle": phase_eval_oracle(), **phase_eval_full(),
            "small": phase_eval_card_vs_cpu(),
            "checkpoint": phase_checkpoints(),
            "reference": phase_reference_weights(),
            "remat": phase_remat(train_peak_gib=train_peak_gib)}


# ------------------------------------------------------- data path and CLI
SYNTH_RGBD = os.path.join(REPO, "datasets", "synth_rgbd")
RECIPES = os.path.join(REPO, "configs", "training")
# SHA-256 of the decoded frames of datasets/synth_rgbd in sorted file order:
# images/*.jpg as RGB (H, W, 3), then depth_pred/*.jpg as (H, W) samples.
# tests/test_torch_image_io.py computes it with PIL and cv2.
SYNTH_RGBD_DECODE_SHA256 = ("3ba73367e57c4a683d511a1736aab991"
                            "de5e53eb0b93d233b4be22ea33a6aaaf")
# SHA-256 of the port's first 3 train batches (epoch 0) and first 2 val
# batches of configs/training/Synth_LateFusion.sh on datasets/synth_rgbd,
# built on the host (``loader_digest``); tests/test_torch_data.py holds it
# on the CPU and against the JAX package's loader.
SYNTH_RGBD_LOADER_SHA256 = ("4a9113e10a88f05dcbb0b90ff638f200"
                            "6d601294f5fac40a0fb5cc80f0fb9cf5")
# K1 / K3 / K2 / K4 launches of one step of each CLI run: LateFusion (6
# encoder + 1 depth encoder + 6 decoder MSDA layers, all trained); the
# TransVOD++ video stage under --fixed_pretrained_model (the trunk's 13
# layers forward and 3 temporal decoder rounds, RoIAlign once; the trunk
# gets no gradient, so K2 runs for the temporal rounds only, K4 not)
CLI_STEP_LAUNCHES = want_launches(msda_fwd=13, msda_bwd=13)
CLI_EVAL_LAUNCHES = want_launches(msda_fwd=13)
CLI_VIDEO_STEP_LAUNCHES = want_launches(msda_fwd=16, hat_sample_fwd=1,
                                        msda_bwd=3)
CLI_VIDEO_EVAL_LAUNCHES = want_launches(msda_fwd=16, hat_sample_fwd=1)


def recipe_argv(recipe, *args, **env):
    """(the port's module, the argument list) that
    ``configs/training/<recipe>`` passes to the JAX package's CLI, with
    ``args`` as the script's own arguments and ``env`` as its variables
    (``STAGE="video"``, ``COCO_PATH``, ...). bash runs the script with
    ``python`` standing in to print its arguments and ``mkdir`` / ``tee``
    doing nothing, so the list is bash's own expansion of the recipe."""
    stand_ins = ('python() { printf "%s\\0" "$@"; }; mkdir() { :; }; '
                 'tee() { cat; }; export -f python mkdir tee; . "$0"')
    out = subprocess.run(
        ["bash", "-c", stand_ins, os.path.join(RECIPES, recipe), *args],
        capture_output=True, text=True, check=True, timeout=60, cwd=REPO,
        env={**os.environ, **env})
    words = out.stdout.split("\0")[:-1]
    check(words[:2] == ["-u", "-m"] and words[2].startswith("dfvod_tpu."),
          f"{recipe}: not a CLI call: {words[:3]}")
    return words[2].replace("dfvod_tpu.", "dfvod_tpu_torch.", 1), words[3:]


def synth_jpegs(root=SYNTH_RGBD):
    """The JPEG files of ``root``: (sorted images/, sorted depth_pred/)."""
    coco = os.path.join(root, "coco")
    return tuple(sorted(os.path.join(coco, sub, f)
                        for f in os.listdir(os.path.join(coco, sub))
                        if f.endswith(".jpg"))
                 for sub in ("images", "depth_pred"))


def decode_digest(read_rgb, read_gray, root=SYNTH_RGBD):
    """SHA-256 over the decoded frames of ``root``: every RGB file through
    ``read_rgb`` ((H, W, 3) uint8), then every depth file through
    ``read_gray`` ((H, W) uint8), in sorted file order."""
    import hashlib
    import numpy as np
    digest = hashlib.sha256()
    images, depths = synth_jpegs(root)
    for files, read in ((images, read_rgb), (depths, read_gray)):
        for f in files:
            digest.update(np.ascontiguousarray(read(f), np.uint8).tobytes())
    return digest.hexdigest()


def synth_recipe_cfg(root=SYNTH_RGBD):
    """The Config of configs/training/Synth_LateFusion.sh on ``root``."""
    from dfvod_tpu_torch.cli.flags import config_from_args, get_args_parser
    module, argv = recipe_argv("Synth_LateFusion.sh", COCO_PATH=root)
    return config_from_args(get_args_parser().parse_args(argv))


def loader_batches(cfg, train_batches=3, val_batches=2, device=None):
    """The first ``train_batches`` batches of ``cfg``'s train loader (epoch
    0) and the first ``val_batches`` of its val loader, as the CLI builds
    them, on the host (or on ``device``)."""
    from dfvod_tpu_torch.data.dataset import build_dataset, make_transform
    from dfvod_tpu_torch.data.loader import Loader
    out = []
    for split, n in (("train", train_batches), ("val", val_batches)):
        loader = Loader(build_dataset(split, cfg),
                        make_transform(split == "train", cfg),
                        batch_size=cfg.train.batch_size,
                        max_boxes=cfg.data.max_boxes,
                        use_depth=cfg.data.use_depth, seed=cfg.train.seed,
                        shuffle=split == "train", drop_last=split == "train",
                        device=device)
        for i, b in enumerate(loader):
            if i == n:
                break
            out.append(b)
    return out


def loader_digest(batches):
    """SHA-256 over every batch's keys in sorted order: name, dtype, shape
    and bytes of each array."""
    import hashlib
    import numpy as np
    digest = hashlib.sha256()
    for b in batches:
        for k in sorted(b):
            v = b[k].cpu().numpy() if torch.is_tensor(b[k]) else np.asarray(
                b[k])
            digest.update(f"{k} {v.dtype} {v.shape}".encode())
            digest.update(np.ascontiguousarray(v).tobytes())
    return digest.hexdigest()


class CliProbe:
    """While active, every train step and eval forward that the CLI runs
    is timed (host clock to a synchronize) with the launches of each
    kernel in it: ``steps`` and ``evals`` hold (ms, {kernel: launches})."""

    def __enter__(self):
        from dfvod_tpu_torch.cli import main as cli
        from dfvod_tpu_torch.train import evaluate as ev
        self.steps, self.evals = [], []
        self._saved = [(cli, "train_step", cli.train_step),
                       (cli, "eval_forward", cli.eval_forward),
                       (ev, "eval_forward", ev.eval_forward)]
        for mod, name, fn in self._saved:
            into = self.steps if name == "train_step" else self.evals
            setattr(mod, name, self._wrap(fn, into))
        return self

    @staticmethod
    def _wrap(fn, into):
        counters = kernel_counters()

        def probe(*args, **kw):
            before = {k: c.launches for k, c in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            into.append((1e3 * (time.perf_counter() - t0),
                         {k: c.launches - before[k]
                          for k, c in counters.items()}))
            return out
        return probe

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def run_cli(recipe, out_dir, *args, env=None, cli_args=()):
    """``recipe``'s argument list (``args`` as the script's own, ``env`` its
    variables) plus ``cli_args`` through the port's CLI in this process, on
    the card. Returns (final stats, the probe, wall s, the launches of the
    whole run, the run's log.txt lines)."""
    from dfvod_tpu_torch.cli import main as cli
    module, argv = recipe_argv(recipe, *args, **(env or {}))
    argv = [*argv, "--output_dir", out_dir, *cli_args]
    print(f"[data-cli] python -m {module} {' '.join(argv)}", flush=True)
    with CliProbe() as probe:
        t0 = time.perf_counter()
        stats, total = counted(lambda: cli.main(
            argv, video=module.endswith("main_multi")))
        wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "log.txt")) as f:
        lines = [json.loads(x) for x in f]
    return stats, probe, wall, total, lines


def check_cli_launches(probe, total, want_step, want_eval, tag):
    """Every probed step and eval forward launched ``want_step`` /
    ``want_eval``, and the run launched nothing outside them. Returns the
    launches per step."""
    for i, (_, got) in enumerate(probe.steps):
        check(got == want_step, f"{tag}: step {i} launches {got}, want "
              f"{want_step}")
    for i, (_, got) in enumerate(probe.evals):
        check(got == want_eval, f"{tag}: eval batch {i} launches {got}, "
              f"want {want_eval}")
    want_total = {k: len(probe.steps) * want_step[k]
                  + len(probe.evals) * want_eval[k] for k in want_step}
    check(total == want_total, f"{tag}: run launches {total}, want "
          f"{want_total}")
    return want_step


def epoch_timing(line, probe_steps):
    """ms per step (median after the first 2), the loader's host ms per
    batch (decode, transform, collate) and the share of the epoch's wall
    time the loop waited for the loader, from a log.txt epoch line."""
    t = line["timing"]
    ld = t["loader_s"]
    ms = sorted(m for m, _ in probe_steps[2:]) or [m for m, _ in probe_steps]
    per = {k: 1e3 * ld[k] / max(ld["batches"], 1)
           for k in ("decode", "transform", "collate")}
    return {"ms_per_step": ms[len(ms) // 2], "steps": len(probe_steps),
            "loader_ms_per_batch": per,
            "loader_waited_share": ld["wait"] / t["epoch_s"],
            "epoch_s": t["epoch_s"]}


def check_stats(stats, tag):
    check(set(stats) == {"mAP", "mAP_50", "mAP_75", "mAP_small",
                         "mAP_medium", "mAP_large"}
          and all(math.isfinite(v) for v in stats.values()),
          f"{tag}: eval stats {stats}")


def phase_data_cli():
    """The data path and the training CLI on datasets/synth_rgbd: the host
    libraries built and the 600 JPEGs decoded against
    SYNTH_RGBD_DECODE_SHA256; the loader's first batches against
    SYNTH_RGBD_LOADER_SHA256 (and on the card against the host); then
    three recipes through the port's CLI in this process:
    LateFusion_bf16.sh for 1 epoch (40 steps of B=6, short sides 480-800),
    Synth_LateFusion.sh for 2 epochs, evaluated again from its output
    (--eval --resume) and continued by --auto_resume for a third epoch,
    and the video stage of SynthHard_Temporal.sh from that output
    (TransVOD++, 2 reference frames, B=4, --fixed_pretrained_model)."""
    import tempfile
    import numpy as np
    from dfvod_tpu_torch.data import image_io
    from dfvod_tpu_torch.ops import build
    with ThreadPoolExecutor(2) as pool:
        built = list(pool.map(build.build_host, ("jpeg_decode",
                                                 "preprocess")))
    for (path, seconds, _), name in zip(built, ("jpeg_decode",
                                                "preprocess")):
        print(f"[data-cli] {name}.cpp -> {os.path.relpath(path, REPO)}: "
              f"{seconds:.1f} s g++", flush=True)
    images, depths = synth_jpegs()
    t0 = time.perf_counter()
    digest = decode_digest(image_io.read_rgb, image_io.read_gray)
    decode_ms = 1e3 * (time.perf_counter() - t0) / (len(images) + len(depths))
    check(digest == SYNTH_RGBD_DECODE_SHA256,
          f"decoded frames sha256 {digest} != {SYNTH_RGBD_DECODE_SHA256}")
    print(f"[data-cli] decoded {len(images)} RGB + {len(depths)} depth JPEGs"
          f" of datasets/synth_rgbd: {decode_ms:.3f} host ms per frame "
          f"(hashing included), sha256 equals PIL's and cv2's ok",
          flush=True)

    cfg = synth_recipe_cfg()
    host = loader_batches(cfg)
    digest = loader_digest(host)
    check(digest == SYNTH_RGBD_LOADER_SHA256,
          f"loader sha256 {digest} != {SYNTH_RGBD_LOADER_SHA256}")
    card = loader_batches(cfg, device="cuda")
    check(all(v.device.type == "cuda" for b in card for v in b.values())
          and loader_digest(card) == digest,
          "loader batches on the card differ from the host's")
    print(f"[data-cli] Synth_LateFusion.sh loader: 3 train + 2 val batches, "
          f"image {tuple(host[0]['image'].shape)}, sha256 equals the CPU's; "
          f"pinned copies on the card equal", flush=True)

    results = {"decode_ms_per_frame": decode_ms}
    with tempfile.TemporaryDirectory() as tmp:
        # 3. LateFusion_bf16.sh: "" fills its --resume slot (RESUME_PATH
        # unset), as a user runs it without a checkpoint
        out = os.path.join(tmp, "bf16")
        stats, probe, wall, total, lines = run_cli(
            "LateFusion_bf16.sh", out, "", "--coco_path", SYNTH_RGBD,
            "--epochs", "1", "--eval_every", "1")
        per_step = check_cli_launches(probe, total, CLI_STEP_LAUNCHES,
                                      CLI_EVAL_LAUNCHES, "LateFusion_bf16")
        check_stats(stats, "LateFusion_bf16")
        check(len(probe.steps) == 40, f"{len(probe.steps)} steps, want 40")
        check(all(os.path.exists(os.path.join(out, f)) for f in (
            "args.yaml", "checkpoint0000.pth", "best/checkpoint0000.pth",
            "best_meta.json"))
              and [ln.get("epoch") for ln in lines] == [0, None]
              and lines[-1] == {"eval": stats}
              and math.isfinite(lines[0]["train_loss"]),
              f"LateFusion_bf16: output {sorted(os.listdir(out))} {lines}")
        bf16 = {**epoch_timing(lines[0], probe.steps), "wall_s": wall,
                "launches_per_step": per_step, "eval_batches":
                len(probe.evals), "stats": stats}
        results["latefusion_bf16"] = bf16
        print(f"[data-cli] LateFusion_bf16.sh 1 epoch on synth_rgbd: "
              f"{bf16['steps']} steps B=6 {bf16['ms_per_step']:.1f} ms/step "
              f"(median after 2); loader host ms/batch "
              + ", ".join(f"{k} {v:.1f}" for k, v in
                          bf16["loader_ms_per_batch"].items())
              + f"; loop waited {100 * bf16['loader_waited_share']:.2f}% of "
              f"the epoch's {bf16['epoch_s']:.1f} s; K1/K2 per step "
              f"{per_step['msda_fwd']}/{per_step['msda_bwd']}; "
              f"mAP_50 {stats['mAP_50']:.4f}; {card_line()}", flush=True)

        # 4. Synth_LateFusion.sh for 2 epochs, then --eval and --auto_resume
        out = os.path.join(tmp, "synth")
        stats, probe, wall, total, lines = run_cli(
            "Synth_LateFusion.sh", out, "--epochs", "2", "--eval_every", "1",
            env={"COCO_PATH": SYNTH_RGBD})
        per_step = check_cli_launches(probe, total, CLI_STEP_LAUNCHES,
                                      CLI_EVAL_LAUNCHES, "Synth_LateFusion")
        check_stats(stats, "Synth_LateFusion")
        synth = {**epoch_timing(lines[1], probe.steps[30:]), "wall_s": wall,
                 "launches_per_step": per_step, "stats": stats}
        again, _, _, _, _ = run_cli(
            "Synth_LateFusion.sh", out, "--epochs", "2",
            env={"COCO_PATH": SYNTH_RGBD}, cli_args=("--eval", "--resume",
                                                     out))
        diff = max(abs(again[k] - stats[k]) for k in stats)
        check(diff == 0.0, f"--eval --resume stats {again} != {stats}")
        _, probe3, _, _, lines3 = run_cli(
            "Synth_LateFusion.sh", out, "--epochs", "3", "--eval_every", "1",
            env={"COCO_PATH": SYNTH_RGBD}, cli_args=("--auto_resume",))
        epochs = [ln["epoch"] for ln in lines3 if "epoch" in ln]
        check(epochs == [0, 1, 2] and len(probe3.steps) == 30,
              f"--auto_resume ran epochs {epochs} in {len(probe3.steps)} "
              f"steps, want [0, 1, 2] and 30")
        results["synth_latefusion"] = synth
        print(f"[data-cli] Synth_LateFusion.sh 2 epochs: "
              f"{synth['ms_per_step']:.1f} ms/step in epoch 1, loop waited "
              f"{100 * synth['loader_waited_share']:.2f}%, mAP_50 "
              f"{stats['mAP_50']:.4f}; --eval --resume gives the same stats; "
              f"--auto_resume --epochs 3 ran epoch 2 only ({card_line()})",
              flush=True)

        # 5. SynthHard_Temporal.sh's video stage from that output
        vout = os.path.join(tmp, "video")
        vstats, vprobe, vwall, vtotal, vlines = run_cli(
            "SynthHard_Temporal.sh", vout, "--epochs", "1",
            env={"STAGE": "video", "COCO_PATH": SYNTH_RGBD,
                 "SPATIAL_WEIGHTS": out, "NREF": "2", "BATCH": "4"})
        per_step = check_cli_launches(vprobe, vtotal, CLI_VIDEO_STEP_LAUNCHES,
                                      CLI_VIDEO_EVAL_LAUNCHES, "video stage")
        check_stats(vstats, "video stage")
        frozen, moved = video_params_check(vout, out)
        video = {**epoch_timing(vlines[0], vprobe.steps), "wall_s": vwall,
                 "launches_per_step": per_step, "stats": vstats,
                 "temporal_tensors_moved": moved, "frozen_tensors": frozen}
        results["video_stage"] = video
        print(f"[data-cli] SynthHard_Temporal.sh video stage (TransVOD++, 2 "
              f"ref frames, B=4 clips, --fixed_pretrained_model): "
              f"{video['steps']} steps {video['ms_per_step']:.1f} ms/step; "
              f"K1/K3/K2/K4 per step {per_step['msda_fwd']}/"
              f"{per_step['hat_sample_fwd']}/{per_step['msda_bwd']}/"
              f"{per_step['hat_sample_bwd']}; {frozen} frozen parameters "
              f"bitwise the spatial checkpoint's, {moved[0]} of {moved[1]} "
              f"temporal ones moved; mAP_50 {vstats['mAP_50']:.4f} "
              f"({card_line()})", flush=True)
    free_card()
    return results


def video_params_check(video_out, spatial_out):
    """After the video stage: every frozen parameter bitwise the spatial
    checkpoint's (under ``detr.``), and the temporal ones moved from their
    initial values (the CLI's seeded init). Returns (frozen tensors,
    (temporal tensors moved, temporal tensors))."""
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.train.optim import label_params
    from dfvod_tpu_torch.utils.checkpoint import load_checkpoint
    from dfvod_tpu_torch.utils.config import Config
    saved = load_checkpoint(video_out)[0]
    a = saved["args"]
    cfg = Config.from_flat(**{**a["data"], **a["train"], **a["loss"],
                              **a["model"]})
    check(cfg.model.fixed_pretrained_model and
          cfg.model.temporal_mode == "transvod_pp",
          f"the video stage ran {cfg.model}")
    model = build_model(cfg, device="cpu", seed=cfg.train.seed)[0]
    labels = label_params(model, "LateFusion", True, temporal=True)
    got = saved["model"]
    spatial = load_checkpoint(spatial_out)[0]["model"]
    init = model.state_dict()
    frozen, moved, temporal = 0, 0, 0
    for k, label in labels.items():
        if label == "frozen":
            check(torch.equal(got[k].cpu(), spatial[k[len("detr."):]].cpu()),
                  f"video stage: frozen {k} changed")
            frozen += 1
        else:
            temporal += 1
            moved += int(not torch.equal(got[k].cpu(), init[k]))
    check(frozen > 0 and moved > 0, f"video stage: {moved} of {temporal} "
          f"temporal tensors moved")
    return frozen, (moved, temporal)


SOURCES = ("msda_fwd", "msda_bwd", "hat_sample_fwd", "hat_sample_bwd",
           "corner_gather_fwd", "hat_sample_sparse_fwd", "fused_bottleneck")


def ptxas_lines(log):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name
    (demangled where ``c++filt`` is found, without its parameters), then
    what ptxas says of its stack, spills and registers."""
    names, info, cur = [], {}, None
    for line in log.splitlines():
        if "Function properties for " in line:
            cur = line.split("Function properties for ", 1)[1].strip()
            names.append(cur)
            info[cur] = []
        elif cur and ("spill" in line or "registers" in line):
            info[cur].append(line.split(" : ", 1)[-1].strip())
    shown = names
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            shown = [n.replace("(anonymous namespace)::", "").split("(")[0]
                     .removeprefix("void ")
                     for n in out.stdout.splitlines()]
    return [f"{s}: {'; '.join(info[n])}" for s, n in zip(shown, names)]


def build_kernels(names=SOURCES):
    """Build and load the kernels of ``names`` (every source of the paths),
    one ``nvcc`` per source, all started together; print each build's time
    and each kernel's registers and spills."""
    from dfvod_tpu_torch.ops import build
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build.build, names))
    for name, (path, seconds, log) in zip(names, built):
        build.load(name)
        print(f"[build] {name}.cu -> {os.path.relpath(path, REPO)}: "
              f"{seconds:.1f} s nvcc", flush=True)
        for line in ptxas_lines(log):
            print(f"[build]   {line}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    build_kernels()
    kern = phase_msda_kernel()
    kern_bwd = phase_msda_bwd_kernel()
    kern_hat = phase_hat_kernel()
    kern_hat_bwd = phase_hat_bwd_kernel()
    kern_gather = phase_corner_gather_kernel()
    kern_sparse = phase_hat_sparse_kernel()
    kern_entries = phase_single_level_hat_entries()
    kern_fused = phase_fused_bottleneck_kernel()
    serve, server, ref_model, req, out32 = phase_serve()
    variants = phase_serve_variants(server, ref_model, req, out32)
    del server, ref_model, req, out32
    phase_small_cpu_reference()
    clip = phase_clip_serve()
    phase_small_temporal_reference()
    train = phase_train()
    phase_small_train_reference()
    onehot_train = phase_small_train_reference("pallas_onehot")
    train_clips = phase_train_clips()
    phase_small_video_train_reference()
    fusion = phase_fusion_modes()
    ecf, bcf = (fusion[m] for m in FUSION_MODES)
    eval_ckpt = phase_eval_ckpt(train["peak_memory_gib"])
    data_cli = phase_data_cli()

    enc = kern["enc"]
    record = {
        "name": "msda_fwd", "route": "cuda",
        "source": "dfvod_tpu_torch/csrc/msda_fwd.cu",
        "replaces": "dfvod_tpu/ops/msda_pallas.py:1022",
        "launches": serve["launches"],
        **{k: enc[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")},
        # no single PyTorch call computes MSDA; the reference's
        # F.grid_sample formulation is timed as a labelled yardstick
        "library_ms": None,
        "yardstick_ms": enc["yardstick_ms"],
        "shape": "encoder B=8 Lq=S=1900 M=8 D=32 L=1 P=4, bf16 value, "
                 "f32 loc, bf16 attw",
        "decoder": kern["dec"],
        "tdam_l5": kern["tdam_l5"],
        "enc_oob": kern["enc_oob"],
        "train_launches": train["launches_fwd"],
        "clip_launches": clip["launches_msda_fwd"],
        "train_clips_launches": train_clips["launches"]["msda_fwd"],
        "cf_stage2": kern["cf_stage2"],
        "encoder_cf_serve_launches": ecf["serve"]["launches"],
        "backbone_cf_serve_launches": bcf["serve"]["launches"],
        "encoder_cf_train_launches": ecf["train"]["launches_fwd"],
        "backbone_cf_train_launches": bcf["train"]["launches_fwd"],
        "eval_launches": eval_ckpt["single"]["launches"]["msda_fwd"],
        "clip_eval_launches": eval_ckpt["clips"]["launches"]["msda_fwd"],
        "remat_train_launches": eval_ckpt["remat"]["launches_fwd"],
    }
    enc = kern_bwd["enc"]
    record_bwd = {
        "name": "msda_bwd", "route": "cuda",
        "source": "dfvod_tpu_torch/csrc/msda_bwd.cu",
        "replaces": "dfvod_tpu/ops/msda_pallas.py:786",
        "launches": train["launches_bwd"],
        **{k: enc[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by")},
        # no single PyTorch call computes the MSDA backward; the backward
        # of the F.grid_sample formulation is timed as a labelled yardstick
        "library_ms": None,
        "yardstick_ms": enc["yardstick_ms"],
        "shape": f"encoder B={TRAIN_BATCH} Lq=S=1900 M=8 D=32 L=1 P=4, "
                 f"{kern_bwd['training_mix']} value/loc/attw (training mix)",
        "decoder": kern_bwd["dec"],
        "tdam_l5": kern_bwd["tdam_l5"],
        "video_f32": kern_bwd["video_f32"],
        "needs_ms": enc["needs"],
        "train_clips_launches": train_clips["launches"]["msda_bwd"],
        "cf_stage2": kern_bwd["cf_stage2"],
        "encoder_cf_train_launches": ecf["train"]["launches_bwd"],
        "backbone_cf_train_launches": bcf["train"]["launches_bwd"],
        "remat_train_launches": eval_ckpt["remat"]["launches_bwd"],
    }
    record_hat = {
        "name": "hat_sample_fwd", "route": "cuda",
        "source": "dfvod_tpu_torch/csrc/hat_sample_fwd.cu",
        "replaces": "dfvod_tpu/ops/msda_pallas.py:112",
        "launches": clip["launches_hat_sample_fwd"],
        **{k: kern_hat[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
        # torchvision.ops.roi_align would be the one library call, and the
        # card machine has no torchvision; F.grid_sample over the points is
        # timed as a labelled yardstick
        "library_ms": None,
        "yardstick_ms": kern_hat["yardstick_ms"],
        "shape": f"QRF BM={QRF_FRAMES} 38x50 D=256 bf16 value, "
                 f"Lq={QRF_ROIS}x49 PL=4 f32 points",
        "train_clips_launches": train_clips["launches"]["hat_sample_fwd"],
        "clip_eval_launches": eval_ckpt["clips"]["launches"][
            "hat_sample_fwd"],
    }
    main_bwd = kern_hat_bwd["qrf_float32_gv"]
    record_hat_bwd = {
        "name": "hat_sample_bwd", "route": "cuda",
        "source": "dfvod_tpu_torch/csrc/hat_sample_bwd.cu",
        "replaces": "dfvod_tpu/ops/msda_pallas.py:554",
        "launches": train_clips["launches"]["hat_sample_bwd"],
        **{k: main_bwd[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by")},
        # torchvision.ops.roi_align's backward would be the one library
        # call, and the card machine has no torchvision; the backward of
        # F.grid_sample over the points is timed as a labelled yardstick
        "library_ms": None,
        "yardstick_ms": main_bwd["yardstick_ms"],
        "shape": f"QRF training BM={CLIP_TRAIN_FRAMES} 38x50 D=256 f32 "
                 f"value and go, Lq={QRF_ROIS}x49 PL=4 real QRF points, gv "
                 f"only (the model path)",
        "other": {k: v for k, v in kern_hat_bwd.items()
                  if k != "qrf_float32_gv"},
    }
    per_request = variants["requests"]

    def variant_launches(impl, kernel):
        return variants[impl]["launches"][kernel]

    gather_common = {
        "route": "cuda", "source": "dfvod_tpu_torch/csrc/corner_gather_fwd.cu",
        **{k: kern_gather[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms",
                                       "library_dtype", "dispatch_ms")},
        "shape": "encoder B=8 Lq=S=1900 M=8 D=32 L=1 P=4 K=16, bf16 value, "
                 "int32 idx, f32 w (the folded corners of the serving mix)",
        "train_launches_small": onehot_train["corner_gather_fwd"],
        "paths_kernel_phase": kern_gather["paths"],
    }
    record_onehot = {
        "name": "corner_gather_fwd/onehot", **gather_common,
        "replaces": "dfvod_tpu/ops/msda_pallas.py:49",
        "launches": variant_launches("pallas_onehot", "corner_gather_fwd"),
        "paths": variants["pallas_onehot"]["paths"]["corner_gather_fwd"],
        "serve_requests": per_request,
    }
    record_gather = {
        "name": "corner_gather_fwd/gather", **gather_common,
        "replaces": "dfvod_tpu/ops/msda_pallas.py:1447",
        "launches": variant_launches("pallas", "corner_gather_fwd"),
        "paths": variants["pallas"]["paths"]["corner_gather_fwd"],
        "flat_launches": variant_launches("flat", "corner_gather_fwd"),
        "flat_paths": variants["flat"]["paths"]["corner_gather_fwd"],
        "serve_requests": per_request,
    }
    sparse = kern_sparse["enc"]
    record_sparse = {
        "name": "hat_sample_sparse_fwd", "route": "cuda",
        "source": "dfvod_tpu_torch/csrc/hat_sample_sparse_fwd.cu",
        "kernel": "hat_sample_sparse_fwd_vec_kernel (scalar: "
                  "hat_sample_levels_kernel)",
        "replaces": "dfvod_tpu/ops/msda_pallas.py:379",
        **{k: sparse[k] for k in ("launches", "paths", "max_abs_err", "ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "yardstick_ms")},
        # no single PyTorch call samples level-stacked grids; at one level
        # F.grid_sample and the weighted sum is a labelled yardstick
        "library_ms": None,
        "shape": "encoder BM=64 S=Lq=1900 D=32 PL=4, bf16 value, f32 points;"
                 " launches through ms_deform_attn_hat(sparse=True), which "
                 "no DFVOD_MSDA_IMPL reaches",
        "enc_l4": kern_sparse["enc_l4"],
    }
    # the tiled and separable entries launch K1; their numbers are measured
    # through each entry, launches counted in the entry's own call
    k1_entries = {
        "route": "cuda", "source": "dfvod_tpu_torch/csrc/msda_fwd.cu",
        "kernel": "msda_fwd", "library_ms": None,
        "shape": "encoder B=8 Lq=S=1900 M=8 D=32 L=1 P=4, serving mix, one "
                 "call of the entry",
    }
    record_tiled = {
        "name": "msda_fwd/hat_tiled", **k1_entries,
        "replaces": "dfvod_tpu/ops/msda_pallas.py:150",
        **kern_entries["tiled"],
    }
    record_sep = {
        "name": "msda_fwd/hat_sep", **k1_entries,
        "replaces": "dfvod_tpu/ops/msda_pallas.py:243",
        **kern_entries["sep"],
    }
    record_fused = {
        "name": "fused_bottleneck", "route": "cuda",
        "source": "dfvod_tpu_torch/csrc/fused_bottleneck.cu",
        "replaces": "dfvod_tpu/ops/fused_bottleneck.py:114",
        "launches": variant_launches("unset", "fused_bottleneck"),
        "paths": variants["unset"]["paths"]["fused_bottleneck"],
        "paths_kernel_phase": kern_fused["paths"],
        **{k: kern_fused[k] for k in ("max_abs_err", "relative_l2",
                                      "relative_l2_f64",
                                      "plain_relative_l2_f64", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "design_bound_ms", "design_bound_by",
                                      "yardstick_ms", "smem_bytes")},
        # no single PyTorch call runs a bottleneck stage; the port's
        # unfused bf16 layer1 (several cuDNN and elementwise calls) is the
        # labelled yardstick
        "library_ms": None,
        "shape": "serve layer1 (8, 152, 200, 64) bf16 -> (8, 152, 200, 256),"
                 " 3 blocks, one launch each",
    }
    new_records = [record_onehot, record_gather, record_sparse, record_tiled,
                   record_sep, record_fused]
    fusion_line = {mode: {
        "serve": {k: fusion[mode]["serve"][k] for k in (
            "ms_per_batch", "frames_per_s", "peak_memory_gib", "box_max",
            "box_mean", "launches", "requests", "paths")},
        "train": {k: fusion[mode]["train"][k] for k in (
            "ms_per_step", "frames_per_s", "first_step_ms",
            "peak_memory_gib", "launches_fwd", "launches_bwd", "steps")}}
        for mode in FUSION_MODES}
    fusion_line["bidirectional_relative_l2"] = fusion[
        "bidirectional_relative_l2"]
    for r in (record, record["decoder"], record["tdam_l5"], record["enc_oob"],
              record["cf_stage2"], record_bwd, record_bwd["decoder"],
              record_bwd["tdam_l5"], record_bwd["video_f32"],
              record_bwd["needs_ms"], record_bwd["cf_stage2"], record_hat,
              record_hat_bwd, *record_hat_bwd["other"].values(),
              *new_records, record_sparse["enc_l4"], train, clip,
              train_clips, *(v[k] for v in fusion_line.values()
                             if isinstance(v, dict) for k in v),
              *eval_ckpt.values(), eval_ckpt["single"]["stats"],
              eval_ckpt["clips"]["stats"],
              *(v for k, v in data_cli.items() if isinstance(v, dict)),
              *(v["stats"] for v in data_cli.values() if isinstance(v, dict)),
              *(v["loader_ms_per_batch"] for v in data_cli.values()
                if isinstance(v, dict))):
        for k, v in r.items():
            check(not isinstance(v, float) or math.isfinite(v),
                  f"non-finite {k}")
    print(card_line())
    print(json.dumps({"train": {k: train[k] for k in (
        "ms_per_step", "frames_per_s", "first_step_ms", "peak_memory_gib",
        "steps")}}))
    print(json.dumps({"train_clips": {k: train_clips[k] for k in (
        "ms_per_step", "clips_per_s", "frames_per_s", "first_step_ms",
        "peak_memory_gib", "bf16_step_ms", "steps")}}))
    print(json.dumps({"clip_serve": {k: clip[k] for k in (
        "ms_per_request", "frames_per_s", "clips_per_s", "first_request_ms",
        "peak_memory_gib", "requests")}}))
    print(json.dumps({"serve_variants": {
        k: v if k == "requests" else {n: v[n] for n in (
            "ms_per_batch", "box_max", "box_mean")}
        for k, v in variants.items()}}))
    print(json.dumps({"fusion_modes": fusion_line}))
    print(json.dumps({"eval_ckpt": eval_ckpt}))
    print(json.dumps({"data_cli": data_cli}))
    print(json.dumps({"kernels": [record, record_bwd, record_hat,
                                  record_hat_bwd, *new_records],
                      "serve": {k: serve[k] for k in ("ms_per_batch",
                                                      "frames_per_s")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
