"""Chip smoke test of the PyTorch/CUDA port (``dfvod_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, serves and trains on
the card.

    python3 chip_smoke.py

Phases, each on lines of its own:

1. the card: name and power limit (``nvidia-smi``), TF32 off for every
   comparison;
2. build every CUDA kernel of the serving and training paths from
   ``dfvod_tpu_torch/csrc``, one ``nvcc`` per source, all at once;
3. each kernel against its plain PyTorch version on the card, in f32 and
   the bf16 mixes the paths feed, at their shapes and edge cases, with
   times: kernel, plain version, a PyTorch yardstick, and the least time
   the card could take (bytes over 3.35 TB/s, operations over 67 TFLOP/s
   f32). K1 (``msda_fwd``, also at 5 levels, TDAM with 5 reference
   frames), then K2 (``msda_bwd``), then K3 (``hat_sample_fwd``, the
   bilinear sampling under RoIAlign) at the QRF shape and edge cases;
4. the serving path at full width: LateFusion RGB-D DeformableDETR (ResNet-50
   DC5 + DFormer, hidden 256, 8 heads, 6+6 layers, 300 queries, box
   refinement) at B=8 608x800 from uint8 frames in bf16, random weights from
   a seed. The kernel launch counts are set to 0 just before and read just
   after; the detections must be finite and agree with the port's own f32
   forward; a small model on the card must agree with the same model on
   the CPU;
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
   same step on the CPU (loss, components and every gradient);
7. the card line, a JSON line of the train phase, a JSON line of the
   kernels and the serving paths, and the final line
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, exits non-zero and never prints the final line.
Without a CUDA device, or without the repo around it, the script fails.
"""
from __future__ import annotations

import json
import math
import os
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


def msda_bound(value, loc, attw, out):
    """(least ms, 'bytes' | 'operations'): each input read once, the output
    written once; per sample point ~20 coordinate ops and 10 per channel
    (4 corner multiply-adds + the attention weight)."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (value, loc, attw, out))
    B, Lq, M, L, P = attw.shape
    ops = B * Lq * M * L * P * (10 * value.shape[-1] + 20)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    cases = [("enc", enc, f32, False), ("enc", enc, serve, False),
             ("dec", dec, f32, False), ("dec", dec, serve, False),
             ("tdam_l5", tdam, f32, False), ("tdam_l5", tdam, serve, False),
             ("multi_d24", multi, f32, False),
             ("multi_d24", multi, serve, False),
             ("multi_d24", multi, (torch.bfloat16,) * 3, False),
             ("multi_d24", multi,
              (torch.bfloat16, torch.bfloat16, torch.float32), False),
             ("oob", (((38, 50),), 2, 64, 8, 32, 4), f32, True),
             ("oob", (((38, 50),), 2, 64, 8, 32, 4), serve, True)]
    results = {}
    for name, (shapes, *dims), dtypes, oob in cases:
        value, loc, attw = msda_inputs(gen, shapes, *dims, dtypes, oob)
        got = msda.ms_deform_attn(value, shapes, loc, attw)
        torch.cuda.synchronize()
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
              f"{'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"msda_fwd disagrees with its plain version: {name} "
                  f"{tag} max_abs_err {max_err}")
        if name in ("enc", "dec") and dtypes == serve:
            out = got
            results[name] = {
                "max_abs_err": max_err,
                "ms": cuda_ms(lambda: msda.ms_deform_attn(
                    value, shapes, loc, attw), 50),
                "plain_ms": cuda_ms(lambda: msda.ms_deform_attn_plain(
                    value, shapes, loc, attw), 10),
                "yardstick_ms": cuda_ms(lambda: grid_sample_msda(
                    value, shapes, loc, attw), 20),
            }
            results[name]["bound_ms"], results[name]["bound_by"] = (
                msda_bound(value, loc, attw, out))
            r = results[name]
            print(f"[msda] time {name} bf16 value/f32 loc/bf16 attw: "
                  f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms,"
                  f" grid_sample yardstick {r['yardstick_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return results



BWD_OPS_PER_POINT, BWD_OPS_PER_CHANNEL = 30, 30


def msda_bwd_bound(tensors):
    """(least ms, 'bytes' | 'operations') of the MSDA backward: value, go,
    loc and attw read once, the three gradients written once; per sample
    point ~30 coordinate and reduction ops and ~30 per channel (the sample,
    both location derivatives, 4 weighted gradient adds)."""
    value, loc, attw = tensors[:3]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*tensors, value, loc, attw))
    B, Lq, M, L, P = attw.shape
    ops = B * Lq * M * L * P * (BWD_OPS_PER_CHANNEL * value.shape[-1]
                                + BWD_OPS_PER_POINT)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    def spy(value, shapes, loc, attw):
        seen.append((value.dtype, loc.dtype, attw.dtype))
        return kernel(value, shapes, loc, attw)

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


def grads_agree(got, ref, exact_zero, bf16):
    """(ok, tolerance, max abs error) of the kernel's three gradients
    against the plain backward's."""
    errs = [float((g.float() - r).abs().max()) for g, r in zip(got, ref)]
    if exact_zero:
        return (all(bool(torch.count_nonzero(g) == 0) for g in got),
                "exact zeros", max(errs))
    atol, rtol = (3e-2, 2e-2) if bf16 else (1e-4, 1e-4)
    ok = all(bool(((g.float() - r).abs() <= atol + rtol * r.abs()).all())
             for g, r in zip(got, ref))
    return ok, f"atol {atol:g} rtol {rtol:g}", max(errs)


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
    cases = [(name, dims, dt) for name, dims in
             (("enc", enc), ("dec", dec), ("multi_d24", multi), ("oob", oob),
              ("integer_px", integer), ("tdam_l5", tdam))
             for dt in (f32, train, serve)]
    results = {}
    for name, (shapes, B, Lq, M, D, P), dtypes in cases:
        value, loc, attw = msda_inputs(gen, shapes, B, Lq, M, D, P, dtypes,
                                       oob=name == "oob")
        if name == "integer_px":
            loc = integer_pixel_loc(gen, B, Lq, M, len(shapes), P,
                                    shapes).to(dtypes[1])
        go = torch.randn((B, Lq, M * D), generator=gen, device="cuda"
                         ).to(value.dtype)
        got = msda.ms_deform_attn_bwd(value, shapes, loc, attw, go)
        torch.cuda.synchronize()
        ref = msda.ms_deform_attn_plain_bwd(
            value.float(), shapes, loc.float(), attw.float(), go.float())
        ok, tol, max_err = grads_agree(got, ref, name == "oob",
                                       value.dtype == torch.bfloat16)
        tag = "/".join(str(d).replace("torch.", "") for d in dtypes)
        print(f"[msda_bwd] {name:10s} {tag:24s} shape={tuple(value.shape)} "
              f"Lq={Lq} max_abs_err={max_err:.3e} ({tol}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
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
        if name in ("enc", "dec") and dtypes == train:
            inputs = (value, loc, attw)
            results[name] = {
                "max_abs_err": max_err,
                "ms": cuda_ms(lambda: msda.ms_deform_attn_bwd(
                    value, shapes, loc, attw, go), 50),
                "plain_ms": backward_ms(
                    lambda v, l, a: msda.ms_deform_attn_plain(
                        v, shapes, l, a), inputs, go, 10),
                "yardstick_ms": backward_ms(
                    lambda v, l, a: grid_sample_msda(v, shapes, l, a),
                    inputs, go, 10),
            }
            results[name]["bound_ms"], results[name]["bound_by"] = (
                msda_bwd_bound((value, loc, attw, go)))
            r = results[name]
            print(f"[msda_bwd] time {name} {tag}: kernel {r['ms']:.4f} ms, "
                  f"plain backward {r['plain_ms']:.4f} ms, grid_sample "
                  f"backward yardstick {r['yardstick_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    results["training_mix"] = "/".join(str(d).replace("torch.", "")
                                       for d in train)
    return results


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
    nbytes = sum(t.numel() * t.element_size()
                 for t in (value, px, py, aw, out))
    BM, Lq, PL = px.shape
    ops = BM * Lq * PL * (HAT_OPS_PER_CHANNEL * value.shape[-1]
                          + HAT_OPS_PER_POINT)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def qrf_points(gen):
    """px, py, aw of the QRF RoIAlign at full width: 300 random boxes per
    frame on the 608x800 image, sampled on the 38x50 stride-16 memory with
    the model's spatial_scale 1/32, 7x7 bins, 2x2 points per bin."""
    from dfvod_tpu_torch.ops.roi_align import roi_sample_points
    from dfvod_tpu_torch.utils.box_ops import box_cxcywh_to_xyxy
    cxcy = torch.rand((QRF_FRAMES, QRF_ROIS, 2), generator=gen,
                      device="cuda") * 0.9 + 0.05
    wh = torch.rand((QRF_FRAMES, QRF_ROIS, 2), generator=gen,
                    device="cuda") * 0.6 + 0.02
    whwh = torch.tensor([W, H, W, H], dtype=torch.float32, device="cuda")
    boxes = box_cxcywh_to_xyxy(torch.cat([cxcy, wh], -1)) * whwh
    return roi_sample_points(boxes, H // 16, W // 16, output_size=7,
                             spatial_scale=1 / 32, sampling_ratio=2)


def edge_points(gen, BM, Lq, PL, h, w):
    """Points outside the grid, in (-1, 0) and (h-1, h), on integer
    coordinates, with aw = 0, the -1e6 padding, NaN and inf."""
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
    return px, py, aw


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
                  f"grid), bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
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


def phase_serve(requests=6):
    from dfvod_tpu_torch.data.device_pipeline import device_normalize
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.ops import msda
    from dfvod_tpu_torch.serve import Server
    from dfvod_tpu_torch.utils.config import Config, ModelConfig

    cfg = Config(model=ModelConfig(fusion_type="LateFusion"))
    m = cfg.model
    print(f"[serve] LateFusion hidden={m.hidden_dim} heads={m.nheads} "
          f"enc={m.enc_layers} dec={m.dec_layers} queries={m.num_queries} "
          f"dc5={m.dilation} refine={m.with_box_refine} B={BATCH} {H}x{W} "
          f"bf16", flush=True)
    t0 = time.perf_counter()
    ref_model, _, _ = build_model(cfg, device="cpu", seed=0)
    randomize(ref_model, seed=1)
    ref_model = ref_model.to("cuda")
    server = Server(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    server.model.load_state_dict(ref_model.state_dict())
    print(f"[serve] built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in server.model.parameters())} params",
          flush=True)
    reqs = [frames(seed) for seed in range(requests)]
    reqs = [(x.to("cuda"), s.to("cuda")) for x, s in reqs]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    msda.ms_deform_attn.launches = 0
    times, dets = [], []
    for x, s in reqs:
        t0 = time.perf_counter()
        dets.append(server(x, s))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = msda.ms_deform_attn.launches
    print(f"[serve] msda_fwd launches over {requests} requests: {launches}"
          f" ({launches / requests:g} per forward)", flush=True)
    check(launches == 13 * requests,
          f"expected 13 msda_fwd launches per forward, got {launches}")

    for d in dets:
        check(d["scores"].shape == (BATCH, 100)
              and d["boxes"].shape == (BATCH, 100, 4),
              f"detections of shape {tuple(d['boxes'].shape)}")
        check(bool(torch.isfinite(d["scores"]).all()
                   and torch.isfinite(d["boxes"].float()).all()),
              "non-finite detections")
    steady = times[1:]
    ms = 1e3 * sum(steady) / len(steady)
    print(f"[serve] ms per batch of {BATCH}: mean {ms:.3f} (first request "
          f"{1e3 * times[0]:.1f}; per request "
          f"{', '.join(f'{1e3 * t:.3f}' for t in steady)}) -> "
          f"{BATCH / (ms / 1e3):.1f} frames/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    # bf16 serve against the port's own f32 forward, same weights/inputs
    x, s = reqs[0]
    with torch.no_grad():
        out16 = server.forward(x, s)
        img, mask = device_normalize(x, s)
        out32 = ref_model(img, mask)
    diff = (out16["pred_boxes"].float() - out32["pred_boxes"]).abs()
    print(f"[serve] bf16 vs f32 boxes (normalized cxcywh): max "
          f"{float(diff.max()):.3e} mean {float(diff.mean()):.3e} "
          f"(tolerance max {BOX_MAX_TOL}, mean {BOX_MEAN_TOL}); logits "
          f"max diff {float((out16['pred_logits'].float() - out32['pred_logits']).abs().max()):.3e}",
          flush=True)
    check(bool(torch.isfinite(out32["pred_boxes"]).all()), "f32 not finite")
    check(float(diff.max()) <= BOX_MAX_TOL
          and float(diff.mean()) <= BOX_MEAN_TOL,
          "bf16 serve disagrees with the f32 forward")
    return {"ms_per_batch": ms, "frames_per_s": BATCH / (ms / 1e3),
            "launches": launches, "requests": requests}


def phase_small_cpu_reference():
    """A small model on the card (CUDA kernel) against the same model on
    the CPU (plain MSDA), f32, padded inputs: atol 1e-4 / rtol 1e-3 (TF32
    off; only summation order differs)."""
    from dfvod_tpu_torch.data.device_pipeline import device_normalize
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.utils.config import Config, ModelConfig
    cfg = Config(model=ModelConfig(
        fusion_type="LateFusion", num_queries=12, hidden_dim=64, nheads=4,
        enc_layers=2, dec_layers=2, dim_feedforward=128))
    cpu_model, _, _ = build_model(cfg, device="cpu", seed=3)
    randomize(cpu_model, seed=4)
    gpu_model, _, _ = build_model(cfg, device="cuda", seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    x, s = frames(5, B=2)
    x, s = x[:, :96, :128].contiguous(), torch.tensor([[96, 128], [60, 84]])
    with torch.no_grad():
        ref = cpu_model(*device_normalize(x, s))
        got = gpu_model(*device_normalize(x.cuda(), s.cuda()))
    for k in ("pred_logits", "pred_boxes"):
        err = (got[k].cpu() - ref[k]).abs()
        ok = bool((err <= 1e-4 + 1e-3 * ref[k].abs()).all())
        print(f"[small] card vs cpu {k}: max_abs_err {float(err.max()):.3e}"
              f" {'ok' if ok else 'FAIL'}", flush=True)
        check(ok, f"small model on the card disagrees with the CPU on {k}")


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
    gen = torch.Generator().manual_seed(1000 + seed)
    n_valid = torch.randint(1, 9, (B,), generator=gen)
    valid = torch.arange(max_boxes)[None] < n_valid[:, None]
    labels = torch.randint(0, 2, (B, max_boxes), generator=gen,
                           dtype=torch.int32) * valid
    cxcy = torch.rand((B, max_boxes, 2), generator=gen) * 0.6 + 0.2
    wh = torch.rand((B, max_boxes, 2), generator=gen) * 0.3 + 0.05
    boxes = torch.cat([cxcy, wh], -1) * valid[..., None]
    return {"images": imgs, "sizes": sizes, "labels": labels,
            "boxes": boxes, "valid": valid}


def phase_train(steps=5):
    """The recipe of configs/training/LateFusion_bf16.sh at full width:
    one warm-up step, then ``steps`` timed ones."""
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.models.backbone_dformer import BatchNorm
    from dfvod_tpu_torch.ops import msda
    from dfvod_tpu_torch.train import create_train_state, train_step
    from dfvod_tpu_torch.utils.config import Config

    cfg = Config.from_flat(
        fusion_type="LateFusion", num_classes=3, num_queries=300,
        num_feature_levels=1, dilation=True, with_box_refine=True,
        dropout=0.2, lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1,
        epochs=20, train_dtype="bfloat16")
    m = cfg.model
    print(f"[train] LateFusion hidden={m.hidden_dim} heads={m.nheads} "
          f"enc={m.enc_layers} dec={m.dec_layers} queries={m.num_queries} "
          f"dropout={m.dropout} lr={cfg.train.lr} clip="
          f"{cfg.train.clip_max_norm} B={TRAIN_BATCH} {H}x{W} "
          f"{cfg.train.train_dtype} autocast", flush=True)
    model, criterion, _ = build_model(cfg, device="cpu", seed=0)
    model = randomize(model, seed=1).to("cuda")
    state = create_train_state(model, cfg, steps_per_epoch=1000)
    groups = [g["label"] for g in state.optimizer.param_groups]
    for g in state.optimizer.param_groups:
        print(f"[train] group {g['label']}: "
              f"{sum(p.numel() for p in g['params'])} params, lr "
              f"{g['lr']:g}", flush=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    bns = [mod for mod in model.depth_backbone.modules()
           if isinstance(mod, BatchNorm)]
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
    msda.ms_deform_attn.launches = 0
    msda.ms_deform_attn_bwd.launches = 0
    times = []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        metrics.append(train_step(state, criterion, batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    fwd, bwd = msda.ms_deform_attn.launches, msda.ms_deform_attn_bwd.launches
    print(f"[train] launches over {steps} steps: msda_fwd {fwd}, msda_bwd "
          f"{bwd} ({fwd / steps:g} and {bwd / steps:g} per step)",
          flush=True)
    check(fwd == 13 * steps and bwd == 13 * steps,
          f"expected 13 msda_fwd and 13 msda_bwd launches per step, got "
          f"{fwd} and {bwd} over {steps} steps")
    for i, mt in enumerate(metrics):
        loss, gn = float(mt["loss"]), float(mt["grad_norm"])
        print(f"[train] step {i}: loss {loss:.4f} grad_norm {gn:.4f} "
              f"loss_ce {float(mt['loss_ce']):.4f} loss_bbox "
              f"{float(mt['loss_bbox']):.4f} loss_giou "
              f"{float(mt['loss_giou']):.4f}", flush=True)
        check(math.isfinite(loss) and math.isfinite(gn),
              f"non-finite loss or grad_norm at step {i}")

    changed = {n: not torch.equal(p.detach(), before[n])
               for n, p in model.named_parameters()}
    frozen = [n for n, lab in state.labels.items() if lab == "frozen"]
    check(frozen and all(n.startswith("backbone.") for n in frozen)
          and not any(changed[n] for n in frozen),
          "a frozen ResNet-50 parameter changed")
    check(all(n in frozen for n, _ in model.backbone.named_parameters(
        prefix="backbone")), "a ResNet-50 parameter is not frozen")
    for label in groups:
        names = [n for n, lab in state.labels.items() if lab == label]
        n_changed = sum(changed[n] for n in names)
        print(f"[train] group {label}: {n_changed} of {len(names)} "
              f"tensors changed", flush=True)
        check(n_changed > 0, f"no parameter of group {label} changed")
    bn_moved = sum(not (torch.equal(b.running_mean, m0)
                        and torch.equal(b.running_var, v0))
                   for b, (m0, v0) in zip(bns, bn_before))
    print(f"[train] ResNet-50: {len(frozen)} tensors bitwise unchanged; "
          f"DFormer BN running statistics changed in {bn_moved} of "
          f"{len(bns)} layers", flush=True)
    check(bn_moved == len(bns), "DFormer BN running statistics unchanged")
    ms = 1e3 * sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] ms per step of {TRAIN_BATCH}: mean {ms:.3f} (first step "
          f"{first_ms:.1f}; per step "
          f"{', '.join(f'{1e3 * t:.3f}' for t in times)}) -> "
          f"{TRAIN_BATCH / (ms / 1e3):.1f} frames/s; peak memory "
          f"{peak:.2f} GiB", flush=True)
    return {"ms_per_step": ms, "frames_per_s": TRAIN_BATCH / (ms / 1e3),
            "first_step_ms": first_ms, "steps_ms": [1e3 * t for t in times],
            "peak_memory_gib": peak, "launches_fwd": fwd,
            "launches_bwd": bwd, "steps": steps}


def phase_small_train_reference():
    """One train-step loss and every gradient, a small model on the card
    (CUDA kernels) against the same model on the CPU (plain MSDA): f32, TF32
    off, the same weights, batch and generator seed, dropout 0. Loss and
    components atol 1e-5 / rtol 1e-4, gradients atol 1e-4 / rtol 1e-3:
    summation order and the backward's atomics are the only differences."""
    from dfvod_tpu_torch.models import build_model
    from dfvod_tpu_torch.ops import msda
    from dfvod_tpu_torch.train.engine import create_train_state, forward
    from dfvod_tpu_torch.utils.config import Config, ModelConfig

    cfg = Config(model=ModelConfig(
        fusion_type="LateFusion", num_queries=12, hidden_dim=64, nheads=4,
        enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0))
    cpu_model, criterion, _ = build_model(cfg, device="cpu", seed=3)
    randomize(cpu_model, seed=4)
    gpu_model, _, _ = build_model(cfg, device="cuda", seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    batch = train_batch(5, B=2, max_boxes=8)
    batch["images"] = batch["images"][:, :96, :128].contiguous()
    batch["sizes"] = torch.tensor([[96, 128], [60, 84]])
    results = []
    msda.ms_deform_attn.launches = msda.ms_deform_attn_bwd.launches = 0
    for model, dev in ((cpu_model, "cpu"), (gpu_model, "cuda")):
        state = create_train_state(model, cfg)
        loss, parts = criterion(*forward(
            state, {k: v.to(dev) for k, v in batch.items()}))
        loss.backward()
        results.append(({k: v.detach() for k, v in
                         {"loss": loss, **parts}.items()},
                        {n: p.grad for n, p in model.named_parameters()
                         if p.grad is not None}))
    check(msda.ms_deform_attn.launches == 5
          and msda.ms_deform_attn_bwd.launches == 5,
          "the small card step did not launch msda_fwd and msda_bwd 5 "
          "times each")
    (ref_parts, ref_grads), (parts, grads) = results
    worst = 0.0
    for k, r in ref_parts.items():
        err = abs(float(parts[k]) - float(r))
        worst = max(worst, err)
        check(err <= 1e-5 + 1e-4 * abs(float(r)),
              f"small train step: card {k} {float(parts[k])} vs cpu "
              f"{float(r)}")
    check(grads.keys() == ref_grads.keys(), "gradients on different sets")
    gworst = 0.0
    for n, r in ref_grads.items():
        err = (grads[n].cpu() - r).abs()
        gworst = max(gworst, float(err.max()))
        check(bool((err <= 1e-4 + 1e-3 * r.abs()).all()),
              f"small train step: gradient of {n} differs, max "
              f"{float(err.max()):.3e}")
    print(f"[small-train] card vs cpu: loss {float(parts['loss']):.6f} vs "
          f"{float(ref_parts['loss']):.6f}, max component err {worst:.3e} "
          f"(atol 1e-5 rtol 1e-4); {len(grads)} gradients, max abs err "
          f"{gworst:.3e} (atol 1e-4 rtol 1e-3) ok", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dfvod_tpu_torch.ops import build

    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}"
          f" cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    names = ("msda_fwd", "msda_bwd", "hat_sample_fwd")
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        built = list(pool.map(build.build, names))
    for name, (path, seconds, log) in zip(names, built):
        build.load(name)
        print(f"[build] {name}.cu -> {os.path.relpath(path, REPO)}: "
              f"{seconds:.1f} s nvcc", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}", flush=True)

    kern = phase_msda_kernel()
    kern_bwd = phase_msda_bwd_kernel()
    kern_hat = phase_hat_kernel()
    serve = phase_serve()
    phase_small_cpu_reference()
    clip = phase_clip_serve()
    phase_small_temporal_reference()
    train = phase_train()
    phase_small_train_reference()

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
        "train_launches": train["launches_fwd"],
        "clip_launches": clip["launches_msda_fwd"],
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
    }
    for r in (record, record["decoder"], record_bwd, record_bwd["decoder"],
              record_hat, train, clip):
        for k, v in r.items():
            check(not isinstance(v, float) or math.isfinite(v),
                  f"non-finite {k}")
    print(card_line())
    print(json.dumps({"train": {k: train[k] for k in (
        "ms_per_step", "frames_per_s", "first_step_ms", "peak_memory_gib",
        "steps")}}))
    print(json.dumps({"clip_serve": {k: clip[k] for k in (
        "ms_per_request", "frames_per_s", "clips_per_s", "first_request_ms",
        "peak_memory_gib", "requests")}}))
    print(json.dumps({"kernels": [record, record_bwd, record_hat],
                      "serve": {k: serve[k] for k in ("ms_per_batch",
                                                      "frames_per_s")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
