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
   f32). K1 (``msda_fwd``) first, then K2 (``msda_bwd``);
4. the serving path at full width: LateFusion RGB-D DeformableDETR (ResNet-50
   DC5 + DFormer, hidden 256, 8 heads, 6+6 layers, 300 queries, box
   refinement) at B=8 608x800 from uint8 frames in bf16, random weights from
   a seed. The kernel launch counts are set to 0 just before and read just
   after; the detections must be finite and agree with the port's own f32
   forward; a small model on the card must agree with the same model on
   the CPU;
5. the training path at full width: the recipe of
   ``configs/training/LateFusion_bf16.sh`` at B=6 608x800, one warm-up and
   five timed ``train_step``s with 13 K1 and 13 K2 launches each (counts
   set to 0 just before, read just after), finite losses, the frozen
   ResNet-50 bitwise unchanged, every trainable group and the DFormer BN
   statistics moved; then a small f32 train step on the card against the
   same step on the CPU (loss, components and every gradient);
6. the card line, a JSON line of the train phase, a JSON line of the
   kernels, and the final line ``{"ok": true, "device": {...}}``.

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
    cases = [("enc", enc, f32, False), ("enc", enc, serve, False),
             ("dec", dec, f32, False), ("dec", dec, serve, False),
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
    cases = [(name, dims, dt) for name, dims in
             (("enc", enc), ("dec", dec), ("multi_d24", multi), ("oob", oob),
              ("integer_px", integer)) for dt in (f32, train, serve)]
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

    names = ("msda_fwd", "msda_bwd")
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
    serve = phase_serve()
    phase_small_cpu_reference()
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
    for r in (record, record["decoder"], record_bwd, record_bwd["decoder"],
              train):
        for k, v in r.items():
            check(not isinstance(v, float) or math.isfinite(v),
                  f"non-finite {k}")
    print(card_line())
    print(json.dumps({"train": {k: train[k] for k in (
        "ms_per_step", "frames_per_s", "first_step_ms", "peak_memory_gib",
        "steps")}}))
    print(json.dumps({"kernels": [record, record_bwd],
                      "serve": {k: serve[k] for k in ("ms_per_batch",
                                                      "frames_per_s")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
