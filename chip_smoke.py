"""Chip smoke test of the PyTorch/CUDA port (``dfvod_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds and serves on the card.

    python3 chip_smoke.py

Phases, each on lines of its own:

1. the card: name and power limit (``nvidia-smi``), TF32 off for every
   comparison;
2. build every CUDA kernel of the serving path from ``dfvod_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, in f32 and
   bf16, at the serving path's shapes and edge cases, with times: kernel,
   plain version, a PyTorch yardstick, and the least time the card could
   take (bytes over 3.35 TB/s, operations over 67 TFLOP/s f32);
4. the serving path at full width: LateFusion RGB-D DeformableDETR (ResNet-50
   DC5 + DFormer, hidden 256, 8 heads, 6+6 layers, 300 queries, box
   refinement) at B=8 608x800 from uint8 frames in bf16, random weights from
   a seed. The kernel launch counts are set to 0 just before and read just
   after; the detections must be finite and agree with the port's own f32
   forward; a small model on the card must agree with the same model on
   the CPU;
5. a JSON line of the kernels, the card line again, and the final line
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

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, BATCH = 608, 800, 8
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


def cuda_ms(fn, iters, warmup=3):
    """Mean ms of ``fn`` over ``iters`` back-to-back launches, CUDA
    events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    ref_model, _ = build_model(cfg, device="cpu", seed=0)
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
    cpu_model, _ = build_model(cfg, device="cpu", seed=3)
    randomize(cpu_model, seed=4)
    gpu_model, _ = build_model(cfg, device="cuda", seed=3)
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

    path, seconds, log = build.build("msda_fwd")
    build.load("msda_fwd")
    print(f"[build] msda_fwd.cu -> {os.path.relpath(path, REPO)}: "
          f"{seconds:.1f} s nvcc", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}", flush=True)

    kern = phase_msda_kernel()
    serve = phase_serve()
    phase_small_cpu_reference()

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
    }
    for r in (record, record["decoder"]):
        for k, v in r.items():
            check(not isinstance(v, float) or math.isfinite(v),
                  f"non-finite {k}")
    print(card_line())
    print(json.dumps({"kernels": [record],
                      "serve": {k: serve[k] for k in ("ms_per_batch",
                                                      "frames_per_s")}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
