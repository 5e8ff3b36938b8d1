"""How far f32 rounding alone moves what ``chip_smoke.py`` compares on the
card, against float64: K2 (``msda_bwd``) and its plain backward at the B=6
encoder shape and at ``cf_stage2`` (Backbone_CrossFusion's stage-2 fusion
site, 7600 queries onto a 152x200 map), and the small bidirectional
``CrossFusionBackbone`` on the card and on the CPU.

For each gradient (value, loc, attw) and each backbone feature it prints
the largest entry of the float64 result and, for each pair of (kernel or
card, f32 plain or CPU, float64), the largest absolute difference, the
entries outside atol 1e-4 / rtol 1e-4 (K2) or atol 1e-4 / rtol 1e-3
(features), and that difference relative to the largest entry. The
float64 plain backward computes its pixel coordinates and their floors in
float64, so where an f32 coordinate rounds onto the other side of a pixel
edge it picks other corners: its grad_loc is not the f32 computation
without rounding, and the loc rows against it read as a bound on neither.

    python3 scripts/msda_precision.py

Needs one CUDA device. TF32 off.
"""
from __future__ import annotations

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def diff(got, ref, atol, rtol):
    e = (got.double().cpu() - ref.double().cpu()).abs()
    scale = float(ref.abs().max())
    outside = int((e > atol + rtol * ref.double().cpu().abs()).sum())
    return (f"max {float(e.max()):.3e}, {outside} of {e.numel()} outside, "
            f"{float(e.max()) / max(scale, 1e-30):.2e} of the largest")


def k2(cs):
    from dfvod_tpu_torch.ops import msda
    gen = torch.Generator(device="cuda").manual_seed(1)
    for name, (shapes, B, Lq, M, D, P) in (
            ("enc", (((38, 50),), cs.TRAIN_BATCH, 1900, 8, 32, 4)),
            ("cf_stage2", cs.cf_stage2(cs.TRAIN_BATCH))):
        f32 = (torch.float32,) * 3
        value, loc, attw = cs.msda_inputs(gen, shapes, B, Lq, M, D, P, f32)
        go = torch.randn((B, Lq, M * D), generator=gen, device="cuda")
        kernel = msda.ms_deform_attn_bwd(value, shapes, loc, attw, go)
        plain = msda.ms_deform_attn_plain_bwd(value, shapes, loc, attw, go)
        exact = msda.ms_deform_attn_plain_bwd(
            value.double(), shapes, loc.double(), attw.double(), go.double())
        for g, k, p, x in zip(("value", "loc", "attw"), kernel, plain, exact):
            print(f"[k2] {name} grad_{g}: largest {float(x.abs().max()):.3e};"
                  f" kernel-plain {diff(k, p, 1e-4, 1e-4)}; kernel-f64 "
                  f"{diff(k, x, 1e-4, 1e-4)}; plain-f64 "
                  f"{diff(p, x, 1e-4, 1e-4)}", flush=True)


def backbone(cs):
    from dfvod_tpu_torch.data.device_pipeline import device_normalize
    from dfvod_tpu_torch.models import init_parameters
    from dfvod_tpu_torch.models.backbone_crossfusion import (
        CrossFusionBackbone,
    )
    models = []
    for dtype, dev in ((torch.float32, "cpu"), (torch.float32, "cuda"),
                       (torch.float64, "cpu")):
        m = CrossFusionBackbone(d_model=64, n_heads=4, dropout=0.0,
                                bidirectional=True)
        if not models:
            init_parameters(m, torch.Generator().manual_seed(3))
            cs.randomize(m, seed=4)
        else:
            m.load_state_dict(models[0].state_dict())
        models.append(m.to(dev, dtype).eval())
    x, s = cs.frames(6, B=2)
    x, s = x[:, :96, :128].contiguous(), torch.tensor([[96, 128], [60, 84]])
    img, mask = device_normalize(x, s)
    outs = []
    with torch.no_grad():
        for m in models:
            p = next(m.parameters())
            i = img.to(p.device, p.dtype)
            feats, _, dfeat, _ = m(i[..., :3], i[..., 3:], mask.to(p.device))
            outs.append((feats[0], dfeat))
    for j, tag in enumerate(("rgb stage 4", "depth")):
        cpu, card, exact = (o[j] for o in outs)
        print(f"[backbone] bidirectional {tag}: largest "
              f"{float(exact.abs().max()):.3e}; card-cpu "
              f"{diff(card, cpu, 1e-4, 1e-3)}; cpu-f64 "
              f"{diff(cpu, exact, 1e-4, 1e-3)}; card-f64 "
              f"{diff(card, exact, 1e-4, 1e-3)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("msda_precision: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[card] {cs.card_line()}", flush=True)
    cs.build_kernels(("msda_fwd", "msda_bwd"))
    k2(cs)
    backbone(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
