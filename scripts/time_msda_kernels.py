"""Check and time the MSDA kernels K1 (``msda_fwd``) and K2 (``msda_bwd``),
the RoIAlign sampling kernels K3 (``hat_sample_fwd``), K4
(``hat_sample_bwd``) and K5a (``hat_sample_sparse_fwd``), the
folded-corner gather K5b/c (``corner_gather_fwd``) and the fused
ResNet layer1 K6 (``fused_bottleneck``) of the PyTorch/CUDA port under
``--root`` (default: this checkout) on one NVIDIA GPU, with
``chip_smoke.py``'s own kernel phases: each kernel against its plain
version at every case, then the timings that decide their design (K1 at
the encoder, decoder, 5-level TDAM and all-outside shapes; K2 at the
encoder, decoder, TDAM and f32 video shapes and by the gradients asked
for; K3 at the QRF serve shape; K4 at the QRF training shape with real
and uniform points, with and without point gradients; K5a at the encoder
shape and at 4 levels; K5b/c at the B=8 encoder shape in bf16 beside
``F.embedding_bag``; K6 on the serve model's layer1 input, 8 x 152 x 200
x 64 bf16, beside the unfused layer1) and the matcher's LAPJV kernel
(``lapjv``: every slot against ``lapjv_plain`` and each path's problem
set timed, ``chip_smoke.LAPJV_MAIN``, with its plan of C CTAs x W warps
a problem where the tree's kernel has plans). ``--phases`` takes a
comma-separated subset of the groups ``msda``, ``hat``, ``gather``,
``bottleneck`` and ``lapjv``; all five by default.

To hold two commits against each other, unpack the other one with
``git archive`` into a git-ignored directory and run both in one call on
one card, in the order parent, change, change, parent:

    python3 scripts/time_msda_kernels.py --root .scratch/parent
    python3 scripts/time_msda_kernels.py

Prints the build's register and spill lines, the phases' lines and, last,
one JSON object of the times.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernel sources each group of phases builds
PHASES = {"msda": ("msda_fwd", "msda_bwd"),
          "hat": ("hat_sample_fwd", "hat_sample_bwd",
                  "hat_sample_sparse_fwd"),
          "gather": ("corner_gather_fwd",),
          "bottleneck": ("fused_bottleneck",),
          "lapjv": ("lapjv",)}


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=REPO,
                        help="checkout whose dfvod_tpu_torch is timed")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated groups: msda (K1, K2), hat "
                             "(K3, K4, K5a), gather (K5b/c), bottleneck (K6), "
                             "lapjv (the matcher)")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    phases = set(args.phases.split(","))
    if not phases or phases - set(PHASES):
        parser.error(f"--phases takes groups of {sorted(PHASES)}")
    if not torch.cuda.is_available():
        print("time_msda_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from dfvod_tpu_torch.ops import msda
    if not os.path.abspath(msda.__file__).startswith(root + os.sep):
        print(f"time_msda_kernels: imported {msda.__file__}, not the "
              f"package under {root}", file=sys.stderr)
        return 1
    smoke = load_chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"[card] {card}; package {os.path.dirname(msda.__file__)}",
          flush=True)
    # a tree older than a source (an older K5a was in hat_sample_fwd.cu)
    # builds the sources it has
    csrc = os.path.join(root, "dfvod_tpu_torch", "csrc")
    smoke.build_kernels(tuple(dict.fromkeys(
        src for group in sorted(phases) for src in PHASES[group]
        if os.path.exists(os.path.join(csrc, f"{src}.cu")))))

    def times(results):
        return {k: {n: v for n, v in r.items()
                    if n in ("ms", "plain_ms", "bound_ms", "needs",
                             "library_ms", "yardstick_ms", "paths", "plan",
                             "max_steps", "us_per_step", "host_us")}
                for k, r in results.items() if isinstance(r, dict)}

    out = {"root": root, "card": card}
    if "msda" in phases:
        out["msda_fwd"] = times(smoke.phase_msda_kernel())
        out["msda_bwd"] = times(smoke.phase_msda_bwd_kernel())
    if "hat" in phases:
        out["hat_sample_fwd"] = times({"qrf": smoke.phase_hat_kernel()})
        out["hat_sample_bwd"] = times(smoke.phase_hat_bwd_kernel())
        out["hat_sample_sparse"] = times(smoke.phase_hat_sparse_kernel())
    if "gather" in phases:
        out["corner_gather_fwd"] = times(
            {"enc": smoke.phase_corner_gather_kernel()})
    if "bottleneck" in phases:
        out["fused_bottleneck"] = times(
            {"serve": smoke.phase_fused_bottleneck_kernel()})
    if "lapjv" in phases:
        from dfvod_tpu_torch.ops import lapjv
        if not hasattr(lapjv, "lapjv_plan"):
            # a tree older than the kernel's plans: one block a problem
            lapjv.lapjv_plan = lambda P, Q, T: None
            smoke.plan_text = lambda plan: "one block a problem (no plan)"
        out["lapjv"] = times(smoke.phase_lapjv_kernel())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
