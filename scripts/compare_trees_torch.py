"""Hold two checkouts of the PyTorch/CUDA port against each other end to
end on one NVIDIA GPU, in turns: each tree's own ``chip_smoke.py`` runs
its single-frame serve phase (B=8 608x800 bf16), its seeded
``LateFusion_bf16.sh`` train phase and its data/CLI phase (three recipes
through the CLI), each tree in a process of its own.

    python3 scripts/compare_trees_torch.py PARENT_DIR CHANGE_DIR \\
        [--phases serve,train,cli] [--rounds 1] \\
        [--log chiprun_out/compare_trees.log]

PARENT_DIR and CHANGE_DIR hold the two trees (``git archive`` of each,
unpacked under a git-ignored directory such as ``.scratch/``); each round
runs them in the order parent, change, change, parent. Each run prints one
JSON line: serve ms per batch, train ms per step, the CLI's ms per step
and the share of each epoch the loop waited for the loader (the phases
asked for). The last line is the card's name and power limit. Every run's
full output goes to ``--log``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
phases = sys.argv[1].split(",")
c.build_kernels(("msda_fwd", "msda_bwd", "hat_sample_fwd",
                 "hat_sample_bwd"))
out = {}
if "serve" in phases:
    out["serve_ms"] = c.phase_serve()[0]["ms_per_batch"]
    c.free_card()
if "train" in phases:
    out["train_ms"] = c.phase_train()["ms_per_step"]
    c.free_card()
if "cli" in phases:
    cli = c.phase_data_cli()
    out["cli"] = {k: v["ms_per_step"] for k, v in cli.items()
                  if isinstance(v, dict)}
    out["waited"] = {k: v["loader_waited_share"] for k, v in cli.items()
                     if isinstance(v, dict)}
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--phases", default="serve,train,cli")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--log", default=os.path.join(REPO, "chiprun_out",
                                                  "compare_trees.log"))
    args = ap.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    rc = 0
    order = (args.parent, args.change, args.change, args.parent)
    for tree in order * args.rounds:
        proc = subprocess.run([sys.executable, "-c", RUN, args.phases],
                              cwd=tree, capture_output=True, text=True)
        with open(args.log, "a") as f:
            f.write(f"===== {tree} rc {proc.returncode}\n{proc.stdout}\n"
                    f"{proc.stderr[-3000:]}\n")
        res = [ln for ln in proc.stdout.splitlines()
               if ln.startswith("RESULT ")]
        rc |= proc.returncode or not res
        print(json.dumps({"tree": tree, "rc": proc.returncode,
                          **(json.loads(res[-1][7:]) if res else {})}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
