"""Run a training recipe of ``configs/training/`` through the PyTorch/CUDA
port's CLI on one NVIDIA GPU, and report what a training user pays and
gets: ms per step, the share of each epoch the loop waited for the loader,
and the final COCO stats.

    python3 scripts/run_recipe_torch.py Synth_LateFusion.sh \\
        --env COCO_PATH=datasets/synth_rgbd --out /tmp/synth \\
        --summary output/synth30_summary [-- extra CLI arguments]

The recipe's argument list is bash's own expansion of the ``.sh`` file
(``chip_smoke.recipe_argv``; ``--env`` sets its variables), with
``--output_dir`` set to ``--out`` and the extra arguments after ``--``
appended (``--seed 7`` ...). The run is ``dfvod_tpu_torch.cli.main.main``
(or ``main_multi``) in this process, on the card. Every train step is
timed on the host clock to a ``torch.cuda.synchronize`` with its kernel
launches (``chip_smoke.CliProbe``). The run's ``log.txt`` and a
``summary.json`` go to ``--summary``; the checkpoints stay under ``--out``.
Prints the summary as the last line.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    argv = sys.argv[1:]
    extra = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("recipe", help="a file name under configs/training/")
    p.add_argument("--env", action="append", default=[],
                   help="VAR=value for the recipe's variables")
    p.add_argument("--out", required=True, help="the CLI's --output_dir")
    p.add_argument("--summary", required=True,
                   help="directory for log.txt and summary.json")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dfvod_tpu_torch.cli import main as cli

    env = dict(kv.split("=", 1) for kv in args.env)
    module, cli_argv = cs.recipe_argv(args.recipe, **env)
    cli_argv = [*cli_argv, "--output_dir", args.out, *extra]
    print("python -m", module, " ".join(cli_argv), flush=True)
    t0 = time.perf_counter()
    with cs.CliProbe() as probe:
        stats = cli.main(cli_argv, video=module.endswith("main_multi"))
    wall = time.perf_counter() - t0

    os.makedirs(args.summary, exist_ok=True)
    log = os.path.join(args.out, "log.txt")
    shutil.copy(log, os.path.join(args.summary, "log.txt"))
    with open(log) as f:
        epochs = [ln for ln in map(json.loads, f) if "epoch" in ln]
    waits = [ln["timing"]["loader_s"]["wait"] / ln["timing"]["epoch_s"]
             for ln in epochs]
    ms = sorted(m for m, _ in probe.steps[2:])
    summary = {
        "card": cs.card_line(), "recipe": args.recipe, "env": env,
        "extra": extra, "stats": stats, "wall_s": wall,
        "steps": len(probe.steps), "ms_per_step_median": ms[len(ms) // 2],
        "ms_per_step_p90": ms[int(0.9 * len(ms))],
        "waited_share_mean": sum(waits) / len(waits),
        "waited_share_max": max(waits),
        "launches_first_step": probe.steps[0][1],
        "final_train_loss": epochs[-1]["train_loss"]}
    with open(os.path.join(args.summary, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
