"""Data parallelism across cards (one process per card, NCCL), for a host
with more than one GPU:

    python3 scripts/dp_multi_card.py [--cards N] [--out PATH] [-- CLI flags]

1. ``chip_smoke.phase_data_parallel`` with one rank per card over NCCL:
   the f32 LateFusion (DFormer) step on 3 rows per rank and the f32
   TransVOD++ step on a clip per rank against one process's step on the
   same global batch, the clip-parallel TransVOD++ serves against one
   process's forward, the evaluation merge against one process's stats;
   with 4 or more cards, clip-parallel TransVOD++ training as (C, D) =
   (2, 2) (``chip_smoke.phase_clip_parallel("g")``), one rank per card:
   the step against one process's, the ms per step per rank beside one
   process's on one card (the gather's backward is NCCL's
   reduce-scatter there);
2. throughput: the ``LateFusion_bf16.sh`` step (B=6 per process, bf16,
   608x800) in one process on ``cuda:0``, then on N ranks, each its own
   batches: ms per step per rank and the frames per second of all ranks
   against one card's;
3. the training CLI on ``Synth_LateFusion.sh``'s flags for 1 epoch with
   ``--num_devices N`` (spawned ranks) and under ``torchrun
   --nproc_per_node N``: wall seconds and the final stats, which must be
   finite; flags after ``--`` are appended to both runs.

Every time is printed beside the card line (``nvidia-smi``); the JSON of
all of it goes to ``--out`` (default: ``dp_multi_card.json`` in
``chip_smoke.py``'s output directory).
The script fails with fewer than N cards, and on any disagreement.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

THROUGHPUT_STEPS = 5


def throughput_steps(seed):
    """ms per ``LateFusion_bf16.sh`` step (B=6, bf16) on this process's
    card over ``THROUGHPUT_STEPS`` steps after a warm-up, its own batches
    from ``seed``; 13 K1 + 13 K2 + 1 LAPJV launches per step."""
    state, criterion = cs.fresh_state(cs.train_cfg())
    batches = [{k: v.to("cuda") for k, v in cs.train_batch(seed + i).items()}
               for i in range(1 + THROUGHPUT_STEPS)]
    want = cs.want_launches(msda_fwd=13, msda_bwd=13, lapjv=1)
    cs.timed_steps(state, criterion, batches[:1], want, "throughput warm-up")
    return cs.timed_steps(state, criterion, batches[1:], want, "throughput")


def throughput_rank(device):
    import torch.distributed as dist
    ms = throughput_steps(80 + 10 * dist.get_rank())
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, ms)
    return parts


def cli_args(extra, out_dir):
    """(the CLI's module, ``Synth_LateFusion.sh``'s flags for 1 epoch with
    ``extra`` and ``out_dir``)."""
    module, argv = cs.recipe_argv("Synth_LateFusion.sh",
                                  COCO_PATH=cs.SYNTH_RGBD)
    return module, [*argv, "--epochs", "1", *extra, "--output_dir", out_dir]


def check_cli_run(run, out_dir, stats):
    """One checkpoint (epoch 0) written, finite final stats."""
    from dfvod_tpu_torch.utils.checkpoint import saved_epochs
    cs.check(saved_epochs(out_dir) == [0],
             f"cli {run}: checkpoints {saved_epochs(out_dir)}")
    cs.check(set(stats) >= {"mAP", "mAP_50"} and all(
        math.isfinite(v) for v in stats.values()), f"cli {run}: {stats}")


def cli_spawned(n, extra, tmp):
    """``--num_devices n`` in this process: (wall s, final stats)."""
    from dfvod_tpu_torch.cli import main as cli
    out_dir = os.path.join(tmp, "spawned")
    _, argv = cli_args(extra, out_dir)
    t0 = time.perf_counter()
    stats = cli.main([*argv, "--num_devices", str(n)])
    wall = time.perf_counter() - t0
    check_cli_run("num_devices", out_dir, stats)
    return wall, stats


def cli_torchrun(n, extra, tmp):
    """``torchrun --nproc_per_node n``: (wall s, final stats)."""
    out_dir = os.path.join(tmp, "torchrun")
    module, argv = cli_args(extra, out_dir)
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(n), "-m", module, *argv], cwd=REPO,
        capture_output=True, text=True, timeout=1200)
    wall = time.perf_counter() - t0
    cs.check(p.returncode == 0, f"torchrun rc {p.returncode}:\n"
             f"{p.stderr[-4000:]}")
    with open(os.path.join(out_dir, "log.txt")) as f:
        stats = [json.loads(x) for x in f][-1]["eval"]
    check_cli_run("torchrun", out_dir, stats)
    return wall, stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=0,
                    help="ranks, one per card (0: every visible card)")
    ap.add_argument("--out", default=os.path.join(cs.CHIPRUN_OUT,
                                                  "dp_multi_card.json"))
    ap.add_argument("cli_flags", nargs="*",
                    help="flags appended to the CLI runs (after --)")
    a = ap.parse_args()
    from dfvod_tpu_torch import parallel
    devices = parallel.local_devices(a.cards)
    n = len(devices)
    cs.check(n > 1, f"{n} card: data parallelism across cards needs two")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"[dp-cards] {n} x {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    cs.build_kernels(("msda_fwd", "msda_bwd", "hat_sample_fwd",
                      "hat_sample_bwd", "lapjv"))
    # the loader's host libraries, before N ranks would each build them
    from dfvod_tpu_torch.ops import build
    for name in ("jpeg_decode", "preprocess"):
        build.build_host(name)
    res = {"cards": n, "card": card}
    res["phase"] = cs.phase_data_parallel(devices=devices, backend="nccl",
                                          world1=False)
    if n >= 4:
        res["clip_parallel"] = cs.phase_clip_parallel(
            "g", devices[:4], backend="nccl")
    else:
        print(f"[dp-cards] {n} cards: the (2, 2) clip-parallel step needs "
              "4, not run", flush=True)
    cs.free_card()
    one = throughput_steps(80)
    cs.free_card()
    ranks = parallel.spawn(throughput_rank, devices, timeout_s=900)
    fps_one, fps_n = 6 / (one / 1e3), sum(6 / (ms / 1e3) for ms in ranks)
    res["throughput"] = {"one_card_ms_per_step": one,
                         "ms_per_step_per_rank": ranks,
                         "one_card_frames_per_s": fps_one,
                         "frames_per_s": fps_n,
                         "scaling": fps_n / (n * fps_one)}
    print(f"[dp-cards] LateFusion_bf16 B=6 per process 608x800 bf16: one "
          f"card {one:.3f} ms per step ({fps_one:.1f} frames/s); {n} ranks "
          f"{', '.join(f'{ms:.3f}' for ms in ranks)} ms per step "
          f"({fps_n:.1f} frames/s, {100 * res['throughput']['scaling']:.1f}"
          f"% of {n} x one card); {card}", flush=True)
    with tempfile.TemporaryDirectory(prefix="dfvod_cli_") as tmp:
        res["cli"] = {run: dict(zip(("wall_s", "stats"), fn(
            n, a.cli_flags, tmp))) for run, fn in (
                ("num_devices", cli_spawned), ("torchrun", cli_torchrun))}
    for run, v in res["cli"].items():
        print(f"[dp-cards] cli {run} ({n} ranks, Synth_LateFusion.sh 1 "
              f"epoch): {v['wall_s']:.1f} s, mAP_50 "
              f"{v['stats']['mAP_50']:.4f}; {card}", flush=True)
    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(res, f)
    print(json.dumps({"dp_multi_card": {k: res[k] for k in (
        "cards", "card", "throughput", "clip_parallel") if k in res}}))


if __name__ == "__main__":
    main()
