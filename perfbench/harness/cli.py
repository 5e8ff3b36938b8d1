"""``perfbench/run.py``'s arguments, its refusals and its last line."""
from __future__ import annotations

import argparse
import sys

import torch

from perfbench.harness import cell as cell_mod
from perfbench.harness import spec

HOST_THREADS = 4


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start=None):
    args = parse(argv)
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    chips = cell.loop.CHIPS
    if cell.chips not in chips:
        print(f"perfbench: {args.workload}: the loop "
              f"{cell.traffic['loop']!r} runs on {chips} cards, not "
              f"{cell.chips}", file=sys.stderr)
        return 2
    # one process, few host threads: the host paces these cells, and idle
    # worker threads spinning beside it make the window's pace vary
    torch.set_num_threads(HOST_THREADS)
    result = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                          device="cuda", t_start=t_start)
    found = cell_mod.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    cell_mod.report(result)
    return 0
