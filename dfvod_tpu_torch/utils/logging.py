"""Metric logging (the port's copy of ``dfvod_tpu/utils/logging.py``):
``SmoothedValue`` / ``MetricLogger`` (``util/misc.py:51-281`` of the
reference), the output directory's ``log.txt`` (JSON lines) and
``args.yaml``, and optional wandb.

Under data parallelism only the main process (rank 0) prints
(``setup_for_distributed``) and writes ``log.txt`` and ``args.yaml``;
``synchronize_between_processes`` sums the meters' counts and totals over
the ranks.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import torch

from dfvod_tpu_torch import parallel


class SmoothedValue:
    """Windowed median/avg tracker (``util/misc.py:51-122``)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} "
                 "({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Sum ``count`` and ``total`` over every process (the window
        stays this process's), so ``global_avg`` is the ranks' together."""
        if parallel.world() == 1:
            return
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=parallel.collective_device())
        torch.distributed.all_reduce(t)
        self.count, self.total = int(t[0].item()), float(t[1].item())

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg,
                               value=self.value)


class MetricLogger:
    """``util/misc.py:194-281``: dict of SmoothedValues + ``log_every``."""

    def __init__(self, delimiter: str = "  ", print_freq: int = 10):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}"
                                   for k, m in self.meters.items())

    def log_every(self, iterable, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % self.print_freq == 0 and n:
                eta = iter_time.global_avg * (n - i)
                eta_str = str(datetime.timedelta(seconds=int(eta)))
                print(f"{header} [{i}/{n}] eta: {eta_str} {self} "
                      f"time: {iter_time}")
            i += 1
            end = time.time()
        total = time.time() - start
        print(f"{header} Total time: "
              f"{str(datetime.timedelta(seconds=int(total)))} "
              f"({total / max(i, 1):.4f} s / it)")


def setup_for_distributed(is_master: bool):
    """Master-only printing (``util/misc.py:385-397``): a process that is
    not the master prints only lines forced with ``print(..., force=True)``.
    With one process, which is the master, print is left as it is."""
    import builtins
    if is_master:
        return
    builtin_print = builtins.print

    def print_(*args, **kwargs):
        if kwargs.pop("force", False):
            builtin_print(*args, **kwargs)

    builtins.print = print_


def dump_args(cfg, output_dir: str):
    """``args.yaml`` dump (``main.py:648-653``) — plain key: value lines,
    no yaml dependency. Written by the main process only."""
    if not output_dir or not parallel.is_main_process():
        return
    os.makedirs(output_dir, exist_ok=True)
    lines = []

    def emit(prefix, obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if dataclasses.is_dataclass(v):
                emit(f"{prefix}{f.name}.", v)
            else:
                lines.append(f"{prefix}{f.name}: {v!r}")

    emit("", cfg)
    with open(os.path.join(output_dir, "args.yaml"), "w") as f:
        f.write("\n".join(lines) + "\n")


def append_log(output_dir: str, stats: Dict):
    """JSON-lines ``log.txt`` per epoch (``main.py:623-625``), written by
    the main process only."""
    if not output_dir or not parallel.is_main_process():
        return
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "log.txt"), "a") as f:
        f.write(json.dumps(stats) + "\n")


class WandbLogger:
    """Optional wandb (``main.py:550-553``); silently off when wandb is
    unavailable or ``enabled=False``."""

    def __init__(self, enabled: bool, project: str = "dfvod_tpu",
                 config: Optional[dict] = None):
        self.run = None
        if not enabled:
            return
        try:
            import wandb
            self.run = wandb.init(project=project, config=config or {})
        except Exception as e:  # wandb missing or offline
            print(f"[wandb] disabled: {e}")

    def log(self, stats: Dict):
        if self.run is not None:
            self.run.log(stats)

    def finish(self):
        if self.run is not None:
            self.run.finish()
