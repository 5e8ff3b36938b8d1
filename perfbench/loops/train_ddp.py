"""Data-parallel training over the cell's cards, each step one global
batch of the mix's ``frames_per_request`` rows, and its check.

Every rank builds the port's train state as the port's CLI builds it
under ``--num_devices``: in the process group (``harness/ranks.py``),
``train/engine.py::create_train_state`` wraps the model in
``DistributedDataParallel`` and gives the DFormer BatchNorms the global
batch's statistics. Every rank draws the same weights from the seed,
makes the same pool from the seed, and steps on its own rows of each
global batch (``parallel.shard_rows``). Rank 0 is the harness's process:
set-up drives it through the first steps with the window's own call, and
the window and the profiler stretch run on it as in ``train.py``; before
each step it sends the others the batch's index (one broadcast of three
integers on the host), and after the window the command to compare their
states and to end.

The check runs after every other rank has ended. Exact: every rank's
floating state (parameters and buffers, the BatchNorms' running
statistics among them) equals rank 0's (``ranks_state_mismatch``, the
elements that differ). Against the reference's ``DataParallelStep`` over
the whole global batch, in the units and names of ``train.py``: the
first step's forward of every rank's rows, and rank 0's first gradients
and changes, which the all-reduce makes the global batch's.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from perfbench.harness import faults, inputs, ranks
from perfbench.loops import train
from perfbench.loops.serve import MEMORY_STRIDE

KIND = "train"
CHIPS = (4,)
# commands (op, a, b) from rank 0; ranks.STOP is 0
STEP, PLANT, EXCHANGE = 1, 2, 3


class Rank(train.Program):
    """One rank's train state. ``rows_of`` (whose rows it takes) and
    ``half`` (only the first half of them) are there for the planted
    faults."""

    def __init__(self, config, seed, device, ref, rank, world, join=None):
        self.rank, self.world = rank, world
        self.rows_of, self.half = rank, False
        self._rows = {}
        super().__init__(config, seed, device, ref, join)
        self.out1 = {}
        self._keep = self.model.register_forward_hook(self._keep_out1)

    def _keep_out1(self, mod, args, out):
        """The first step's forward of this rank's rows."""
        self.out1 = {k: out[k].detach().float()
                     for k in ("pred_logits", "pred_boxes")}
        self.out1["memory"] = out["_trunk"]["memory"][
            :, ::MEMORY_STRIDE].detach().float()
        self._keep.remove()

    def rows(self, index, batch):
        """This rank's rows of the global batch ``index``."""
        if index not in self._rows:
            from dfvod_tpu_torch.parallel import shard_rows
            b = {k: shard_rows(v, self.rows_of, self.world)
                 for k, v in batch.items()}
            if self.half:
                b = {k: v[:v.shape[0] // 2] for k, v in b.items()}
            self._rows[index] = b
        return self._rows[index]

    def step(self, index, batch):
        from dfvod_tpu_torch.train.engine import train_step
        return train_step(self.state, self.criterion,
                          self.rows(index, batch))


class Program(Rank):
    """Rank 0, in the harness's process: it starts the other ranks, and
    each call steps every rank on the global batch it is given (one of
    the pool's, by its index)."""

    def __init__(self, cell, seed, device):
        self.group = ranks.Group(cell.chips, device,
                                 (cell.root, cell.traffic["loop"]),
                                 (cell.config, cell.traffic, seed,
                                  cell.root))
        super().__init__(cell.config, seed, self.group.device,
                         cell.reference, 0, cell.chips,
                         join=self.group.join)
        self.index = {}
        self.send_s = []

    def __call__(self, batch):
        i = self.index[id(batch)]
        t = time.perf_counter()
        self.group.send(STEP, i)
        self.send_s.append(time.perf_counter() - t)
        return self.step(i, batch)

    def plant(self, name, on=None):
        """The rank fault ``name`` (``faults.RANK_FAULTS``) on the ranks
        ``on`` (all by default)."""
        names = sorted(faults.RANK_FAULTS)
        mask = sum(1 << r for r in (on if on is not None
                                    else range(self.world)))
        self.group.send(PLANT, names.index(name), mask)
        if mask & 1:
            faults.RANK_FAULTS[name](self)


def exchange(prog, ctl):
    """On every rank, in one order: how many elements of the ranks'
    floating state differ from rank 0's, and every rank's first forward
    and peak device memory (for rank 0; the others get the same)."""
    state = torch.cat([v.detach().float().flatten() for _, v in sorted(
        prog.model.state_dict().items()) if v.is_floating_point()])
    base = state.clone() if prog.rank == 0 else torch.empty_like(state)
    dist.broadcast(base, 0)
    differ = (state != base).sum().to(torch.float64).reshape(1)
    dist.all_reduce(differ)
    dev = state.device
    mine = {"out1": {k: v.cpu() for k, v in prog.out1.items()},
            "peak": (torch.cuda.max_memory_allocated(dev)
                     if dev.type == "cuda" else 0)}
    every = [None] * prog.world
    dist.all_gather_object(every, mine, group=ctl)
    return float(differ), every


def rank_main(rank, world, device, channel, config, traffic, seed, root):
    """Ranks 1.. in their processes: build, then follow rank 0's
    commands until it stops them."""
    from perfbench.harness import spec
    ref = spec.reference(config, root)
    # the train state first: rank 0's waits for every rank's in the DDP
    # wrapper's first broadcast
    prog = Rank(config, seed, device, ref, rank, world)
    pool = inputs.pool(traffic, seed, str(device), kind=KIND)
    names = sorted(faults.RANK_FAULTS)
    while True:
        op, a, b = channel.recv()
        if op == STEP:
            float(prog.step(a, pool[a])["loss"])
        elif op == PLANT:
            if b >> rank & 1:
                faults.RANK_FAULTS[names[a]](prog)
        elif op == EXCHANGE:
            exchange(prog, channel.group)
        elif op == ranks.STOP:
            return
        else:
            raise ValueError(f"rank {rank}: unknown command {op}")


def build(cell, seed, device):
    return Program(cell, seed, device)


def warm_up(prog, pool, traffic, seed):
    """The first ``check_steps`` steps on every rank, which the check
    follows."""
    prog.index = {id(b): i for i, b in enumerate(pool)}
    return train.first_steps(prog, pool, traffic["check_steps"])


trace_events = train.trace_events
window = train.window
traced_call = train.traced_call


def hand_over(prog, first, w):
    """Compare the ranks' states, gather their first forwards and peaks,
    and end the other ranks."""
    from perfbench.harness.cell import log
    prog.group.send(EXCHANGE)
    prog.group.wait()
    differ, every = exchange(prog, prog.group.ctl)
    prog.group.close()
    if prog.send_s:
        log(f"[ranks] {len(prog.send_s)} step commands, "
            f"{1e6 * sum(prog.send_s) / len(prog.send_s):.1f} us each "
            f"on rank 0's host")
    out1 = {k: torch.cat([e["out1"][k] for e in every])
            for k in every[0]["out1"]}
    return {**first, "out1": out1, "ranks_state_mismatch": differ,
            "memory_peak_bytes": max((e["peak"] for e in every[1:]),
                                     default=0)}


def check_numbers(cell, seed, pool, held, device):
    """The reference's first steps over the ranks' rows in f32 and with
    bf16 operands, the program's gaps to the f32 one in units of the
    bf16 one's, and the ranks' state mismatch."""
    from perfbench.harness.cell import free
    from perfbench.harness.lowprec import bf16
    n = cell.traffic["check_steps"]
    out1 = {k: v.to(device) for k, v in held["out1"].items()}
    ref = train.reference_steps(cell.config, seed, pool, n, device,
                                cell.reference, ranks=cell.chips)
    free(device != "cpu")
    emu = train.reference_steps(cell.config, seed, pool, n, device,
                                cell.reference, lowprec=bf16,
                                ranks=cell.chips)
    out = train.ratios({**held, "out1": out1}, emu, ref, cell.reference)
    out["ranks_state_mismatch"] = held["ranks_state_mismatch"]
    return out
