"""A loop of ranks: one data-parallel group of ``world`` processes, one a
card, that the harness's own process leads as rank 0.

Rank 0 runs in the harness's process, so that the profiler stretch, the
hooks and the program's spans read it as they read a one-card cell.
``Group`` starts ranks 1..world-1 as processes (the ``spawn`` start
method) on their cards, and every rank joins the process group through
the port's ``parallel.init_distributed`` (NCCL on the cards, gloo on the
CPU), as the port's CLI forms its ranks under ``--num_devices``. Beside
it every rank joins a gloo group for commands: rank 0 sends each command
as one broadcast of ``COMMAND_LEN`` int64 on the host, ``(op, a, b)``,
and the others wait for it. What an op means is the loop's: a loop names
a function ``rank_main(rank, world, device, channel, *args)`` that each
other rank runs until its ``channel.recv()`` returns ``STOP``.

The group meets through a file in a temporary directory under ``TMPDIR``.
``close`` sends ``STOP``, waits for every process and leaves the group;
a group that is dropped unclosed ends its processes.
"""
from __future__ import annotations

import datetime
import shutil
import tempfile
import weakref

import torch
import torch.distributed as dist

COMMAND_LEN = 3
STOP = 0
# the rendezvous, and every collective, fail after this many seconds
TIMEOUT_S = 600.0


def devices(world, device):
    """The device of each rank: card r for rank r, or the CPU for all."""
    if torch.device(device).type == "cuda":
        return [f"cuda:{r}" for r in range(world)]
    return ["cpu"] * world


def _join(rank, world, device, init_method):
    from dfvod_tpu_torch import parallel
    dev = parallel.init_distributed(rank, world, local_rank=rank,
                                    init_method=init_method, device=device,
                                    timeout_s=TIMEOUT_S)
    ctl = dist.new_group(backend="gloo",
                         timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev, ctl


class Channel:
    """A rank's end of the command group."""

    def __init__(self, group):
        self.group = group

    def recv(self):
        cmd = torch.zeros(COMMAND_LEN, dtype=torch.int64)
        dist.broadcast(cmd, 0, group=self.group)
        return [int(x) for x in cmd]


def _child(rank, world, device, init_method, threads, target, args):
    """The body of rank ``rank``'s process: join the groups, run the loop's
    ``rank_main`` (``target`` = (checkout root, loop name)), leave."""
    from perfbench.harness import spec
    torch.set_num_threads(threads)
    dev, ctl = _join(rank, world, device, init_method)
    try:
        root, loop = target
        spec.loop_module(loop, root).rank_main(rank, world, dev,
                                               Channel(ctl), *args)
    finally:
        dist.destroy_process_group()


def _end(procs, tmp):
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
    shutil.rmtree(tmp, ignore_errors=True)


class Group:
    """Rank 0's side: start the other ranks (``target`` = (checkout root,
    loop name), each running that loop's ``rank_main`` with ``args``),
    and later, in ``join``, take this process into the group as rank 0.
    Between the two the caller may build what needs no group."""

    def __init__(self, world, device, target, args=()):
        import torch.multiprocessing as mp
        self.world = world
        self.devices = devices(world, device)
        self.tmp = tempfile.mkdtemp(prefix="perfbench_ranks_")
        self.init_method = "file://" + self.tmp + "/init"
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(
            target=_child, daemon=True,
            args=(r, world, self.devices[r], self.init_method,
                  torch.get_num_threads(), target, args))
            for r in range(1, world)]
        for p in self.procs:
            p.start()
        self._end = weakref.finalize(self, _end, self.procs, self.tmp)
        self.ctl = None
        self._pending = None
        self.device = torch.device(self.devices[0])

    def join(self):
        """Join the process group as rank 0; returns this rank's device."""
        self.device, self.ctl = _join(0, self.world, self.devices[0],
                                      self.init_method)
        return self.device

    def send(self, op, a=0, b=0):
        """Broadcast the command (op, a, b) to every other rank, without
        waiting for them to take it: a gloo broadcast ends when every rank
        has received, so this process waits only for the command before,
        which the others took a step ago."""
        self.wait()
        cmd = torch.tensor([op, a, b], dtype=torch.int64)
        self._pending = (dist.broadcast(cmd, 0, group=self.ctl,
                                        async_op=True), cmd)

    def wait(self):
        """Wait until every rank has taken the last command."""
        if self._pending is not None:
            self._pending[0].wait()
            self._pending = None

    def close(self, timeout_s=120.0):
        """``STOP`` to every rank, leave the group (with NCCL the ranks
        leave it together), wait for each process. Raises if a process
        does not end, or ends with an error."""
        try:
            self.send(STOP)
            self.wait()
        finally:
            dist.destroy_process_group()
        try:
            for p in self.procs:
                p.join(timeout_s)
            codes = [p.exitcode for p in self.procs]
        finally:
            self._end()
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks 1..{self.world - 1} ended with exit "
                               f"codes {codes}")
