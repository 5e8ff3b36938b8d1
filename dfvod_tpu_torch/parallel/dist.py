"""Process groups, row sharding and the collectives of data parallelism
and clip-parallel serving (counterpart of ``dfvod_tpu/parallel/mesh.py``).

The JAX package runs one program over a ``('clip', 'data')`` mesh and lets
XLA insert the collectives. The port runs one process per card, as the
reference does (``util/misc.py:441-479``): ``init_distributed`` joins a
``torch.distributed`` group (NCCL for CUDA, gloo for the CPU, unless the
caller names a backend), each process takes its contiguous rows of the
global batch (``shard_rows``, the counterpart of ``shard_batch``), and the
helpers below do by hand what XLA does: all-reduce (``reduce_mean``, the
reference's ``reduce_dict``) and the gather of rows in rank order, forward
only (``all_gather_rows``, serving) or with a gradient (``gather_rows``,
clip-parallel training, whose backward is a reduce-scatter).

Without a process group every helper is the one-process identity: rank 0
of a world of 1, no collective.

Gloo implements only all-reduce and broadcast on CUDA tensors. So where a
gloo group is handed CUDA tensors (two processes sharing one card, which
NCCL refuses), ``all_gather_rows`` moves the rows through host memory;
the choice is made from the group's backend before any collective runs.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from dfvod_tpu_torch.utils.device import resolve_device

# torchrun's environment (``torch.distributed.run``)
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank(group=None) -> int:
    """This process's rank in ``group`` (default: every process); 0
    without a process group."""
    return dist.get_rank(group) if initialized() else 0


def world(group=None) -> int:
    """The number of processes in ``group``; 1 without a process group."""
    return dist.get_world_size(group) if initialized() else 1


def is_main_process() -> bool:
    return rank() == 0


def collective_device(group=None) -> torch.device:
    """Where a tensor made for a collective of ``group`` lives: this
    process's card under NCCL, the host under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier():
    """Wait for every process; nothing to wait for with one."""
    if world() > 1:
        dist.barrier()


def under_torchrun() -> bool:
    """Whether torchrun's variables say this process is one rank of a
    launched group."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def init_distributed(rank: Optional[int] = None,
                     world_size: Optional[int] = None, *,
                     local_rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     init_method: Optional[str] = None, device=None,
                     timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group and return this process's device.

    Rank, world size and local rank come from the arguments, else from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and
    ``MASTER_ADDR`` / ``MASTER_PORT`` for the default ``env://``
    rendezvous). ``init_method`` may name another rendezvous, such as
    ``file://PATH``. ``device``: the card unless the caller passes one;
    on the card, ``cuda:<local_rank>``. ``backend``: NCCL on the card and
    gloo on the CPU unless named. ``timeout_s`` bounds the rendezvous and
    every collective (torch's default without it). A group that cannot
    form raises; nothing falls back to one process."""
    if rank is None or world_size is None:
        missing = [v for v in TORCHRUN_VARS[:3] if v not in os.environ]
        if missing:
            raise ValueError(
                "init_distributed: pass rank and world_size, or launch "
                f"with torchrun, which sets {', '.join(TORCHRUN_VARS)} "
                f"({', '.join(missing)} unset)")
        rank, world_size = int(os.environ["RANK"]), int(
            os.environ["WORLD_SIZE"])
        if local_rank is None:
            local_rank = int(os.environ["LOCAL_RANK"])
    device = resolve_device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else (
            local_rank if local_rank is not None else rank)
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kw)
    return device


def check_divisible(n: int, world_size: int):
    """Raise unless ``n`` rows split evenly over ``world_size`` processes
    (the JAX package's sharding refuses the same, ``shard_batch`` /
    ``clip_batch_sharding``)."""
    if n % world_size:
        raise ValueError(
            f"{n} rows over {world_size} processes: the global size of "
            f"dimension 0 should be divisible by {world_size}, but it is "
            f"equal to {n}")


def shard_rows(x, rank: int, world_size: int):
    """This rank's contiguous rows of ``x`` (a tensor or an array): rows
    ``[rank * n / world, (rank + 1) * n / world)``. Raises unless the rows
    divide evenly."""
    n = x.shape[0]
    check_divisible(n, world_size)
    per = n // world_size
    return x[rank * per:(rank + 1) * per]


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along rows in rank order (each rank
    gives as many rows). Forward only: no gradient flows back."""
    n = world(group)
    if n == 1:
        return x
    x = x.contiguous()
    if x.is_cuda and dist.get_backend(group) == "gloo":
        # gloo has no all-gather of CUDA tensors: gather the bytes on the
        # host, so any dtype crosses
        raw = x.cpu().view(torch.uint8)
        parts = [torch.empty_like(raw) for _ in range(n)]
        dist.all_gather(parts, raw, group=group)
        return torch.cat(parts).view(x.dtype).to(x.device)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def reduce_scatter_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over every rank of ``group``, and this rank's rows of
    the sum (the rows split as ``shard_rows`` splits them): a
    reduce-scatter under NCCL; under gloo, which has none, an all-reduce
    and a slice (gloo's all-reduce takes CUDA tensors too)."""
    n = world(group)
    if n == 1:
        return x
    check_divisible(x.shape[0], n)
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out
    # gloo sums f32 and f64; other float types go through f32
    y = x.clone() if x.dtype in (torch.float32, torch.float64) else x.float()
    dist.all_reduce(y, group=group)
    return shard_rows(y, rank(group), n).to(x.dtype)


class _GatherRows(torch.autograd.Function):
    """``all_gather_rows`` with a gradient. Every rank of the group reads
    the gathered rows, so the gradient reaching a rank's rows is the sum
    of every rank's output gradient at those rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_rows(grad, ctx.group), None


def gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along rows in rank order, as
    ``all_gather_rows``, differentiable: the backward sums the output
    gradient over the group and returns this rank's rows (clip-parallel
    training, where each rank of a clip group runs the temporal heads on
    the gathered trunk outputs)."""
    return _GatherRows.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; its gradient is the sum of the ranks' output
    gradients, as each rank's output is the same sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over every rank of ``group``, differentiable: the
    gradient reaching each rank's ``x`` is the sum of every rank's gradient
    of the result."""
    return _AllReduceSum.apply(x, group)


def reduce_mean(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar's mean over every process, in one all-reduce (the
    reference's ``reduce_dict(average=True)``, ``util/misc.py:167-191``),
    as f32. With one process the values come back as they are."""
    n = world()
    if n == 1 or not values:
        return values
    keys = sorted(values)
    stacked = torch.stack([values[k].detach().float().reshape(())
                           for k in keys])
    dist.all_reduce(stacked)
    return dict(zip(keys, stacked / n))


def make_groups(clip: int):
    """The ``('clip', 'data')`` layout of ``make_mesh`` (``mesh.py:17-33``):
    the ranks reshaped to ``(clip, world // clip)``. Returns this rank's
    (clip group, data group): the ranks of its column (one per clip slot)
    and of its row. Every process must call it, in the same order."""
    n = world()
    c, d = clip_layout(rank(), n, clip)
    grid = np.arange(n).reshape(clip, n // clip)
    clip_groups = [dist.new_group(grid[:, j].tolist())
                   for j in range(n // clip)]
    data_groups = [dist.new_group(grid[i].tolist()) for i in range(clip)]
    return clip_groups[d], data_groups[c]


def clip_layout(rank_: int, world_size: int, clip: int):
    """(c, d) of ``rank_`` on the ``(clip, world // clip)`` layout of
    ``make_groups``: rank = c * D + d with D = world // clip. Its clip
    group is column d (the ranks that share a clip's rows), and c is its
    rank within that group."""
    if clip < 1 or world_size % clip:
        raise ValueError(f"{world_size} devices not divisible by "
                         f"clip={clip}")
    return divmod(rank_, world_size // clip)


def clip_group_rows(x, clip: int, rank_: Optional[int] = None,
                    world_size: Optional[int] = None):
    """The rows of the global batch ``x`` that this rank passes to a
    clip-parallel train step: its clip group d's contiguous share,
    ``shard_rows(x, d, D)``, which every rank of the group passes alike
    (the model then runs its c-th share of them through the trunk). Not
    ``shard_rows(x, rank, world)``: a clip group holds whole clips.
    ``rank_`` / ``world_size`` default to this process's."""
    rank_ = rank() if rank_ is None else rank_
    world_size = world() if world_size is None else world_size
    _, d = clip_layout(rank_, world_size, clip)
    return shard_rows(x, d, world_size // clip)


def local_devices(n: int, device=None):
    """The devices of ``n`` processes on this host, one per card: ``n``
    counts local devices, 0 meaning all (``--num_devices``, as the JAX
    package reads it). On the card (the default) ``cuda:0 .. cuda:n-1``,
    raising when fewer are visible; on the CPU (``device="cpu"``) ``n``
    CPU processes, one for 0."""
    if n < 0:
        raise ValueError(f"--num_devices {n}: must be 0 (all) or more")
    if resolve_device(device).type != "cuda":
        return ["cpu"] * max(n, 1)
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(f"--num_devices {n}: only {visible} CUDA devices "
                         "are visible")
    return [f"cuda:{i}" for i in range(n or visible)]


def _run_rank(index, fn, devices, init_file, backend, timeout_s, results,
              args):
    device = init_distributed(index, len(devices), local_rank=index,
                              init_method="file://" + init_file,
                              backend=backend, device=devices[index],
                              timeout_s=timeout_s)
    try:
        out = fn(device, *args)
        if index == 0:
            # plain pickle: a queue would pass tensors as shared memory
            # that dies with this process
            results.put(pickle.dumps(out))
    finally:
        dist.destroy_process_group()


def spawn(fn, devices, *args, backend: Optional[str] = None,
          timeout_s: Optional[float] = None):
    """Run ``fn(device, *args)`` in one new process per entry of
    ``devices`` (the ``spawn`` start method), each a rank of one group that
    meets through a file in a fresh temporary directory, on its device
    (``local_devices`` gives one per card). ``fn`` must be importable by
    name and its arguments picklable. Returns rank 0's result.
    ``timeout_s`` bounds the rendezvous and each collective, and the whole
    run: past it every process is terminated and ``TimeoutError`` raised.
    A process that raises or exits non-zero raises here
    (``torch.multiprocessing.ProcessRaisedException`` /
    ``ProcessExitedException``, with its exit code) after the others are
    terminated."""
    import torch.multiprocessing as mp
    devices = [str(d) for d in devices]
    results = mp.get_context("spawn").SimpleQueue()
    out = None
    with tempfile.TemporaryDirectory(prefix="dfvod_dist_") as tmp:
        procs = mp.start_processes(
            _run_rank, args=(fn, devices, os.path.join(tmp, "init"),
                             backend, timeout_s, results, args),
            nprocs=len(devices), join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.time() + timeout_s
        while True:
            # drain before joining: rank 0 blocks on a full pipe
            if not results.empty():
                out = pickle.loads(results.get())
            if procs.join(timeout=1.0):
                break
            if deadline is not None and time.time() > deadline:
                for p in procs.processes:
                    if p.is_alive():
                        p.terminate()
                for p in procs.processes:
                    p.join(10)
                raise TimeoutError(f"{len(devices)} processes still "
                                   f"running after {timeout_s} s; "
                                   "terminated")
    if not results.empty():
        out = pickle.loads(results.get())
    return out
