"""Exact linear sum assignment on the device (shortest augmenting path,
Jonker-Volgenant): the plain PyTorch version and the wrapper of the
hand-written CUDA kernel ``csrc/lapjv.cu``.

Counterpart of ``dfvod_tpu/models/matcher.py::hungarian_lapjv``, the JAX
package's default matcher: XLA ``while_loop``s vmapped over the batch, not
a Pallas kernel. Both versions here compute it phase for phase, so they
return the JAX function's index in every slot, invalid slots included:

- ``cost``  : ``(P, Q, T)`` f32, P problems of Q queries (columns) and T
              target slots (rows), already free of NaN and inf;
- ``valid`` : ``(P, T)`` bool; an invalid row's cost is 0 in every column;
- output    : ``(P, T)`` int64, the query of each target slot.

The T phases run in row order, invalid rows too (an augmenting path from
an invalid row can re-route a valid row on a tie). A phase is a Dijkstra
search over the columns: the reduced cost ``min_val + C[i] - u[i] - v``
in f32, left to right; the unscanned column of least distance, the lowest
index on ties; the dual updates; the augmentation back from the free
column found. Every phase ends within T + 1 steps (each step scans a new
column, and only the T rows own one); a problem whose search or
augmentation does not end there gets -1 in every slot, so the caller's
next gather fails instead of anything looping.

``lapjv`` takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises. The kernel's plan (``lapjv_plan``)
spreads a problem over C CTAs (a thread-block cluster when C > 1) of W
warps: a warp per problem up to 512 queries, a cluster for the two-stage
proposals (up to 131,072 queries). The counter ``lapjv``
(``utils/trace.py``) counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dfvod_tpu_torch.ops import build
from dfvod_tpu_torch.utils import trace

# what the C entry's negative codes mean
_REFUSALS = {
    -1: "a shape it does not take (it needs T <= Q, T <= 32767 and Q <= "
        "131,072: 32 columns a thread of 16 CTAs of 8 warps)",
    -2: "a T whose row state needs more shared memory than a block has "
        "(about 32 bytes a row)",
    -3: "a plan it has no kernel for (C in 1, 2, 4, 8, 16 CTAs; W in 1, 2, "
        "4, 8 warps; at most 16 columns a thread for a warp per problem, "
        "32 otherwise)",
    -4: "a cluster of C blocks that the card cannot place "
        "(cudaOccupancyMaxActiveClusters is 0)",
}
# lapjv_plan's fields, in the order the C entry writes them
_PLAN_FIELDS = ("C", "W", "columns_a_thread", "kernel_k", "rows_in_smem",
                "smem_bytes", "max_active_clusters", "scratch_bytes")


def _check_args(cost, valid):
    if cost.dim() != 3 or valid.dim() != 2 \
            or valid.shape != (cost.shape[0], cost.shape[2]):
        raise ValueError(f"expected cost (P, Q, T) and valid (P, T): "
                         f"{tuple(cost.shape)}, {tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, not {valid.dtype}")
    if valid.device != cost.device:
        raise ValueError(f"valid is on {valid.device}, cost on "
                         f"{cost.device}")
    _, Q, T = cost.shape
    if T > Q:
        raise ValueError(f"{T} target slots and {Q} queries: the assignment "
                         f"needs T <= Q")


def lapjv_plain(cost, valid):
    """All P problems at once, each step on (P, Q) tensors, with a mask of
    the problems whose search is still going (as ``vmap`` runs the JAX
    ``while_loop``: a finished problem's state stays as it is).
    ``lapjv_plain.steps`` holds the last call's Dijkstra steps of each
    problem, (P,): the serial work of the assignment.

    A row is taken with ``index_select`` and the argmin with ``argmin``:
    on the CPU, advanced indexing of a (P, T, Q) tensor and ``min(dim)``
    start a parallel region per call, which costs milliseconds on a busy
    machine, thousands of times per call."""
    P, Q, T = cost.shape
    dev = cost.device
    inf = float("inf")
    C = torch.where(valid[:, :, None], cost.transpose(1, 2).float(),
                    0.0).reshape(P * T, Q)              # row i of p: p * T + i
    ar = torch.arange(P, device=dev)
    row0 = ar * T
    u = torch.zeros((P, T), device=dev)
    v = torch.zeros((P, Q), device=dev)
    row4col = torch.full((P, Q), -1, dtype=torch.long, device=dev)
    col4row = torch.full((P, T), -1, dtype=torch.long, device=dev)
    failed = torch.zeros(P, dtype=torch.bool, device=dev)
    steps = torch.zeros(P, dtype=torch.long, device=dev)
    is_row = torch.arange(T, device=dev)[None]
    for cur in range(T):
        shortest = torch.full((P, Q), inf, device=dev)
        pred = torch.zeros((P, Q), dtype=torch.long, device=dev)
        sc = torch.zeros((P, Q), dtype=torch.bool, device=dev)
        sr = torch.zeros((P, T), dtype=torch.bool, device=dev)
        i = torch.full((P,), cur, dtype=torch.long, device=dev)
        min_val = torch.zeros(P, device=dev)
        sink = torch.full((P,), -1, dtype=torch.long, device=dev)
        active = ~failed
        for _ in range(T + 1):
            # a finished problem's row i is scanned already
            sr[ar, i] = True
            r = (min_val[:, None] + C.index_select(0, row0 + i)
                 - u[ar, i][:, None] - v)
            upd = (r < shortest) & ~sc & active[:, None]
            shortest = torch.where(upd, r, shortest)
            pred = torch.where(upd, i[:, None], pred)
            masked = shortest.masked_fill(sc, inf)
            j = masked.argmin(1)           # the lowest index on ties
            mv = masked.gather(1, j[:, None])[:, 0]
            owner = row4col[ar, j]
            sc[ar, j] |= active
            free = active & (owner < 0)
            sink = torch.where(free, j, sink)
            min_val = torch.where(active, mv, min_val)
            i = torch.where(active & ~free, owner, i)
            steps += active
            active = active & ~free
            if not bool(active.any()):
                break
        failed |= active
        # dual updates
        at_row = shortest.gather(1, col4row.clamp(min=0))
        u = u + torch.where(is_row == cur, min_val[:, None],
                            torch.where(sr, min_val[:, None] - at_row, 0.0))
        v = v - torch.where(sc, min_val[:, None] - shortest, 0.0)
        # augment along the alternating path back from the sink
        j = sink
        done = failed.clone()
        for _ in range(T + 1):
            jj = j.clamp(min=0)
            i = pred[ar, jj]
            row4col[ar, jj] = torch.where(done, row4col[ar, jj], i)
            j = col4row[ar, i]
            col4row[ar, i] = torch.where(done, j, jj)
            done |= i == cur
            if bool(done.all()):
                break
        failed |= ~done
    lapjv_plain.steps = steps
    return torch.where(failed[:, None], -1, col4row)


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("lapjv")
    lib.lapjv_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.lapjv_plan.restype = ctypes.c_int
    lib.lapjv.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                          + [ctypes.c_void_p])
    lib.lapjv.restype = ctypes.c_int
    lib.lapjv_error_string.argtypes = [ctypes.c_int]
    lib.lapjv_error_string.restype = ctypes.c_char_p
    return lib


def _raise_for(rc, P, Q, T, C, W):
    if rc < 0:
        raise ValueError(f"the lapjv kernel refused P = {P}, Q = {Q}, T = "
                         f"{T} (plan C = {C}, W = {W}; 0 = the default): "
                         f"{_REFUSALS.get(rc, f'code {rc}')}")
    if rc > 0:
        raise RuntimeError("lapjv launch failed: "
                           + _library().lapjv_error_string(rc).decode())


@functools.lru_cache(maxsize=None)
def _plan(device, P, Q, T, C, W):
    """The C entry's plan on CUDA device ``device`` (the current one), made
    once per shape: it queries the card and sets the kernel's attributes,
    host work that every train step would otherwise repeat."""
    plan = (ctypes.c_int64 * len(_PLAN_FIELDS))()
    rc = _library().lapjv_plan(P, Q, T, C, W, ctypes.addressof(plan))
    _raise_for(rc, P, Q, T, C, W)
    return dict(zip(_PLAN_FIELDS, map(int, plan)))


def lapjv_plan(P, Q, T, _cw=(0, 0)):
    """The kernel's plan for P problems of Q queries and T slots on the
    current CUDA device, as a dict: ``C`` CTAs and ``W`` warps a problem,
    the columns a thread and the kernel's K, the cost rows held in shared
    memory, its bytes a CTA, the clusters the card holds at once (0 for a
    warp per problem) and the scratch bytes. Raises where the C entry
    refuses. ``_cw`` forces (C, W), for ``chip_smoke.lapjv_plan_sweep``
    alone."""
    return dict(_plan(torch.cuda.current_device(), P, Q, T, *_cw))


def lapjv_cuda(cost, valid, _cw=(0, 0)):
    """Launch ``csrc/lapjv.cu`` on CUDA tensors under the default plan
    (``_cw`` forces (C, W), for ``chip_smoke.lapjv_plan_sweep`` alone); the
    scratch holds the valid cost rows that shared memory does not (the
    plan's ``scratch_bytes``)."""
    _check_args(cost, valid)
    P, Q, T = cost.shape
    if cost.device.type != "cuda":
        raise ValueError(f"lapjv_cuda takes CUDA tensors, not {cost.device}")
    if cost.dtype != torch.float32:
        raise TypeError(f"the lapjv kernel takes f32 costs, not {cost.dtype}")
    if not (cost.is_contiguous() and valid.is_contiguous()):
        raise ValueError("cost and valid must be contiguous")
    out = torch.empty((P, T), dtype=torch.long, device=cost.device)
    with torch.cuda.device(cost.device):
        pl = _plan(cost.device.index, P, Q, T, *_cw)
        scratch = torch.empty(pl["scratch_bytes"], dtype=torch.uint8,
                              device=cost.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().lapjv(
            cost.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), P, Q, T, pl["C"], pl["W"], pl["kernel_k"],
            pl["rows_in_smem"], pl["smem_bytes"], stream)
    _raise_for(rc, P, Q, T, pl["C"], pl["W"])
    trace.count("lapjv")
    return out


def lapjv(cost, valid):
    """The assignment ``(P, T)`` int64 of ``cost (P, Q, T)`` under
    ``valid (P, T)``: the plain version for CPU tensors, ``csrc/lapjv.cu``
    for CUDA tensors. Raises where T > Q, where the JAX loop would not
    end."""
    _check_args(cost, valid)
    if cost.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lapjv runs on cpu or cuda, not {cost.device}")
    P, _, T = cost.shape
    if P == 0 or T == 0:
        return torch.zeros((P, T), dtype=torch.long, device=cost.device)
    if cost.device.type == "cpu":
        return lapjv_plain(cost, valid)
    return lapjv_cuda(cost, valid)

lapjv_plain.steps = None
