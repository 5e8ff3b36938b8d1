"""Readings of the program's own spans and counters in a traced run.

While a profiler records, the port opens a ``record_function`` range
``dfvod.<span>`` at each layer boundary and counts the device syncs under
each innermost span as ``sync.<span>`` (``dfvod_tpu_torch/utils/trace.py``).
A ``Profile``'s host events hold those ranges beside the CUDA runtime
calls, on the profiler's clock. Against a port without those spans every
reading here is None, and the metric is left out of the result line.
"""
from __future__ import annotations

import bisect

PREFIX = "dfvod."
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def is_launch(name):
    """A kernel launch through the CUDA runtime API (``cudaLaunch*``) or
    the lower-level ``cuLaunch*``, or a graph's; not a host function's."""
    if name == "cudaGraphLaunch":
        return True
    return (name.startswith(("cudaLaunch", "cuLaunch"))
            and "HostFunc" not in name)


def ranges(profile, span):
    """(start_us, end_us) of every range of ``span``, in order."""
    name = PREFIX + span
    return sorted((a, b) for n, a, b in profile.host if n == name)


def host_ms(ctx, span):
    """Host ms a call inside ``span``."""
    p = ctx.profile
    rs = ranges(p, span) if p is not None else []
    return sum(b - a for a, b in rs) * 1e-3 / p.calls if rs else None


def runtime_calls(ctx, root, pred):
    """The host events (name, start_us, end_us) whose name satisfies
    ``pred`` and that start inside a range of the root span ``root``, on
    any thread (the backward's launches come from autograd's)."""
    p = ctx.profile
    rs = ranges(p, root) if p is not None else []
    if not rs:
        return None
    starts = [a for a, _ in rs]
    out = []
    for n, a, b in p.host:
        if pred(n):
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a <= rs[i][1]:
                out.append((n, a, b))
    return out


def launches(ctx, root):
    """Kernel launches a call inside ``root``."""
    calls = runtime_calls(ctx, root, is_launch)
    return None if calls is None else len(calls) / ctx.profile.calls


def sync_wait_ms(ctx, root):
    """Host ms a call inside ``root`` spent in the runtime's sync calls."""
    calls = runtime_calls(ctx, root, lambda n: n in SYNC_CALLS)
    if calls is None:
        return None
    return sum(b - a for _, a, b in calls) * 1e-3 / ctx.profile.calls


def syncs(ctx, root):
    """Device syncs a call that the program counted (its ``sync.*``
    counters grow only while a profiler records, so over the stretch)."""
    p = ctx.profile
    if p is None or not ranges(p, root):
        return None
    try:
        from dfvod_tpu_torch.utils.trace import counters
    except ImportError:
        return None
    return sum(v for k, v in counters().items()
               if k.startswith("sync.")) / p.calls
