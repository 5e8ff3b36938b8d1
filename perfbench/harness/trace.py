"""Device-time readings of a traced run: CUDA event pairs from forward
hooks, and a ``torch.profiler`` stretch read into device intervals.

``hook_events`` and ``is_device_activity`` are copies of
``scripts/profile_torch_serving.py``'s. The busy time is the union of the
device intervals, so that kernels of two streams that overlap (NCCL's
beside the compute stream) count once; the gap between a hook's two events
includes any idle time inside it.
"""
from __future__ import annotations

import collections
import time

import torch


def hook_events(groups):
    """Forward hooks recording a CUDA event pair per module call.
    groups: {name: [module, ...]}. Returns (pairs, handles): pairs[name]
    is a list of [start, end] events, one per call."""
    pairs = collections.defaultdict(list)
    handles = []
    for name, mods in groups.items():
        for m in mods:
            def pre(mod, args, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                pairs[name].append([ev, None])

            def post(mod, args, out, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                pairs[name][-1][1] = ev
            handles += [m.register_forward_pre_hook(pre),
                        m.register_forward_hook(post)]
    return pairs, handles


def span_events(start_mod, end_mod, name):
    """One event pair per call, from the end of ``start_mod``'s forward to
    the end of ``end_mod``'s: the work between them. The list exists
    from the start, so that a caller may merge it into another dict."""
    pairs = {name: []}

    def start(mod, args, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pairs[name].append([ev, None])

    def end(mod, args, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pairs[name][-1][1] = ev
    return pairs, [start_mod.register_forward_hook(start),
                   end_mod.register_forward_hook(end)]


def pair_ms(pairs):
    """{name: [ms of each call]}, after a synchronize."""
    return {k: [a.elapsed_time(b) for a, b in v if b is not None]
            for k, v in pairs.items()}


def is_device_activity(evt):
    """A kernel or copy on the card, not a CPU op and not a range
    (``record_function``, an autograd Function, ``Optimizer.step``) that
    the profiler mirrors onto the device timeline."""
    from torch.autograd import DeviceType
    return (getattr(evt, "device_type", None) == DeviceType.CUDA
            and not getattr(evt, "is_user_annotation", False))


class Profile:
    """The device intervals and host ops of one profiled stretch of
    ``calls`` whole requests or steps."""

    def __init__(self, events, calls, wall_s):
        self.calls = calls
        self.wall_s = wall_s
        self.kernels = []           # (name, start_us, end_us)
        self.host = []              # (name, start_us, end_us)
        from torch.autograd import DeviceType
        for e in events:
            tr = e.time_range
            if is_device_activity(e):
                if tr.end > tr.start:
                    self.kernels.append((e.name, tr.start, tr.end))
            elif getattr(e, "device_type", None) == DeviceType.CPU:
                self.host.append((e.name, tr.start, tr.end))
        if not self.kernels:
            raise RuntimeError("the profiler recorded no device activity")
        self.kernels.sort(key=lambda k: k[1])
        starts = [h[1] for h in self.host if h[0].startswith("bench.")]
        ends = [h[2] for h in self.host if h[0].startswith("bench.")]
        # the traced window: from the first marked call's start to the
        # later of its last end and the last device interval
        self.t0 = min(starts + [self.kernels[0][1]])
        self.t1 = max(ends + [max(k[2] for k in self.kernels)])
        self.window_us = self.t1 - self.t0
        self.intervals = self._union()
        self.busy_us = sum(b - a for a, b in self.intervals)

    def _union(self):
        out = []
        for _, a, b in self.kernels:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernel_us(self, pred):
        """Summed device time of the kernels whose name satisfies
        ``pred``."""
        return sum(b - a for n, a, b in self.kernels if pred(n))

    def exposed_us(self, pred):
        """Device time of the kernels whose name satisfies ``pred`` that
        no other kernel or copy covers: the union of their intervals less
        its overlap with the union of the others'."""
        def union(ivs):
            out = []
            for a, b in sorted(ivs):
                if out and a <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], b)
                else:
                    out.append([a, b])
            return out
        mine = union((a, b) for n, a, b in self.kernels if pred(n))
        rest = union((a, b) for n, a, b in self.kernels if not pred(n))
        covered, j = 0.0, 0
        for a, b in mine:
            while j < len(rest) and rest[j][1] <= a:
                j += 1
            k = j
            while k < len(rest) and rest[k][0] < b:
                covered += min(b, rest[k][1]) - max(a, rest[k][0])
                k += 1
        return sum(b - a for a, b in mine) - covered

    def gaps(self):
        """(start_us, end_us) of every idle stretch inside the window."""
        out, t = [], self.t0
        for a, b in self.intervals:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_activity(self, a, b):
        """What the host did during [a, b]: the marked call covering the
        gap's middle and the shortest host op that covers it."""
        mid = 0.5 * (a + b)
        covering = [h for h in self.host if h[1] <= mid <= h[2]]
        marks = [h for h in covering if h[0].startswith("bench.")]
        ops = [h for h in covering if not h[0].startswith("bench.")]
        mark = min(marks, key=lambda h: h[2] - h[1])[0] if marks else "idle"
        op = min(ops, key=lambda h: h[2] - h[1])[0] if ops else "-"
        return f"{mark} / {op}"

    def breakdown(self, top=10):
        """The device ops that took the most time and the longest idle
        gaps named by what the host did, each in seconds."""
        per_op = collections.Counter()
        for n, a, b in self.kernels:
            per_op[short_name(n)] += (b - a) * 1e-6
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in per_op.most_common(top)],
                "idle_gaps": [[self.host_activity(a, b), (b - a) * 1e-6]
                              for a, b in gaps]}


def short_name(kernel):
    """A kernel's name without its argument list, return type and the
    ``at::native::`` namespace: ``elementwise_kernel<128, 4,
    gpu_kernel_impl_nocast<CUDAFunctor_add<c10::BFloat16> >``."""
    if kernel.startswith("Memcpy") or kernel.startswith("Memset"):
        return kernel
    name = kernel.replace("(anonymous namespace)::", "").split("(", 1)[0]
    name = name.replace("at::native::", "")
    return name[5:] if name.startswith("void ") else name


def profile_calls(fn, min_calls, min_seconds):
    """Run ``fn()`` (one whole request or step, ending in a host read)
    under ``torch.profiler`` for at least ``min_calls`` calls and
    ``min_seconds``. Returns a ``Profile``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        calls = 0
        while calls < min_calls or time.perf_counter() - t0 < min_seconds:
            fn()
            calls += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return Profile(prof.events(), calls, wall)
