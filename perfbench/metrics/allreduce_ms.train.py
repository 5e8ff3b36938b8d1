"""Device ms a step of the NCCL kernels in the profiler stretch, on the
card of rank 0 (the harness's process): the gradient all-reduce's
buckets, the DFormer BatchNorms' statistics forward and backward, the
criterion's box count and the metrics' mean. A kernel's time includes its
wait for the slowest rank. None where the stretch has no NCCL kernel."""


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    us = p.kernel_us(lambda n: "nccl" in n.lower())
    return us * 1e-3 / p.calls if us > 0 else None
