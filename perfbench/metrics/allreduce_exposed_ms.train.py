"""Device ms a step of the NCCL kernels' intervals that no other kernel
or copy on the card covers, in the profiler stretch on rank 0's card:
the all-reduce time that compute does not hide. None where the stretch
has no NCCL kernel."""


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    is_nccl = (lambda n: "nccl" in n.lower())
    if p.kernel_us(is_nccl) <= 0:
        return None
    return p.exposed_us(is_nccl) * 1e-3 / p.calls
