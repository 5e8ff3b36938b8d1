"""K2's share of its roofline: the least time of the step's
deformable-attention backwards at the cell's shapes (counted in
``perfbench/harness/flops.py``) over the device time of the ``msda_bwd``
kernels a step in the profiler stretch. In a cell of several cards the
kernels are this process's card's, and the bound that card's share: the
call's over the cards."""
from perfbench.harness.flops import msda_bwd_bound_s


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    us = p.kernel_us(lambda n: "msda_bwd" in n)
    if us <= 0:
        return None
    bound = msda_bwd_bound_s(ctx.counts["msda"]) / ctx.chips
    return 100.0 * bound / (us * 1e-6 / p.calls)
