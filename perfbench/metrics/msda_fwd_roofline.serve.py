"""K1's share of its roofline: the least time of the request's
deformable-attention forwards at the cell's shapes (bytes at HBM
bandwidth or operations at the f32 peak, whichever is longer, counted in
``perfbench/harness/flops.py``) over the device time of the ``msda_fwd``
kernels a request in the profiler stretch. In a cell of several cards
the kernels are this process's card's, and the bound that card's share:
the call's over the cards."""
from perfbench.harness.flops import msda_fwd_bound_s


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    us = p.kernel_us(lambda n: "msda_fwd" in n)
    if us <= 0:
        return None
    bound = msda_fwd_bound_s(ctx.counts["msda"]) / ctx.chips
    return 100.0 * bound / (us * 1e-6 / p.calls)
