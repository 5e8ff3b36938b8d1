"""Device ms a step of the matcher's LAPJV kernel, by name in the
profiler stretch."""


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    us = p.kernel_us(lambda n: "lapjv" in n)
    return us * 1e-3 / p.calls if us > 0 else None
