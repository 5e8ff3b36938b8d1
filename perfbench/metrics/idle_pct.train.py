"""The share of the profiler stretch's wall time in which no kernel or
copy ran on the card (the union of the device intervals)."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_us <= 0:
        return None
    return 100.0 * (1.0 - p.busy_us / p.window_us)
