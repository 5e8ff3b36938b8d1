"""Device ms a step in the optimizer: CUDA events from AdamW's step pre-
and post-hooks (the global-norm clip runs before it and is not in it)."""


def read(ctx):
    ms = ctx.events.get("optimizer")
    return sum(ms) / len(ms) if ms else None
