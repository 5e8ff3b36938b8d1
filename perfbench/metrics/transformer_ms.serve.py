"""Device ms a request in the transformer: CUDA events from forward hooks
on the LateFusion depth layer and the encoder and decoder layers, summed
per request."""


def read(ctx):
    ms = ctx.events.get("transformer")
    return sum(ms) / ctx.calls if ms else None
