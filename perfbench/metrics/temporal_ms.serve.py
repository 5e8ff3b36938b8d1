"""Device ms a request in the TransVOD++ head: CUDA events from the end of
the trunk's forward (``detr``) to the end of the model's (QRF with
RoIAlign, the temporal query layers, decoders and heads)."""


def read(ctx):
    ms = ctx.events.get("temporal")
    return sum(ms) / ctx.calls if ms else None
