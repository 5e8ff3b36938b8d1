"""Device ms a request in the backbones (ResNet-50 and the DFormer depth
path): CUDA events from forward hooks on ``backbone`` and
``depth_backbone``, summed per request."""


def read(ctx):
    ms = ctx.events.get("backbone")
    return sum(ms) / ctx.calls if ms else None
