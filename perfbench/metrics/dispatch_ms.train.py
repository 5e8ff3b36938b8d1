"""Host ms from the call to the return of ``train_step``, before the loss
is read to the host: the host's share of a step. Mean over the traced
window's steps."""


def read(ctx):
    d = (ctx.spans or {}).get("dispatch")
    return 1e3 * sum(d) / len(d) if d else None
