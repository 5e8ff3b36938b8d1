"""Host ms from the call to the return of ``Server.__call__``, before the
answer is read (no sync): the host's share of a request. Mean over the
traced window's requests."""


def read(ctx):
    d = (ctx.spans or {}).get("dispatch")
    return 1e3 * sum(d) / len(d) if d else None
