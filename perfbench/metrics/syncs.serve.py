"""Device syncs a request: the program's ``sync.*`` counters over the
profiler stretch (each sync under a ``serve.request`` span, counted by
the innermost span around it), over its requests."""
from perfbench.harness.program_spans import syncs


def read(ctx):
    return syncs(ctx, "serve.request")
