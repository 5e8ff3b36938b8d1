"""Device syncs a step: the program's ``sync.*`` counters over the
profiler stretch (each sync under a ``train.step`` span, counted by the
innermost span around it), over its steps."""
from perfbench.harness.program_spans import syncs


def read(ctx):
    return syncs(ctx, "train.step")
