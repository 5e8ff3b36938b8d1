"""Host ms a step inside the program's span ``train.criterion`` (the
criterion with the matcher), from the ``dfvod.train.criterion`` ranges
of the profiler stretch."""
from perfbench.harness.program_spans import host_ms


def read(ctx):
    return host_ms(ctx, "train.criterion")
