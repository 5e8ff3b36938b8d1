"""Host ms a step inside the program's span ``train.update`` (the
global-norm clip, the rates and AdamW's step), from the
``dfvod.train.update`` ranges of the profiler stretch."""
from perfbench.harness.program_spans import host_ms


def read(ctx):
    return host_ms(ctx, "train.update")
