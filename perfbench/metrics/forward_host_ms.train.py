"""Host ms a step inside the program's span ``train.forward`` (the
forward in train mode, from the uint8 frames to the f32 outputs), from
the ``dfvod.train.forward`` ranges of the profiler stretch."""
from perfbench.harness.program_spans import host_ms


def read(ctx):
    return host_ms(ctx, "train.forward")
