"""Host ms a step inside the program's span ``train.backward``
(``loss.backward()``, while autograd's thread runs the backward), from
the ``dfvod.train.backward`` ranges of the profiler stretch."""
from perfbench.harness.program_spans import host_ms


def read(ctx):
    return host_ms(ctx, "train.backward")
