"""Host ms a request inside the program's span ``serve.model`` (the
model's forward under ``Server.__call__``), from the ``dfvod.serve.model``
ranges of the profiler stretch."""
from perfbench.harness.program_spans import host_ms


def read(ctx):
    return host_ms(ctx, "serve.model")
