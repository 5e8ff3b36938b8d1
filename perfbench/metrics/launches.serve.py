"""Kernel launches a request: the CUDA launch calls (``cudaLaunch*``,
``cuLaunch*``, ``cudaGraphLaunch``) inside the
``dfvod.serve.request`` ranges of the profiler stretch."""
from perfbench.harness.program_spans import launches


def read(ctx):
    return launches(ctx, "serve.request")
