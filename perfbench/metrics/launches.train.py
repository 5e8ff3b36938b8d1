"""Kernel launches a step: the CUDA launch calls (``cudaLaunch*``,
``cuLaunch*``, ``cudaGraphLaunch``) inside the
``dfvod.train.step`` ranges of the profiler stretch, the backward's
from autograd's thread among them."""
from perfbench.harness.program_spans import launches


def read(ctx):
    return launches(ctx, "train.step")
