"""Host ms a step spent in the CUDA runtime's sync calls
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) inside the ``dfvod.train.step`` ranges of the
profiler stretch, on any thread."""
from perfbench.harness.program_spans import sync_wait_ms


def read(ctx):
    return sync_wait_ms(ctx, "train.step")
