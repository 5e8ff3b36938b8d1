"""Host ms a request spent in the CUDA runtime's sync calls
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``) inside the ``dfvod.serve.request`` ranges of
the profiler stretch: the host waiting on the card inside the call."""
from perfbench.harness.program_spans import sync_wait_ms


def read(ctx):
    return sync_wait_ms(ctx, "serve.request")
