"""The whole step's share of the cell's cards' bf16 peak: the model FLOPs
of a step's forward and backward (counted in
``perfbench/harness/flops.py``) times steps a second of the traced
window, over 989 TFLOP/s times the cell's cards."""


def read(ctx):
    if ctx.counts is None:
        return None
    per_s = ctx.frames_per_s / ctx.key_frames_per_call
    return (100.0 * ctx.counts["flops"] * per_s
            / (ctx.chips * ctx.peaks["bf16_flops"]))
