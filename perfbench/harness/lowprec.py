"""The control of a train cell: the reference in the precision one step
below the configuration's (bf16 mixed precision -> fp8).

Inside ``fp8()`` every operand of a linear layer, convolution or matrix
product is rounded to float8 e4m3 with a per-tensor scale (its largest
magnitude onto e4m3's largest finite value) and computed on in f32, with
the rounding passed straight through in the backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def round_fp8(x):
    if not x.is_floating_point():
        return x
    scale = x.detach().abs().amax().clamp(min=1e-12) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class fp8(TorchFunctionMode):
    OPS = {F.linear, F.conv2d, torch.matmul, torch.Tensor.matmul,
           torch.Tensor.__matmul__, torch.bmm, torch.einsum}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            args = tuple(round_fp8(a) if torch.is_tensor(a) else a
                         for a in args)
            kwargs = {k: round_fp8(v) if torch.is_tensor(v) else v
                      for k, v in kwargs.items()}
        return func(*args, **kwargs)


class bf16(fp8):
    """The reference with every operand of a linear layer, convolution or
    matrix product rounded to bfloat16 (products and sums in f32): its
    gap to the f32 reference is this model's sensitivity to bf16
    rounding, the unit in which the check measures the program's gap."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.OPS:
            args = tuple(round_bf16(a) if torch.is_tensor(a) else a
                         for a in args)
            kwargs = {k: round_bf16(v) if torch.is_tensor(v) else v
                      for k, v in kwargs.items()}
        return func(*args, **kwargs)


def round_bf16(x):
    if not x.is_floating_point():
        return x
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x.detach())
