"""A stride-1 ResNet bottleneck stage with FrozenBN folded in (layer1 of
ResNet-50): the plain PyTorch version, the unfused form its gradient comes
from, and the wrapper of the hand-written CUDA kernel
``csrc/fused_bottleneck.cu`` (K6, one launch per block: a persistent
tensor-core kernel for layer1's widths, a generic one for the others),
joined as a ``torch.autograd.Function``.

Counterpart of ``dfvod_tpu/ops/fused_bottleneck.py``: ``fused_stage_plain``
of ``reference_stage``, ``grad_stage`` of ``grad_stage``,
``fused_bottleneck_stage`` of ``fused_bottleneck_stage`` (its Pallas kernel
``_stage_pallas``). The contract:

- ``x``       : ``(B, H, W, Cin)`` NHWC, bf16 on the card
- ``weights`` : per block ``(w1 (Cin, Cm), b1 (Cm,), w2 (3, 3, Cm, Cm),
                b2, w3 (Cm, Cout), b3 (Cout,), wd (Cin, Cout) | None,
                bd | None)``, the weights bf16 in matmul (HWIO) layouts and
                the biases f32 (``Bottleneck.folded_weights``)
- output      : ``(B, H, W, Cout)`` in x's dtype

Every block: ``t = relu(x.w1 + b1)`` and ``u = relu(conv3x3(t, w2) + b2)``,
each accumulated in f32 and rounded to x's dtype, the 3x3 zero-padded
(padding is 0, not relu(b1)); then ``relu((u.w3 + b3) + idn)`` in f32,
rounded, with ``idn = x.wd + bd`` or ``x``.

``fused_bottleneck_stage`` runs ``FusedStageFunction`` on either device:
its forward takes the plain version for CPU tensors and launches K6 for
CUDA tensors (or raises); its backward is autograd through the unfused
``grad_stage``, as the JAX package's ``custom_vjp`` (the package has no
backward kernel here). On the card x must be a contiguous NHWC tensor, as
the channels-last NCHW activations of the port's ResNet give it for free
(``x.permute(0, 2, 3, 1)``); anything else raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from dfvod_tpu_torch.ops import build
from dfvod_tpu_torch.utils import trace

_BLOCK = 8   # tensors per block in ``weights``


def _conv3x3(t, w2):
    """3x3, stride 1, zero padding 1, NHWC in and out, HWIO weights."""
    out = F.conv2d(t.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def fused_stage_plain(x, weights, acc=torch.float32):
    """The stage unfused with the kernel's rounding points: products and
    sums in ``acc`` (f32; f64 sums all but exactly, the form a rounding
    of either is judged by), t, u and each block's output rounded to x's
    dtype."""
    y = x
    for w1, b1, w2, b2, w3, b3, wd, bd in weights:
        yf = y.to(acc)
        t = torch.relu(yf @ w1.to(acc) + b1.to(acc)).to(x.dtype)
        u = torch.relu(_conv3x3(t.to(acc), w2.to(acc)) + b2.to(acc)
                       ).to(x.dtype)
        o = u.to(acc) @ w3.to(acc) + b3.to(acc)
        idn = yf if wd is None else yf @ wd.to(acc) + bd.to(acc)
        y = torch.relu(o + idn).to(x.dtype)
    return y


def grad_stage(x, weights):
    """The unfused stage in x's dtype throughout (bf16 on the serving
    path), whose autograd is the fused stage's gradient."""
    dt = x.dtype
    y = x
    for w1, b1, w2, b2, w3, b3, wd, bd in weights:
        t = torch.relu(y @ w1.to(dt) + b1.to(dt))
        u = torch.relu(_conv3x3(t, w2.to(dt)) + b2.to(dt))
        o = u @ w3.to(dt) + b3.to(dt)
        idn = y if wd is None else y @ wd.to(dt) + bd.to(dt)
        y = torch.relu(o + idn)
    return y


def _blocks(flat):
    return [tuple(flat[i:i + _BLOCK]) for i in range(0, len(flat), _BLOCK)]


def _check_block(cin, device, blk):
    """(Cin, Cm, Cout) of one block reading ``cin`` channels; raises on
    what K6 does not take."""
    w1, b1, w2, b2, w3, b3, wd, bd = blk
    Cin, Cm = w1.shape
    Cout = w3.shape[-1]
    shapes = [(w1, (cin, Cm)), (b1, (Cm,)), (w2, (3, 3, Cm, Cm)),
              (b2, (Cm,)), (w3, (Cm, Cout)), (b3, (Cout,))]
    if (wd is None) != (bd is None):
        raise ValueError("wd and bd come together")
    if wd is None and Cin != Cout:
        raise ValueError(f"an identity block needs Cin == Cout, not {Cin} "
                         f"and {Cout}")
    if wd is not None:
        shapes += [(wd, (Cin, Cout)), (bd, (Cout,))]
    for i, (t, shape) in enumerate(shapes):
        want = torch.bfloat16 if t.dim() > 1 else torch.float32
        if tuple(t.shape) != shape or t.dtype != want:
            raise ValueError(f"block tensor {i} is {tuple(t.shape)} "
                             f"{t.dtype}, not {shape} {want}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"block tensor {i} must be contiguous on "
                             f"{device}")
    if min(Cin, Cm, Cout) < 16 or Cin % 16 or Cm % 16 or Cout % 16:
        raise ValueError(f"K6 takes channels in multiples of 16, not "
                         f"{Cin}/{Cm}/{Cout}")
    return Cin, Cm, Cout


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("fused_bottleneck")
    lib.fused_bottleneck_block.argtypes = ([ctypes.c_void_p] * 10
                                           + [ctypes.c_int] * 6
                                           + [ctypes.c_void_p])
    lib.fused_bottleneck_block.restype = ctypes.c_int
    lib.fused_bottleneck_block_error_string.argtypes = [ctypes.c_int]
    lib.fused_bottleneck_block_error_string.restype = ctypes.c_char_p
    lib.fused_bottleneck_layer1_launches.restype = ctypes.c_longlong
    lib.fused_bottleneck_generic_launches.restype = ctypes.c_longlong
    lib.fused_bottleneck_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_bottleneck_smem_bytes.restype = ctypes.c_longlong
    return lib


def kernel_paths():
    """{"layer1": n, "generic": n}: the launches of each kernel of
    ``csrc/fused_bottleneck.cu`` since it was loaded, as its C entry counts
    them where it chooses the path (the layer1 kernel for Cm = 64, Cout =
    256 and Cin = 64 with a projection or 256 with the identity)."""
    lib = _library()
    return {"layer1": lib.fused_bottleneck_layer1_launches(),
            "generic": lib.fused_bottleneck_generic_launches()}


def smem_bytes(cin, cm, cout):
    """Dynamic shared memory per CTA of the kernel path that the C entry
    takes for a block of these widths (-1 where no path takes them)."""
    return _library().fused_bottleneck_smem_bytes(cin, cm, cout)


def fused_stage_cuda(x, weights):
    """Launch ``csrc/fused_bottleneck.cu`` once per block on CUDA tensors."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K6 takes bf16 activations, not {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"K6 takes a contiguous NHWC (B, H, W, C) tensor, "
                         f"not shape {tuple(x.shape)} strides {x.stride()}")
    B, H, W, cin = x.shape
    channels = []
    for blk in weights:
        channels.append(_check_block(cin, x.device, blk))
        cin = channels[-1][2]
    lib = _library()
    y = x
    for blk, (Cin, Cm, Cout) in zip(weights, channels):
        out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
        ptrs = [None if t is None else t.data_ptr() for t in blk]
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.fused_bottleneck_block(y.data_ptr(), out.data_ptr(),
                                            *ptrs, B, H, W, Cin, Cm, Cout,
                                            stream)
        if rc < 0:
            raise ValueError(f"fused_bottleneck_block refused its arguments "
                             f"(code {rc})")
        if rc > 0:
            raise RuntimeError(
                "fused_bottleneck_block launch failed: "
                + lib.fused_bottleneck_block_error_string(rc).decode())
        trace.count("fused_bottleneck")
        y = out
    return y


class FusedStageFunction(torch.autograd.Function):
    """The fused stage with the JAX package's gradient: forward K6 on
    CUDA tensors (the plain version on CPU tensors), backward autograd
    through ``grad_stage`` for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, x, *flat):
        ctx.save_for_backward(x, *flat)
        if x.device.type == "cpu":
            return fused_stage_plain(x, _blocks(flat))
        if x.device.type != "cuda":
            raise ValueError(f"fused_bottleneck_stage runs on cpu or cuda, "
                             f"not {x.device}")
        return fused_stage_cuda(x, _blocks(flat))

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        with torch.enable_grad():
            y = grad_stage(leaves[0], _blocks(leaves[1:]))
            grads = iter(torch.autograd.grad(y, wanted,
                                             grad_out.to(y.dtype),
                                             allow_unused=True))
        return tuple(next(grads) if t is not None and t.requires_grad
                     else None for t in leaves)


def fused_bottleneck_stage(x, weights):
    """The stage through ``FusedStageFunction``: x ``(B, H, W, Cin)``,
    ``weights`` per block as the module docstring says.
    The counter ``fused_bottleneck`` (``utils/trace.py``) counts K6
    launches (one per block)."""
    flat = [t for blk in weights for t in blk]
    if len(flat) != _BLOCK * len(weights):
        raise ValueError("each block is (w1, b1, w2, b2, w3, b3, wd, bd)")
    return FusedStageFunction.apply(x, *flat)
