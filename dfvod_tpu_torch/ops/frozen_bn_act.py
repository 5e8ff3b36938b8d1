"""One epilogue pass over a FrozenBN'd conv output: the plain PyTorch
version, the wrapper of the hand-written CUDA kernels
``csrc/frozen_bn_act.cu`` (forward and backward), joined as a
``torch.autograd.Function``.

    y = act(x * scale + bias + R),  R = 0 | residual
                                      | residual * res_scale + res_bias

with ``act`` ReLU or nothing. The contract:

- ``x``, ``residual``: ``(N, C, H, W)`` of one dtype and one memory order;
  on the card bf16, f16 or f32, and NHWC (``torch.channels_last``) or
  NCHW-contiguous memory
- ``scale``, ``bias``, ``res_scale``, ``res_bias``: ``(C,)`` per-channel
  constants, f32 (f64 for an f64 ``x``, on the CPU): a FrozenBN's fold cast
  to x's dtype, as ``models/backbone_resnet.py::FrozenBatchNorm.folded``
  gives them
- output: ``(N, C, H, W)`` in x's dtype and memory order

The arithmetic is f32 (f64 for f64), each multiply and add rounded in
turn, and the result is rounded once to x's dtype. In f32 that is bitwise
the unfused ``x * s + b``, ``+ R``, ``relu`` chain. The backward reads the
incoming gradient and, with ReLU, the output: ``dx = g * [y > 0] * scale``
and ``dr = g * [y > 0]`` (``* res_scale`` for the affine residual), each
rounded once; the constants take no gradient. Its ReLU mask is the rounded
output's, where autograd through the plain version reads the unrounded
one: the two differ only where a positive sum rounds to zero (below f16's
smallest subnormal, 6e-8).

``frozen_bn_act`` takes the plain version for CPU tensors. For CUDA
tensors it launches the kernel, on the tensors' own card, or raises: a
dtype, layout, residual or pointer that is not 16-byte aligned (a view
that starts inside its buffer) the kernel does not take is refused,
nothing falls back. The backward copies an unaligned incoming gradient,
which autograd may hand over. It goes through the
autograd function only where autograd records, so that the function saves
the output only then. The counters ``frozen_bn_act`` and
``frozen_bn_act_bwd`` (``utils/trace.py``) count its passes, on either
device: launches on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dfvod_tpu_torch.ops import build
from dfvod_tpu_torch.utils import trace

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the C entry's path numbers
PATHS = ("nhwc8", "nchw8", "general8")
_CHANNEL = (1, -1, 1, 1)


def acc_dtype(dtype):
    """The dtype the pass computes in for inputs of ``dtype``: f64 for
    f64, f32 otherwise."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def frozen_bn_act_plain(x, scale, bias, residual=None, res_scale=None,
                        res_bias=None, relu=True):
    """The pass in PyTorch with the kernel's rounding points: f32 (f64 for
    f64) products and sums in the unfused chain's order, the result
    rounded once to x's dtype."""
    acc = acc_dtype(x.dtype)
    y = (x.to(acc) * scale.to(acc).view(_CHANNEL)
         + bias.to(acc).view(_CHANNEL))
    if residual is not None:
        r = residual.to(acc)
        if res_scale is not None:
            r = (r * res_scale.to(acc).view(_CHANNEL)
                 + res_bias.to(acc).view(_CHANNEL))
        y = y + r
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def frozen_bn_act_bwd_plain(g, y, scale, res_scale, relu, need_x, need_r):
    """(dx, dr) as the kernel computes them (None where not asked for):
    ``g * [y > 0]`` in f32 (f64), times ``scale`` for dx and ``res_scale``
    for the affine residual's dr, each rounded once to g's dtype."""
    acc = acc_dtype(g.dtype)
    gm = g.to(acc)
    if relu:
        gm = torch.where(y > 0, gm, torch.zeros((), dtype=acc))
    dx = dr = None
    if need_x:
        dx = (gm * scale.to(acc).view(_CHANNEL)).to(g.dtype)
    if need_r:
        if res_scale is not None:
            gm = gm * res_scale.to(acc).view(_CHANNEL)
        dr = gm.to(g.dtype)
    return dx, dr


def _inner(t):
    """Elements of one channel in a run of a 4-d (N, C, H, W) tensor's
    memory: 1 for NHWC (channels-last) memory, H * W for NCHW; any other
    stride raises."""
    if t.dim() != 4:
        raise ValueError(f"frozen_bn_act takes a 4-d (N, C, H, W) tensor, "
                         f"not shape {tuple(t.shape)}")
    if t.is_contiguous(memory_format=torch.channels_last):
        return 1
    if t.is_contiguous():
        return t.shape[2] * t.shape[3]
    raise ValueError(f"frozen_bn_act takes NHWC (channels-last) or "
                     f"NCHW-contiguous memory, not strides {t.stride()} of "
                     f"shape {tuple(t.shape)}")


def _aligned(t):
    return t is None or t.data_ptr() % 16 == 0


def _check_aligned(*tensors):
    if not all(_aligned(t) for t in tensors):
        raise ValueError("frozen_bn_act takes 16-byte aligned tensors; a "
                         "view that starts inside its buffer is not: pass "
                         "a copy")


def _check_constants(x, *consts):
    C = x.shape[1]
    for t in consts:
        if t is None:
            continue
        if (tuple(t.shape) != (C,) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"the per-channel constants are ({C},) "
                             f"contiguous f32 on {x.device}, not "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    _check_aligned(*consts)


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("frozen_bn_act")
    lib.frozen_bn_act_fwd.argtypes = ([ctypes.c_void_p] * 7
                                      + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p])
    lib.frozen_bn_act_fwd.restype = ctypes.c_int
    lib.frozen_bn_act_bwd.argtypes = ([ctypes.c_void_p] * 6
                                      + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p])
    lib.frozen_bn_act_bwd.restype = ctypes.c_int
    lib.frozen_bn_act_error_string.argtypes = [ctypes.c_int]
    lib.frozen_bn_act_error_string.restype = ctypes.c_char_p
    for fn in (lib.frozen_bn_act_fwd_launches,
               lib.frozen_bn_act_bwd_launches):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_longlong
    return lib


def kernel_paths(direction="fwd"):
    """{path: launches} of the forward (``"fwd"``) or backward (``"bwd"``)
    kernel since the library was loaded, as its C entry counts them where
    it chooses the path (``PATHS``)."""
    read = getattr(_library(), f"frozen_bn_act_{direction}_launches")
    return {name: read(i) for i, name in enumerate(PATHS)}


def _raise_on(what, lib, rc):
    if rc < 0:
        raise ValueError(f"{what} refused its arguments (code {rc})")
    if rc > 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.frozen_bn_act_error_string(rc).decode())


def _ptr(t):
    return None if t is None else t.data_ptr()


def frozen_bn_act_cuda(x, scale, bias, residual=None, res_scale=None,
                       res_bias=None, relu=True):
    """Launch the forward kernel on CUDA tensors."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"frozen_bn_act takes bf16, f16 or f32 on the card, "
                        f"not {x.dtype}")
    inner = _inner(x)
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device
                                 or _inner(residual) != inner):
        raise ValueError(f"the residual {tuple(residual.shape)} "
                         f"{residual.dtype} must have x's shape "
                         f"{tuple(x.shape)}, dtype {x.dtype}, device and "
                         f"memory order")
    _check_constants(x, scale, bias, res_scale, res_bias)
    _check_aligned(x, residual)
    lib = _library()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.frozen_bn_act_fwd(
            x.data_ptr(), _ptr(residual), scale.data_ptr(), bias.data_ptr(),
            _ptr(res_scale), _ptr(res_bias), y.data_ptr(), x.numel(),
            x.shape[1], inner, code, int(relu), stream)
    _raise_on("frozen_bn_act_fwd", lib, rc)
    return y


def frozen_bn_act_bwd_cuda(g, y, scale, res_scale, relu, need_x, need_r):
    """Launch the backward kernel on CUDA tensors: g and y (read with ReLU
    alone) of one dtype and memory order, 16-byte aligned."""
    inner = _inner(g)
    if relu and (y.shape != g.shape or y.dtype != g.dtype
                 or _inner(y) != inner):
        raise ValueError("the gradient and the output share shape, dtype "
                         "and memory order")
    _check_constants(g, scale, res_scale)
    _check_aligned(g, y if relu else None)
    lib = _library()
    dx = torch.empty_like(g) if need_x else None
    dr = torch.empty_like(g) if need_r else None
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = lib.frozen_bn_act_bwd(
            g.data_ptr(), y.data_ptr() if relu else None, scale.data_ptr(),
            _ptr(res_scale), _ptr(dx), _ptr(dr), g.numel(), g.shape[1],
            inner, _DTYPE_CODES[g.dtype], int(relu), stream)
    _raise_on("frozen_bn_act_bwd", lib, rc)
    return dx, dr


def _forward(x, scale, bias, residual, res_scale, res_bias, relu):
    if x.device.type == "cpu":
        y = frozen_bn_act_plain(x, scale, bias, residual, res_scale,
                                res_bias, relu)
    elif x.device.type == "cuda":
        y = frozen_bn_act_cuda(x, scale, bias, residual, res_scale, res_bias,
                               relu)
    else:
        raise ValueError(f"frozen_bn_act runs on cpu or cuda, not "
                         f"{x.device}")
    trace.count("frozen_bn_act")
    return y


class FrozenBNActFunction(torch.autograd.Function):
    """The pass with its hand-written backward: saves the output (with
    ReLU) and the scales; gradients for x and the residual only."""

    @staticmethod
    def forward(ctx, x, residual, scale, bias, res_scale, res_bias, relu):
        y = _forward(x, scale, bias, residual, res_scale, res_bias, relu)
        ctx.relu = relu
        ctx.memory_format = (torch.channels_last
                             if y.is_contiguous(
                                 memory_format=torch.channels_last)
                             else torch.contiguous_format)
        ctx.save_for_backward(y if relu else None, scale, res_scale)
        return y

    @staticmethod
    def backward(ctx, g):
        y, scale, res_scale = ctx.saved_tensors
        need_x, need_r = ctx.needs_input_grad[:2]
        # the identity residual without ReLU passes the gradient on as it is
        passed = need_r and not ctx.relu and res_scale is None
        if passed:
            need_r = False
        dx = dr = None
        if need_x or need_r:
            if g.device.type == "cpu":
                dx, dr = frozen_bn_act_bwd_plain(g, y, scale, res_scale,
                                                 ctx.relu, need_x, need_r)
            else:
                # autograd may hand over any strides (an expanded zero, a
                # permuted view) and views inside their buffers: the
                # kernel reads the output's memory order, 16-byte aligned
                g = g.contiguous(memory_format=ctx.memory_format)
                if not _aligned(g):
                    g = g.clone(memory_format=ctx.memory_format)
                dx, dr = frozen_bn_act_bwd_cuda(g, y, scale, res_scale,
                                                ctx.relu, need_x, need_r)
            trace.count("frozen_bn_act_bwd")
        return dx, g if passed else dr, None, None, None, None, None


def frozen_bn_act(x, scale, bias, residual=None, res_scale=None,
                  res_bias=None, relu=True):
    """``act(x * scale + bias + R)`` in one pass (the module docstring):
    ``residual`` alone adds it, with ``res_scale`` and ``res_bias`` adds
    ``residual * res_scale + res_bias``."""
    if (res_scale is None) != (res_bias is None) or (
            residual is None and res_scale is not None):
        raise ValueError("res_scale and res_bias come together, with a "
                         "residual")
    if any(t is not None and t.requires_grad
           for t in (scale, bias, res_scale, res_bias)):
        raise ValueError("frozen_bn_act's constants take no gradient")
    if residual is not None and residual.dtype != x.dtype:
        raise TypeError(f"the residual is {residual.dtype}, x {x.dtype}: "
                        f"the pass takes one dtype")
    if torch.is_grad_enabled() and (
            x.requires_grad
            or (residual is not None and residual.requires_grad)):
        return FrozenBNActFunction.apply(x, residual, scale, bias, res_scale,
                                         res_bias, relu)
    return _forward(x, scale, bias, residual, res_scale, res_bias, relu)
