"""Multi-scale deformable attention (MSDA): the plain PyTorch version, its
backward, and the wrappers of the hand-written CUDA kernels
(``csrc/msda_fwd.cu``, ``csrc/msda_bwd.cu``) joined as a
``torch.autograd.Function``.

Counterpart of ``dfvod_tpu/ops/msda.py``. The contract is the same:

- ``value``               : ``(B, S, M, D)`` with ``S = sum(H_l * W_l)``;
                            padding rows zeroed by the caller
- ``spatial_shapes``      : static tuple ``((H_0, W_0), ...)`` of the L levels
- ``sampling_locations``  : ``(B, Lq, M, L, P, 2)`` normalized to ``[0, 1]``
                            in (x, y) order
- ``attention_weights``   : ``(B, Lq, M, L, P)``, softmaxed over (L, P)
- output                  : ``(B, Lq, M * D)`` in the value's dtype

Bilinear sampling follows ``F.grid_sample`` with ``align_corners=False`` and
``padding_mode='zeros'``: pixel coordinates are ``loc * size - 0.5`` and any
corner outside the map contributes 0.

``ms_deform_attn`` takes the plain version for CPU tensors only, and
autograd differentiates it there. For CUDA tensors it goes through
``MSDeformAttnFunction``, whose forward and backward launch their kernels
or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from dfvod_tpu_torch.ops import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_LEVELS = 4


def total_tokens(spatial_shapes: Sequence[Tuple[int, int]]) -> int:
    return int(sum(h * w for h, w in spatial_shapes))


def ms_deform_attn_plain(value, spatial_shapes, sampling_locations,
                         attention_weights):
    """Per-level 4-corner gather, the counterpart of
    ``ms_deform_attn_xla``. Coordinates, weights and the sum are in f32 (or
    wider, if the locations are); the result is cast to the value dtype
    once."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if S != total_tokens(spatial_shapes) or L != len(spatial_shapes):
        raise ValueError(f"value tokens {S} / levels {L} do not match "
                         f"spatial_shapes {spatial_shapes}")
    coord_dtype = torch.promote_types(sampling_locations.dtype,
                                      torch.float32)
    loc = sampling_locations.to(coord_dtype)
    attw = attention_weights.to(coord_dtype)
    v_bm = value.permute(0, 2, 1, 3)                  # (B, M, S, D)
    acc = torch.zeros((B, M, Lq, D), dtype=coord_dtype, device=value.device)
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        v_l = v_bm[:, :, start:start + H * W]
        # (B, Lq, M, P) -> (B, M, Lq, P)
        x = (loc[:, :, :, lvl, :, 0] * W - 0.5).transpose(1, 2)
        y = (loc[:, :, :, lvl, :, 1] * H - 0.5).transpose(1, 2)
        aw = attw[:, :, :, lvl, :].transpose(1, 2)
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0i, y0i = x0.long(), y0.long()
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            cx, cy = x0i + dx, y0i + dy
            valid = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
            w = ((fy if dy else 1 - fy) * (fx if dx else 1 - fx)
                 * valid.to(coord_dtype) * aw)        # (B, M, Lq, P)
            idx = cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)
            g = torch.gather(
                v_l, 2, idx.reshape(B, M, Lq * P, 1).expand(-1, -1, -1, D))
            acc += (w[..., None] * g.reshape(B, M, Lq, P, D).to(coord_dtype)
                    ).sum(3)
        start += H * W
    return acc.permute(0, 2, 1, 3).reshape(B, Lq, M * D).to(value.dtype)


def _check_kernel_args(value, spatial_shapes, loc, attw):
    if value.dtype not in _DTYPE_CODES:
        raise TypeError(f"the MSDA kernels take f32 or bf16 values, not "
                        f"{value.dtype}")
    for name, t in (("sampling_locations", loc), ("attention_weights", attw)):
        if t.dtype not in (torch.float32, value.dtype):
            raise TypeError(f"{name} must be f32 or the value dtype "
                            f"{value.dtype}, not {t.dtype}")
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on "
                             f"{value.device}")
    if value.dim() != 4 or loc.dim() != 6 or attw.dim() != 5:
        raise ValueError("expected value (B,S,M,D), loc (B,Lq,M,L,P,2), "
                         "attw (B,Lq,M,L,P)")
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = loc.shape
    if loc.shape != (B, Lq, M, L, P, 2) or attw.shape != (B, Lq, M, L, P):
        raise ValueError(f"shape mismatch: value {tuple(value.shape)}, loc "
                         f"{tuple(loc.shape)}, attw {tuple(attw.shape)}")
    if not 1 <= L <= MAX_LEVELS or L != len(spatial_shapes):
        raise ValueError(f"{L} levels; the kernel takes 1..{MAX_LEVELS} "
                         f"and spatial_shapes has {len(spatial_shapes)}")
    if S != total_tokens(spatial_shapes):
        raise ValueError(f"value token axis {S} != sum(H*W) "
                         f"{total_tokens(spatial_shapes)}")
    for name, t in (("value", value), ("sampling_locations", loc),
                    ("attention_weights", attw)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _library(name: str):
    """The loaded ``csrc/<name>.cu`` (``msda_fwd`` or ``msda_bwd``) with its
    argument types set."""
    lib = build.load(name)
    n_ptrs = {"msda_fwd": 4, "msda_bwd": 8}[name]
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _raise_on(name: str, lib, rc: int):
    if rc < 0:
        raise ValueError(f"{name} refused its arguments (code {rc})")
    if rc > 0:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{name}_error_string")(rc).decode())


def _shape_array(spatial_shapes):
    return (ctypes.c_int * (2 * len(spatial_shapes)))(
        *[v for hw in spatial_shapes for v in hw])


def ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                        attention_weights):
    """Launch ``csrc/msda_fwd.cu`` on CUDA tensors."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check_kernel_args(value, spatial_shapes, sampling_locations,
                       attention_weights)
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    lib = _library("msda_fwd")
    out = torch.empty((B, Lq, M * D), dtype=value.dtype,
                      device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_fwd(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(),
            B, S, M, D, Lq, L, P, _shape_array(spatial_shapes),
            _DTYPE_CODES[value.dtype],
            _DTYPE_CODES[sampling_locations.dtype],
            _DTYPE_CODES[attention_weights.dtype], stream)
    _raise_on("msda_fwd", lib, rc)
    ms_deform_attn.launches += 1
    return out


def ms_deform_attn_bwd_cuda(value, spatial_shapes, sampling_locations,
                            attention_weights, grad_out,
                            needs=(True, True, True)):
    """Launch ``csrc/msda_bwd.cu`` on CUDA tensors: (grad_value, grad_loc,
    grad_attw), each in its input's dtype, or None where ``needs`` (value,
    loc, attw) is False; that gradient is not computed. ``grad_out`` has the
    value's dtype."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check_kernel_args(value, spatial_shapes, sampling_locations,
                       attention_weights)
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    if grad_out.shape != (B, Lq, M * D) or grad_out.dtype != value.dtype:
        raise ValueError(f"grad_out must be {(B, Lq, M * D)} in "
                         f"{value.dtype}, not {tuple(grad_out.shape)} in "
                         f"{grad_out.dtype}")
    if grad_out.device != value.device or not grad_out.is_contiguous():
        raise ValueError("grad_out must be contiguous, on the value's device")
    need_v, need_l, need_a = needs
    lib = _library("msda_bwd")
    grad_value = grad_value_f32 = grad_loc = grad_attw = None
    if need_v:
        # atomics accumulate in f32; an f32 value accumulates in place
        grad_value_f32 = torch.zeros(value.shape, dtype=torch.float32,
                                     device=value.device)
        grad_value = (grad_value_f32 if value.dtype == torch.float32
                      else torch.empty_like(value))
    if need_l:
        grad_loc = torch.empty_like(sampling_locations)
    if need_a:
        grad_attw = torch.empty_like(attention_weights)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_bwd(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), grad_out.data_ptr(),
            ptr(grad_value_f32), ptr(grad_value), ptr(grad_loc),
            ptr(grad_attw), B, S, M, D, Lq, L, P,
            _shape_array(spatial_shapes), _DTYPE_CODES[value.dtype],
            _DTYPE_CODES[sampling_locations.dtype],
            _DTYPE_CODES[attention_weights.dtype], stream)
    _raise_on("msda_bwd", lib, rc)
    ms_deform_attn_bwd.launches += 1
    return grad_value, grad_loc, grad_attw


class MSDeformAttnFunction(torch.autograd.Function):
    """MSDA on CUDA tensors with its gradient: the forward launches
    ``csrc/msda_fwd.cu``, the backward ``csrc/msda_bwd.cu``. The kernels
    take the mixed dtypes autocast feeds them as they come."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations,
                attention_weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                                   attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, attw = ctx.saved_tensors
        need_v, _, need_l, need_a = ctx.needs_input_grad
        grad_value, grad_loc, grad_attw = ms_deform_attn_bwd_cuda(
            value, ctx.spatial_shapes, loc, attw,
            grad_out.to(value.dtype).contiguous(),
            (need_v, need_l, need_a))
        return grad_value, None, grad_loc, grad_attw


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights):
    """MSDA: the plain version for CPU tensors (autograd differentiates
    it), ``MSDeformAttnFunction`` for CUDA tensors.
    ``ms_deform_attn.launches`` counts forward kernel launches,
    ``ms_deform_attn_bwd.launches`` backward ones."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes,
                                    sampling_locations, attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn runs on cpu or cuda, not "
                         f"{value.device}")
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    return MSDeformAttnFunction.apply(value, spatial_shapes,
                                      sampling_locations, attention_weights)


ms_deform_attn.launches = 0


def ms_deform_attn_plain_bwd(value, spatial_shapes, sampling_locations,
                             attention_weights, grad_out):
    """The plain backward: ``torch.autograd.grad`` through
    ``ms_deform_attn_plain``. Returns (grad_value, grad_loc, grad_attw),
    each in its input's dtype."""
    inputs = [t.detach().requires_grad_() for t in
              (value, sampling_locations, attention_weights)]
    with torch.enable_grad():
        out = ms_deform_attn_plain(inputs[0], spatial_shapes, inputs[1],
                                   inputs[2])
        return torch.autograd.grad(out, inputs, grad_out)


def ms_deform_attn_bwd(value, spatial_shapes, sampling_locations,
                       attention_weights, grad_out):
    """The MSDA VJP as a function: the plain backward for CPU tensors,
    ``csrc/msda_bwd.cu`` for CUDA tensors."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain_bwd(value, spatial_shapes,
                                        sampling_locations,
                                        attention_weights, grad_out)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn_bwd runs on cpu or cuda, not "
                         f"{value.device}")
    return ms_deform_attn_bwd_cuda(value, spatial_shapes, sampling_locations,
                                   attention_weights, grad_out)


ms_deform_attn_bwd.launches = 0
