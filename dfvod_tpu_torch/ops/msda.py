"""Multi-scale deformable attention (MSDA): the plain PyTorch version and
the wrapper of the hand-written CUDA kernel (``csrc/msda_fwd.cu``).

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

``ms_deform_attn`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises.
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
        raise TypeError(f"msda_fwd takes f32 or bf16 values, not "
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
def _library():
    lib = build.load("msda_fwd")
    lib.msda_fwd.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                             + [ctypes.POINTER(ctypes.c_int)]
                             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.msda_fwd.restype = ctypes.c_int
    lib.msda_error_string.argtypes = [ctypes.c_int]
    lib.msda_error_string.restype = ctypes.c_char_p
    return lib


def ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                        attention_weights):
    """Launch ``csrc/msda_fwd.cu`` on CUDA tensors."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check_kernel_args(value, spatial_shapes, sampling_locations,
                       attention_weights)
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    lib = _library()
    out = torch.empty((B, Lq, M * D), dtype=value.dtype,
                      device=value.device)
    shapes = (ctypes.c_int * (2 * L))(*[v for hw in spatial_shapes
                                        for v in hw])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.msda_fwd(
            value.data_ptr(), sampling_locations.data_ptr(),
            attention_weights.data_ptr(), out.data_ptr(),
            B, S, M, D, Lq, L, P, shapes, _DTYPE_CODES[value.dtype],
            _DTYPE_CODES[sampling_locations.dtype],
            _DTYPE_CODES[attention_weights.dtype], stream)
    if rc < 0:
        raise ValueError(f"msda_fwd refused its arguments (code {rc})")
    if rc > 0:
        raise RuntimeError("msda_fwd launch failed: "
                           + lib.msda_error_string(rc).decode())
    ms_deform_attn.launches += 1
    return out


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights):
    """MSDA: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors. ``ms_deform_attn.launches`` counts kernel launches."""
    if value.device.type == "cpu":
        return ms_deform_attn_plain(value, spatial_shapes,
                                    sampling_locations, attention_weights)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_attn runs on cpu or cuda, not "
                         f"{value.device}")
    return ms_deform_attn_cuda(value, spatial_shapes, sampling_locations,
                               attention_weights)


ms_deform_attn.launches = 0
