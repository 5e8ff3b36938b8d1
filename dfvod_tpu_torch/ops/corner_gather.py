"""Weighted row gather (K5b/K5c): the plain PyTorch version, the wrapper of
the hand-written CUDA kernel ``csrc/corner_gather_fwd.cu``, and the folded
bilinear corners of MSDA that feed it.

Counterpart of ``dfvod_tpu/ops/msda.py::corner_indices_weights`` and of two
TPU kernels of ``dfvod_tpu/ops/msda_pallas.py`` that compute one function,
``_onehot_kernel`` (``onehot_sample``, ``ms_deform_attn_pallas_onehot``) and
``_kernel`` (``ms_deform_attn_pallas``). The contract:

- ``value`` : ``(B, S, M, D)`` f32 or bf16
- ``idx``   : ``(B, Lq, M, K)`` int32 token indices into ``S``
- ``w``     : ``(B, Lq, M, K)`` f32 weights
- output    : ``(B, Lq, M, D)`` in the value's dtype,
              ``out[b, q, m] = sum_k w[b, q, m, k] * value[b, idx[b, q, m, k], m]``

An index outside ``[0, S)`` contributes 0 (the row gather's
``fill_value=0``, the one-hot matrix's row with no match). Weights and the
sum are f32; the result is cast to the value's dtype once. The JAX
package's ``(BM, S, D)`` layout of ``onehot_sample`` is the case ``M = 1``.

``corner_gather`` takes the plain version for CPU tensors only. For CUDA
tensors it launches the kernel or raises; the kernel has no backward of its
own (MSDA's gradient on the card is K2, ``ops/msda.py``), so it refuses
inputs that need a gradient rather than drop it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dfvod_tpu_torch.ops import build
from dfvod_tpu_torch.utils import trace

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))   # (dy, dx)


def corner_indices_weights(spatial_shapes, sampling_locations,
                           attention_weights):
    """MSDA's bilinear corners, attention weights and out-of-map masking
    folded into flat token indices and scalar weights, as
    ``dfvod_tpu/ops/msda.py::corner_indices_weights``: idx ``(B, Lq, M, K)``
    int32 into the flattened token axis (clamped into each level) and w
    ``(B, Lq, M, K)`` f32 (0 for a corner outside its level),
    ``K = L * P * 4`` ordered (level, corner, point). Differentiable in the
    locations and the attention weights."""
    loc = sampling_locations.float()
    attw = attention_weights.float()
    idxs, ws = [], []
    start = 0
    for lvl, (H, W) in enumerate(spatial_shapes):
        x = loc[:, :, :, lvl, :, 0] * W - 0.5          # (B, Lq, M, P)
        y = loc[:, :, :, lvl, :, 1] * H - 0.5
        w_l = attw[:, :, :, lvl, :]
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0i, y0i = x0.int(), y0.int()
        cw = ((1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx)
        for c, (dy, dx) in enumerate(_CORNERS):
            cx, cy = x0i + dx, y0i + dy
            valid = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
            idxs.append(cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1) + start)
            ws.append(cw[c] * w_l * valid.float())
        start += H * W
    return torch.cat(idxs, -1), torch.cat(ws, -1)


def corner_gather_plain(value, idx, w):
    """One ``torch.gather`` of all B*M*Lq*K rows, then the weighted sum in
    f32."""
    B, S, M, D = value.shape
    _, Lq, _, K = idx.shape
    valid = (idx >= 0) & (idx < S)
    rows = torch.where(valid, idx, 0).long().permute(0, 2, 1, 3)
    g = torch.gather(value.permute(0, 2, 1, 3), 2,
                     rows.reshape(B, M, Lq * K, 1).expand(-1, -1, -1, D))
    wt = torch.where(valid, w.float(), 0.0).permute(0, 2, 1, 3)
    acc = (wt[..., None] * g.reshape(B, M, Lq, K, D).float()).sum(3)
    return acc.permute(0, 2, 1, 3).to(value.dtype)


def _check_kernel_args(value, idx, w):
    if value.dtype not in _DTYPE_CODES:
        raise TypeError(f"the corner_gather kernel takes f32 or bf16 values, "
                        f"not {value.dtype}")
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"idx must be int32 and w f32, not {idx.dtype} and "
                        f"{w.dtype}")
    if value.dim() != 4 or idx.dim() != 4 or idx.shape != w.shape:
        raise ValueError(f"expected value (B,S,M,D), idx and w (B,Lq,M,K): "
                         f"{tuple(value.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(w.shape)}")
    B, _, M, _ = value.shape
    if idx.shape[0] != B or idx.shape[2] != M:
        raise ValueError(f"idx {tuple(idx.shape)} does not match value "
                         f"{tuple(value.shape)}")
    for name, t in (("value", value), ("idx", idx), ("w", w)):
        if t.device != value.device:
            raise ValueError(f"{name} is on {t.device}, value on "
                             f"{value.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if torch.is_grad_enabled() and t.requires_grad:
            raise RuntimeError(
                "corner_gather has no backward kernel; MSDA's gradient goes "
                "through ops.msda.ms_deform_attn")


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("corner_gather_fwd")
    lib.corner_gather_fwd.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 7
                                      + [ctypes.c_void_p])
    lib.corner_gather_fwd.restype = ctypes.c_int
    lib.corner_gather_fwd_error_string.argtypes = [ctypes.c_int]
    lib.corner_gather_fwd_error_string.restype = ctypes.c_char_p
    lib.corner_gather_fwd_vector_launches.restype = ctypes.c_longlong
    lib.corner_gather_fwd_scalar_launches.restype = ctypes.c_longlong
    return lib


def kernel_paths():
    """{"vector": n, "scalar": n}: the launches of each kernel of
    ``csrc/corner_gather_fwd.cu`` since it was loaded, as its C entry counts
    them where it chooses the path (the vector kernel for rows of whole
    16-byte chunks, K a multiple of 4 and 16-byte aligned pointers)."""
    lib = _library()
    return {"vector": lib.corner_gather_fwd_vector_launches(),
            "scalar": lib.corner_gather_fwd_scalar_launches()}


def corner_gather_cuda(value, idx, w):
    """Launch ``csrc/corner_gather_fwd.cu`` on CUDA tensors."""
    _check_kernel_args(value, idx, w)
    B, S, M, D = value.shape
    _, Lq, _, K = idx.shape
    lib = _library()
    out = torch.empty((B, Lq, M, D), dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.corner_gather_fwd(value.data_ptr(), idx.data_ptr(),
                                   w.data_ptr(), out.data_ptr(), B, S, M, D,
                                   Lq, K, _DTYPE_CODES[value.dtype], stream)
    if rc < 0:
        raise ValueError(f"corner_gather_fwd refused its arguments (code "
                         f"{rc})")
    if rc > 0:
        raise RuntimeError("corner_gather_fwd launch failed: "
                           + lib.corner_gather_fwd_error_string(rc).decode())
    trace.count("corner_gather")
    return out


def corner_gather(value, idx, w):
    """The weighted row gather: the plain version for CPU tensors, K5b/c
    (``csrc/corner_gather_fwd.cu``) for CUDA tensors.
    The counter ``corner_gather`` (``utils/trace.py``) counts kernel
    launches."""
    if value.device.type == "cpu":
        return corner_gather_plain(value, idx, w)
    if value.device.type != "cuda":
        raise ValueError(f"corner_gather runs on cpu or cuda, not "
                         f"{value.device}")
    return corner_gather_cuda(value, idx, w)


def onehot_sample(v_bm, idx_bm, w_bm):
    """``out[b, q] = sum_k w[b, q, k] * v[b, idx[b, q, k]]`` in the JAX
    package's layout: v_bm ``(BM, S, D)``, idx_bm and w_bm ``(BM, Lq, K)``;
    returns ``(BM, Lq, D)``. Counterpart of
    ``dfvod_tpu/ops/msda_pallas.py::onehot_sample`` (K5b)."""
    out = corner_gather(v_bm[:, :, None], idx_bm[:, :, None],
                        w_bm[:, :, None])
    return out[:, :, 0]
