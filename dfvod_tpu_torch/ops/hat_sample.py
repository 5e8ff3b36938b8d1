"""Weighted bilinear sampling over a token grid (the op under RoIAlign): the
plain PyTorch version and the wrapper of the hand-written CUDA kernel
``csrc/hat_sample_fwd.cu`` (K3).

Counterpart of ``dfvod_tpu/ops/msda_pallas.py::hat_sample``. The contract:

- ``value`` : ``(BM, H, W, D)``, or flat ``(BM, S = H * W, D)`` with
              ``grid=(H, W)``; token ``s`` sits at ``(s // W, s % W)``, the
              regular grid the package's only caller builds
              (``dfvod_tpu/ops/roi_align.py:90-91``)
- ``px``, ``py``, ``aw`` : ``(BM, Lq, PL)`` f32 pixel coordinates and
              weights of the PL sample points of each query
- output    : ``(BM, Lq, D)`` in the value's dtype,
              ``out[b, q] = sum_p aw[b, q, p] * bilinear(v[b], py, px)``

The bilinear weight of token ``(sy, sx)`` is the tent
``relu(1 - |px - sx|) * relu(1 - |py - sy|)``: a corner outside the grid
contributes 0. These are pixel-index coordinates, so unlike MSDA there is
no -0.5 shift. A point with a non-finite coordinate, or one far outside
(the -1e6 padding of the Pallas wrapper), contributes 0. Coordinates and
the sum are f32; the result is cast to the value's dtype once.

``hat_sample`` takes the plain version for CPU tensors only. For CUDA
tensors it launches K3 through ``HatSampleFunction`` or raises; the
kernel's backward (K4) waits for the TransVOD++ training slice, so a
backward through it raises rather than returning no gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dfvod_tpu_torch.ops import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _flat(value, grid):
    """(flat (BM, S, D) value, (H, W)) from a (BM, H, W, D) value, or from
    a flat one and its grid."""
    if value.dim() == 4:
        BM, H, W, D = value.shape
        if grid is not None and tuple(grid) != (H, W):
            raise ValueError(f"grid {tuple(grid)} != value grid {(H, W)}")
        return value.reshape(BM, H * W, D), (int(H), int(W))
    if value.dim() != 3 or grid is None:
        raise ValueError("value must be (BM, H, W, D), or (BM, S, D) with "
                         "grid=(H, W)")
    H, W = (int(g) for g in grid)
    if value.shape[1] != H * W:
        raise ValueError(f"value has {value.shape[1]} tokens, grid {(H, W)} "
                         f"has {H * W}")
    return value, (H, W)


def hat_sample_plain(value, px, py, aw, grid=None):
    """Loop over the PL points and the 4 corners of each, like
    ``ms_deform_attn_plain``: one gather of (BM, Lq, D) rows per corner."""
    v, (H, W) = _flat(value, grid)
    BM, S, D = v.shape
    _, Lq, PL = px.shape
    px, py, aw = px.float(), py.float(), aw.float()
    # every corner outside the grid, or a non-finite coordinate: 0
    inside = (px > -1) & (px < W) & (py > -1) & (py < H)
    x = torch.where(inside, px, torch.zeros_like(px))
    y = torch.where(inside, py, torch.zeros_like(py))
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    acc = torch.zeros((BM, Lq, D), dtype=torch.float32, device=v.device)
    for p in range(PL):
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            cx, cy = x0i[..., p] + dx, y0i[..., p] + dy
            valid = (inside[..., p] & (cx >= 0) & (cx < W) & (cy >= 0)
                     & (cy < H))
            w = ((fy[..., p] if dy else 1 - fy[..., p])
                 * (fx[..., p] if dx else 1 - fx[..., p]) * aw[..., p])
            w = torch.where(valid, w, torch.zeros_like(w))   # (BM, Lq)
            idx = cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)
            g = torch.gather(v, 1, idx[..., None].expand(-1, -1, D))
            acc += w[..., None] * g.float()
    return acc.to(v.dtype)


def _check_kernel_args(v, px, py, aw):
    if v.dtype not in _DTYPE_CODES:
        raise TypeError(f"hat_sample_fwd takes f32 or bf16 values, not "
                        f"{v.dtype}")
    BM, _, D = v.shape
    for name, t in (("px", px), ("py", py), ("aw", aw)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be f32, not {t.dtype}")
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, value on {v.device}")
        if t.dim() != 3 or t.shape[0] != BM or t.shape != px.shape:
            raise ValueError(f"px, py, aw must be (BM={BM}, Lq, PL): "
                             f"{tuple(px.shape)}, {tuple(py.shape)}, "
                             f"{tuple(aw.shape)}")
    for name, t in (("value", v), ("px", px), ("py", py), ("aw", aw)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _library():
    """The loaded ``csrc/hat_sample_fwd.cu`` with its argument types set."""
    lib = build.load("hat_sample_fwd")
    lib.hat_sample_fwd.argtypes = ([ctypes.c_void_p] * 5
                                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.hat_sample_fwd.restype = ctypes.c_int
    lib.hat_sample_fwd_error_string.argtypes = [ctypes.c_int]
    lib.hat_sample_fwd_error_string.restype = ctypes.c_char_p
    return lib


def hat_sample_cuda(value, px, py, aw, grid=None):
    """Launch ``csrc/hat_sample_fwd.cu`` on CUDA tensors."""
    v, (H, W) = _flat(value, grid)
    _check_kernel_args(v, px, py, aw)
    BM, S, D = v.shape
    _, Lq, PL = px.shape
    lib = _library()
    out = torch.empty((BM, Lq, D), dtype=v.dtype, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hat_sample_fwd(v.data_ptr(), px.data_ptr(), py.data_ptr(),
                                aw.data_ptr(), out.data_ptr(), BM, H, W, D,
                                Lq, PL, _DTYPE_CODES[v.dtype], stream)
    if rc < 0:
        raise ValueError(f"hat_sample_fwd refused its arguments (code {rc})")
    if rc > 0:
        raise RuntimeError("hat_sample_fwd launch failed: "
                           + lib.hat_sample_fwd_error_string(rc).decode())
    hat_sample.launches += 1
    return out


class HatSampleFunction(torch.autograd.Function):
    """K3 on CUDA tensors. Its backward is K4
    (``dfvod_tpu/ops/msda_pallas.py::_hat_bwd_kernel``), which waits for
    the TransVOD++ training slice: it raises instead of cutting the
    gradient."""

    @staticmethod
    def forward(ctx, value, px, py, aw, grid):
        return hat_sample_cuda(value, px, py, aw, grid)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the backward of hat_sample on the card is K4 "
            "(_hat_bwd_kernel), which waits for the TransVOD++ training "
            "slice")


def hat_sample(value, px, py, aw, grid=None):
    """Weighted bilinear sampling: the plain version for CPU tensors
    (autograd differentiates it), ``HatSampleFunction`` (K3) for CUDA
    tensors. ``hat_sample.launches`` counts kernel launches."""
    if value.device.type == "cpu":
        return hat_sample_plain(value, px, py, aw, grid)
    if value.device.type != "cuda":
        raise ValueError(f"hat_sample runs on cpu or cuda, not "
                         f"{value.device}")
    grid = None if grid is None else tuple(int(g) for g in grid)
    return HatSampleFunction.apply(value, px, py, aw, grid)


hat_sample.launches = 0
