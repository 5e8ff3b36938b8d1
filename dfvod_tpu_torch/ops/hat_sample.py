"""Weighted bilinear sampling over a token grid (the op under RoIAlign): the
plain PyTorch version and its backward, and the wrappers of the
hand-written CUDA kernels ``csrc/hat_sample_fwd.cu`` (K3) and
``csrc/hat_sample_bwd.cu`` (K4, its backward), joined as a
``torch.autograd.Function``. Also the same sampling over MSDA's levels
stacked along y, ``hat_sample_sparse``, and the wrapper of its kernel
``csrc/hat_sample_sparse_fwd.cu`` (K5a).

Counterpart of ``dfvod_tpu/ops/msda_pallas.py::hat_sample``,
``hat_sample_bwd``, ``hat_sample_vjp`` and ``hat_sample_sparse``. The
contract:

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

The backward is the TPU kernel's: one-sided at integer coordinates
(``x0 = floor(px)``), an out-of-grid corner counting 0, and a point at
exactly -1 keeping the derivative its in-grid corner gives it, though its
value there is 0. A point with a non-finite coordinate gets zero gradients
(the Pallas kernel propagates the NaN).

``hat_sample`` takes the plain version for CPU tensors only, and autograd
differentiates it there. For CUDA tensors it goes through
``HatSampleFunction``, whose forward launches K3 and whose backward
launches K4, or raises.

``hat_sample_sparse(v_bm, spatial_shapes, px, py, aw)`` takes the level
table in place of the JAX function's token coordinates ``sx/sy``, which its
only caller builds from ``_hat_coords(spatial_shapes)``: level ``l``'s rows
sit at ``y`` offset ``yo_l = sum_{j<l} (H_j + 2)`` and its point columns
are ``l * P .. (l + 1) * P - 1``. Each point samples only its own level
(``py - yo_l`` on that level's grid), as ``ms_deform_attn_xla`` does; the
JAX kernel's stacked tent matrix also reads a neighbouring level for a
point more than about one row outside its own, and gives NaN, not 0, for a
non-finite point whose query block touches any chunk (ROADMAP, known
differences). It has no backward kernel, as the JAX function has none: on
the card it refuses inputs that need a gradient.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dfvod_tpu_torch.ops import build
from dfvod_tpu_torch.utils import trace

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
    return _sample_f32(v, H, W, px.float(), py.float(), aw.float()
                       ).to(v.dtype)


def _sample_f32(v, H: int, W: int, px, py, aw):
    """The f32 sum of ``hat_sample_plain`` over a flat (BM, H*W, D) value."""
    BM, S, D = v.shape
    acc = torch.zeros((BM, px.shape[1], D), dtype=torch.float32,
                      device=v.device)
    for p, _, _, corners in _corners(px, py, H, W):
        for valid, wy, wx, idx in corners:
            w = torch.where(valid, wy * wx * aw[..., p], 0.0)  # (BM, Lq)
            g = torch.gather(v, 1, idx[..., None].expand(-1, -1, D))
            acc += w[..., None] * g.float()
    return acc


def _level_stack(v_bm, spatial_shapes, px):
    """(spatial_shapes as ints, P points per level) of a level-stacked
    sampling; raises on shapes that do not match."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    S = sum(h * w for h, w in shapes)
    if v_bm.dim() != 3 or v_bm.shape[1] != S:
        raise ValueError(f"v_bm must be (BM, S={S}, D) for levels {shapes}, "
                         f"not {tuple(v_bm.shape)}")
    if px.dim() != 3 or not shapes or px.shape[-1] % len(shapes):
        raise ValueError(f"px {tuple(px.shape)} is not (BM, Lq, L * P) for "
                         f"{len(shapes)} levels")
    return shapes, px.shape[-1] // len(shapes)


def hat_sample_sparse_plain(v_bm, spatial_shapes, px, py, aw):
    """Each level's points sampled on that level's grid, ``py`` taken back
    by the level's offset; the f32 sums added, then cast once."""
    shapes, P = _level_stack(v_bm, spatial_shapes, px)
    px, py, aw = px.float(), py.float(), aw.float()
    acc = 0.0
    start, yo = 0, 0.0
    for lvl, (H, W) in enumerate(shapes):
        cols = slice(lvl * P, (lvl + 1) * P)
        acc = acc + _sample_f32(v_bm[:, start:start + H * W], H, W,
                                px[..., cols], py[..., cols] - yo,
                                aw[..., cols])
        start += H * W
        yo += H + 2.0
    return acc.to(v_bm.dtype)


def _corners(px, py, H: int, W: int):
    """For each point p: (p, fx, fy, [(valid, wy, wx, token index) of the
    corners 00, 01, 10, 11]), each (BM, Lq). A point outside [-1, W) x [-1, H), or
    with a non-finite coordinate, has no valid corner. At exactly -1 the
    corner at 0 is valid with weight 0, so autograd gives it the one-sided
    derivative; ``wx`` and ``wy`` are differentiable in px and py."""
    inside = (px >= -1) & (px < W) & (py >= -1) & (py < H)
    x = torch.where(inside, px, torch.zeros_like(px))
    y = torch.where(inside, py, torch.zeros_like(py))
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    for p in range(px.shape[-1]):
        corners = []
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            cx, cy = x0i[..., p] + dx, y0i[..., p] + dy
            valid = (inside[..., p] & (cx >= 0) & (cx < W) & (cy >= 0)
                     & (cy < H))
            corners.append((valid, fy[..., p] if dy else 1 - fy[..., p],
                            fx[..., p] if dx else 1 - fx[..., p],
                            cy.clamp(0, H - 1) * W + cx.clamp(0, W - 1)))
        yield p, fx[..., p], fy[..., p], corners


def hat_sample_plain_bwd(value, px, py, aw, grad_out, grid=None):
    """The plain backward, written out (no autograd): (gv, gpx, gpy, gaw).
    gv has the value's shape and dtype, the others are f32 like the
    points. Per point, with ``d_c = <go, v_c>`` of the 4 corners (0 outside
    the grid): gv scatters ``aw * w_c * go`` into the corners, ``gaw = sum
    w_c d_c``, ``gpx = aw ((1 - fy)(d01 - d00) + fy (d11 - d10))`` and gpy
    alike."""
    v, (H, W) = _flat(value, grid)
    BM, S, D = v.shape
    px, py, aw = px.float(), py.float(), aw.float()
    vf, go = v.float(), grad_out.float()
    gv = torch.zeros((BM, S, D), dtype=torch.float32, device=v.device)
    gpx, gpy, gaw = (torch.zeros_like(px) for _ in range(3))
    for p, fx, fy, corners in _corners(px, py, H, W):
        a = aw[..., p]
        d = []
        for valid, wy, wx, idx in corners:
            w = torch.where(valid, wy * wx, 0.0)
            rows = idx[..., None].expand(-1, -1, D)
            d.append(torch.where(valid, (go * torch.gather(vf, 1, rows)
                                         ).sum(-1), 0.0))
            gaw[..., p] += w * d[-1]
            gv.scatter_add_(1, rows, (a * w)[..., None] * go)
        gpx[..., p] = a * ((1 - fy) * (d[1] - d[0]) + fy * (d[3] - d[2]))
        gpy[..., p] = a * ((1 - fx) * (d[2] - d[0]) + fx * (d[3] - d[1]))
    return gv.to(value.dtype).reshape(value.shape), gpx, gpy, gaw


def _check_kernel_args(v, px, py, aw):
    if v.dtype not in _DTYPE_CODES:
        raise TypeError(f"the hat_sample kernels take f32 or bf16 values, "
                        f"not {v.dtype}")
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
def _library(name: str):
    """The loaded ``csrc/<name>.cu`` (``hat_sample_fwd``,
    ``hat_sample_bwd`` or ``hat_sample_sparse_fwd``) with its argument
    types set."""
    lib = build.load(name)
    fn = getattr(lib, name)
    fn.argtypes = {
        "hat_sample_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7,
        "hat_sample_bwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8,
        "hat_sample_sparse_fwd": [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int],
    }[name] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    if name == "hat_sample_bwd":
        lib.hat_sample_bwd_tile_rows.restype = ctypes.c_int
        lib.hat_sample_bwd_merged_tiles.restype = ctypes.c_longlong
    if name == "hat_sample_sparse_fwd":
        lib.hat_sample_sparse_fwd_vector_launches.restype = ctypes.c_longlong
        lib.hat_sample_sparse_fwd_scalar_launches.restype = ctypes.c_longlong
    return lib


def _raise_on(name: str, lib, rc: int):
    if rc < 0:
        raise ValueError(f"{name} refused its arguments (code {rc})")
    if rc > 0:
        raise RuntimeError(f"{name} launch failed: "
                           + getattr(lib, f"{name}_error_string")(rc).decode())


def hat_sample_cuda(value, px, py, aw, grid=None):
    """Launch ``csrc/hat_sample_fwd.cu`` (K3) on CUDA tensors."""
    v, (H, W) = _flat(value, grid)
    _check_kernel_args(v, px, py, aw)
    BM, _, D = v.shape
    _, Lq, PL = px.shape
    lib = _library("hat_sample_fwd")
    out = torch.empty((BM, Lq, D), dtype=v.dtype, device=v.device)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hat_sample_fwd(v.data_ptr(), px.data_ptr(), py.data_ptr(),
                                aw.data_ptr(), out.data_ptr(), BM, H, W, D,
                                Lq, PL, _DTYPE_CODES[v.dtype], stream)
    _raise_on("hat_sample_fwd", lib, rc)
    trace.count("hat_sample")
    return out


def hat_sample_sparse_cuda(v_bm, spatial_shapes, px, py, aw):
    """Launch ``csrc/hat_sample_sparse_fwd.cu`` (K5a) on CUDA tensors over
    the stacked levels. Refuses inputs that need a gradient: there is no
    backward kernel."""
    shapes, P = _level_stack(v_bm, spatial_shapes, px)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (v_bm, px, py, aw)):
        raise RuntimeError("hat_sample_sparse has no backward kernel (nor "
                           "has the JAX function); MSDA's gradient goes "
                           "through ops.msda.ms_deform_attn")
    _check_kernel_args(v_bm, px, py, aw)
    BM, S, D = v_bm.shape
    _, Lq, _ = px.shape
    lib = _library("hat_sample_sparse_fwd")
    out = torch.empty((BM, Lq, D), dtype=v_bm.dtype, device=v_bm.device)
    table = (ctypes.c_int * (2 * len(shapes)))(
        *[n for hw in shapes for n in hw])
    with torch.cuda.device(v_bm.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hat_sample_sparse_fwd(
            v_bm.data_ptr(), px.data_ptr(), py.data_ptr(), aw.data_ptr(),
            out.data_ptr(), BM, S, D, Lq, len(shapes), P, table,
            _DTYPE_CODES[v_bm.dtype], stream)
    _raise_on("hat_sample_sparse_fwd", lib, rc)
    trace.count("hat_sample_sparse")
    return out


def kernel_paths():
    """{"vector": n, "scalar": n}: the launches of each kernel of
    ``csrc/hat_sample_sparse_fwd.cu`` (K5a) since it was loaded, as its C
    entry counts them where it chooses the path (the vector kernel for rows
    of whole 16-byte chunks, at most 32 of them, and 16-byte aligned value
    and output)."""
    lib = _library("hat_sample_sparse_fwd")
    return {"vector": lib.hat_sample_sparse_fwd_vector_launches(),
            "scalar": lib.hat_sample_sparse_fwd_scalar_launches()}


def hat_sample_bwd_cuda(value, px, py, aw, grad_out, grid=None,
                        needs=(True, True, True, True)):
    """Launch ``csrc/hat_sample_bwd.cu`` on CUDA tensors: (gv, gpx, gpy,
    gaw), gv in the value's shape and dtype and the others f32, or None
    where ``needs`` (value, px, py, aw) is False. The point gradients are
    computed only when one of them is needed, and gv only when it is.
    ``grad_out`` is (BM, Lq, D), f32 or bf16."""
    v, (H, W) = _flat(value, grid)
    _check_kernel_args(v, px, py, aw)
    BM, S, D = v.shape
    _, Lq, PL = px.shape
    if grad_out.shape != (BM, Lq, D) or grad_out.dtype not in _DTYPE_CODES:
        raise ValueError(f"grad_out must be {(BM, Lq, D)} in f32 or bf16, "
                         f"not {tuple(grad_out.shape)} in {grad_out.dtype}")
    if grad_out.device != v.device or not grad_out.is_contiguous():
        raise ValueError("grad_out must be contiguous, on the value's device")
    need_v, need_x, need_y, need_a = needs
    gv32 = gv = gpx = gpy = gaw = None
    if need_v:
        # atomics accumulate in f32; an f32 value accumulates in place
        gv32 = torch.zeros((BM, S, D), dtype=torch.float32, device=v.device)
        gv = gv32 if v.dtype == torch.float32 else torch.empty_like(v)
    if need_x or need_y or need_a:
        gpx, gpy, gaw = (torch.empty_like(px) for _ in range(3))
    if gv is None and gpx is None:
        return None, None, None, None
    lib = _library("hat_sample_bwd")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hat_sample_bwd(
            v.data_ptr(), px.data_ptr(), py.data_ptr(), aw.data_ptr(),
            grad_out.data_ptr(), ptr(gv32), ptr(gv), ptr(gpx), ptr(gpy),
            ptr(gaw), BM, H, W, D, Lq, PL, _DTYPE_CODES[v.dtype],
            _DTYPE_CODES[grad_out.dtype], stream)
    _raise_on("hat_sample_bwd", lib, rc)
    trace.count("hat_sample_bwd")
    return (None if gv is None else gv.reshape(value.shape),
            gpx if need_x else None, gpy if need_y else None,
            gaw if need_a else None)


class HatSampleFunction(torch.autograd.Function):
    """Weighted bilinear sampling on CUDA tensors with its gradient: the
    forward launches K3 (``csrc/hat_sample_fwd.cu``), the backward K4
    (``csrc/hat_sample_bwd.cu``) for the inputs that need a gradient. gv
    comes back in the value's dtype, as ``hat_sample_vjp`` casts it."""

    @staticmethod
    def forward(ctx, value, px, py, aw, grid):
        ctx.grid = grid
        ctx.save_for_backward(value, px, py, aw)
        return hat_sample_cuda(value, px, py, aw, grid)

    @staticmethod
    def backward(ctx, grad_out):
        value, px, py, aw = ctx.saved_tensors
        grads = hat_sample_bwd_cuda(value, px, py, aw,
                                    grad_out.contiguous(), ctx.grid,
                                    ctx.needs_input_grad[:4])
        return (*grads, None)


def hat_sample(value, px, py, aw, grid=None):
    """Weighted bilinear sampling: the plain version for CPU tensors
    (autograd differentiates it), ``HatSampleFunction`` (K3 forward, K4
    backward) for CUDA tensors. The counters ``hat_sample`` and
    ``hat_sample_bwd`` (``utils/trace.py``) count forward and backward
    kernel launches."""
    if value.device.type == "cpu":
        return hat_sample_plain(value, px, py, aw, grid)
    if value.device.type != "cuda":
        raise ValueError(f"hat_sample runs on cpu or cuda, not "
                         f"{value.device}")
    grid = None if grid is None else tuple(int(g) for g in grid)
    return HatSampleFunction.apply(value, px, py, aw, grid)


def hat_sample_sparse(v_bm, spatial_shapes, px, py, aw):
    """Weighted bilinear sampling over MSDA's levels stacked along y:
    v_bm ``(BM, S, D)``, px/py/aw ``(BM, Lq, L * P)`` f32 with py carrying
    the level offsets; returns ``(BM, Lq, D)``. The plain version for CPU
    tensors, K5a (``csrc/hat_sample_sparse_fwd.cu``) for CUDA tensors;
    the counter ``hat_sample_sparse`` (``utils/trace.py``) counts the
    launches."""
    if v_bm.device.type == "cpu":
        return hat_sample_sparse_plain(v_bm, spatial_shapes, px, py, aw)
    if v_bm.device.type != "cuda":
        raise ValueError(f"hat_sample_sparse runs on cpu or cuda, not "
                         f"{v_bm.device}")
    return hat_sample_sparse_cuda(v_bm, spatial_shapes, px, py, aw)


def hat_sample_bwd(value, px, py, aw, grad_out, grid=None,
                   needs=(True, True, True, True)):
    """The VJP of ``hat_sample`` as a function: (gv, gpx, gpy, gaw), None
    where ``needs`` (value, px, py, aw) is False; the plain backward for
    CPU tensors, ``csrc/hat_sample_bwd.cu`` (K4) for CUDA tensors."""
    if value.device.type == "cpu":
        grads = hat_sample_plain_bwd(value, px, py, aw, grad_out, grid)
        return tuple(g if n else None for g, n in zip(grads, needs))
    if value.device.type != "cuda":
        raise ValueError(f"hat_sample_bwd runs on cpu or cuda, not "
                         f"{value.device}")
    return hat_sample_bwd_cuda(value, px, py, aw, grad_out, grid, needs)


def bwd_merged_tiles():
    """(rows per tile, tiles launched so far) of K4's merged path
    (``hat_sample_bwd_tile_kernel``), as ``csrc/hat_sample_bwd.cu`` counts
    them where it launches that kernel: a call on CUDA tensors took the
    merged path when the count grew by its ``BM * Lq`` rows over the rows
    per tile, rounded up, and the scalar path when it did not grow."""
    lib = _library("hat_sample_bwd")
    return lib.hat_sample_bwd_tile_rows(), lib.hat_sample_bwd_merged_tiles()
