"""Int8 serving quantization (W8A8), counterpart of
``dfvod_tpu/ops/quant.py``.

The model quantizes at the JAX package's seams: the ResNet-50 bottleneck
convs (``models/backbone_resnet.py::Bottleneck``, seam tags
``conv{K}x{K}_c{Cin}``) and the ``QLinear`` layers of
``models/layers.py`` (``MSDeformAttn.value_proj`` / ``output_proj``, tag
``"proj"``; ``FFN.linear1`` / ``linear2``, tag ``"ffn"``).

Scheme, in the JAX package's order:

- weights: symmetric per-output-channel scales ``max|w| / 127`` floored at
  1e-8, ``round`` (half to even), clipped to +-127, int8;
- activations: a symmetric per-tensor scale ``max(max|x|, 1e-6) / 127``,
  recomputed on every call;
- the products accumulate in int32 (``torch._int_mm``: cuBLASLt's int8
  tensor-core GEMM on the card), dequantized as ``yq.float() * (sx *
  sw)``, then cast back to the activation dtype. A conv is an int8
  im2col (slices of the zero-padded NHWC activations) times the weights.

Unlike the JAX package, whose mode is read when a program is traced, the
mode is read on every call (``int8_mode`` takes effect at once, as
``DFVOD_MSDA_IMPL`` does). Training never quantizes: a quantized product
with autograd recording raises. Where autograd records nothing, the
callers keep their quantized weights (``utils/weight_cache.py``) until a
source weight changes, as a deployment pre-quantizes; the values are those
a fresh quantization gives.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_STATE = {"mode": "", "seams": None, "act_scale": None}


def _match(tag: str, seams) -> bool:
    """Tag matcher for the seam allowlist. Entries are exact tags
    (``"ffn"``, ``"conv3x3_c128"``) or ``*``-suffixed prefixes
    (``"conv3x3*"``)."""
    for s in seams:
        if s.endswith("*"):
            if tag.startswith(s[:-1]):
                return True
        elif tag == s:
            return True
    return False


def enabled(tag: str | None = None) -> bool:
    """True when int8 serving mode is active; with a ``tag``, also when the
    seam allowlist (None: every seam) lets that call site quantize."""
    if _STATE["mode"] != "int8":
        return False
    if tag is None or _STATE["seams"] is None:
        return True
    return _match(tag, _STATE["seams"])


def set_mode(mode: str, seams=None) -> None:
    """Process-wide switch (``""`` or ``"int8"``). ``seams`` (an iterable
    of tags / ``*``-prefixes) restricts quantization to the matching call
    sites; None quantizes every seam."""
    if mode not in ("", "int8"):
        raise ValueError(f"quantization mode {mode!r}: '' or 'int8'")
    _STATE["mode"] = mode
    _STATE["seams"] = None if seams is None else frozenset(seams)


@contextlib.contextmanager
def int8_mode(on: bool = True, seams=None):
    prev = (_STATE["mode"], _STATE["seams"])
    _STATE["mode"] = "int8" if on else ""
    _STATE["seams"] = None if seams is None else frozenset(seams)
    try:
        yield
    finally:
        _STATE["mode"], _STATE["seams"] = prev


@contextlib.contextmanager
def static_act_scale(scale: float):
    """Speed-ceiling diagnostic: a fixed activation scale in place of the
    dynamic per-tensor max (wrong numerics; for timing only)."""
    prev = _STATE["act_scale"]
    _STATE["act_scale"] = float(scale)
    try:
        yield
    finally:
        _STATE["act_scale"] = prev


def refuse_autograd(*tensors) -> None:
    """Raise when autograd would record a quantized product of
    ``tensors``: ``torch._int_mm`` has no backward, and the JAX package
    never quantizes in training."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "int8 serving mode (ops/quant.int8_mode) quantizes only where "
            "autograd records nothing: serve under torch.no_grad(), or "
            "leave the mode to train")


def _div127(t):
    """``t / 127`` rounded as a true division. A Python scalar divisor on
    the card becomes a multiplication by its reciprocal, which can land
    one ulp away (and then flip roundings); a 0-d tensor on the device
    divides. ``new_full`` fills it there: ``new_tensor`` would copy from
    the host and wait for the card."""
    return t / t.new_full((), 127.0)


def quantize_weight(w, reduce_axes):
    """Symmetric per-channel int8 weights: ``(wq int8, scale f32)``, the
    scale keepdims-shaped for broadcast against ``w``."""
    wf = w.float()
    s = _div127(wf.abs().amax(dim=tuple(reduce_axes), keepdim=True))
    s = torch.clamp_min(s, 1e-8)
    wq = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return wq, s


def quantize_act(x):
    """Symmetric per-tensor dynamic int8 activations: ``(xq, scale)``, the
    scale a 0-d f32 tensor."""
    xf = x.float()
    if _STATE["act_scale"] is not None:
        s = xf.new_full((), _STATE["act_scale"])
    else:
        s = _div127(torch.clamp_min(xf.abs().amax(), 1e-6))
    xq = torch.div(xf, s).round_().clamp_(-127, 127).to(torch.int8)
    return xq, s


def int_mm(a, w_nk):
    """``a (M, K) int8 @ w_nk (N, K).T`` -> (M, N) int32 through
    ``torch._int_mm``. On the card cuBLASLt takes more than 16 rows and
    K and N that are multiples of 8: other shapes are padded with zeros,
    which add nothing to an integer sum, and the result is sliced back."""
    M, K = a.shape
    N = w_nk.shape[0]
    pm, pk, pn = max(17 - M, 0), -K % 8, -N % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        w_nk = F.pad(w_nk, (0, pk, 0, pn))
    y = torch._int_mm(a.contiguous(), w_nk.contiguous().t())
    return y[:M, :N] if pm or pn else y


def linear_q(x, wq, sw, bias=None):
    """``x (..., K) @ W.T + bias`` in W8A8 with ``wq`` (N, K) int8 and
    ``sw`` (N,) f32 from ``quantize_weight``; the bias is added in f32
    before the cast to x's dtype."""
    refuse_autograd(x, bias)
    xq, sx = quantize_act(x)
    yq = int_mm(xq.reshape(-1, x.shape[-1]), wq)
    y = yq.float() * (sx * sw)
    if bias is not None:
        y = y + bias.float()
    return y.reshape(*x.shape[:-1], -1).to(x.dtype)


def dense_int8(x, kernel, bias=None):
    """W8A8 dense: ``x @ kernel + bias`` with int32 accumulation; ``x``
    (..., K), ``kernel`` (K, N) as the JAX function takes it (an
    ``nn.Linear``'s weight transposed), per-output-column scales."""
    refuse_autograd(kernel)
    wq, sw = quantize_weight(kernel, reduce_axes=(0,))       # (1, N)
    return linear_q(x, wq.t(), sw[0], bias)


def conv_q(x, wq, sw, stride=(1, 1), padding=((0, 0), (0, 0)),
           rhs_dilation=(1, 1)):
    """W8A8 conv of NCHW ``x`` with ``wq`` (O, KH, KW, C) int8 and ``sw``
    (O,) f32 (``quantize_conv_weight``): the im2col of the quantized
    activations (KH*KW strided slices of the zero-padded NHWC int8
    tensor) times the weights in int32, dequantized. Returns NCHW in x's
    dtype, channels-last in memory; no bias."""
    refuse_autograd(x)
    xq, sx = quantize_act(x)
    B, C, H, W = x.shape
    O, KH, KW = wq.shape[:3]
    KK = KH * KW
    (pt, pb), (pl, pr) = padding
    (sh, sw_), (dh, dw) = stride, rhs_dilation
    Ho = (H + pt + pb - dh * (KH - 1) - 1) // sh + 1
    Wo = (W + pl + pr - dw * (KW - 1) - 1) // sw_ + 1
    xn = xq.permute(0, 2, 3, 1)
    if pt or pb or pl or pr:
        xn = F.pad(xn, (0, 0, pl, pr, pt, pb))
    cols = [xn[:, ky * dh:ky * dh + (Ho - 1) * sh + 1:sh,
               kx * dw:kx * dw + (Wo - 1) * sw_ + 1:sw_]
            for ky in range(KH) for kx in range(KW)]
    a = cols[0] if KK == 1 else torch.stack(cols, 3)
    yq = int_mm(a.reshape(B * Ho * Wo, KK * C), wq.reshape(O, KK * C))
    y = yq.float() * (sx * sw)
    return y.to(x.dtype).reshape(B, Ho, Wo, O).permute(0, 3, 1, 2)


def quantize_conv_weight(w):
    """OIHW ``w`` -> (``wq`` (O, KH, KW, C) int8, ``sw`` (O,) f32),
    per-output-channel as the JAX package's HWIO ``quantize_weight(w,
    (0, 1, 2))``."""
    wq, sw = quantize_weight(w, reduce_axes=(1, 2, 3))       # (O, 1, 1, 1)
    return wq.permute(0, 2, 3, 1).contiguous(), sw.reshape(-1)


def conv_int8(x, w, stride=(1, 1), padding=((0, 0), (0, 0)),
              rhs_dilation=(1, 1)):
    """W8A8 conv, the port's layouts: ``x`` NCHW, ``w`` OIHW with any norm
    scaling folded in; the bias is the caller's (added after
    dequantization)."""
    refuse_autograd(w)
    wq, sw = quantize_conv_weight(w)
    return conv_q(x, wq, sw, stride, padding, rhs_dilation)
