"""Shared model layers: MSDeformAttn, MHA, MLP, FFN blocks (counterpart of
``dfvod_tpu/models/layers.py``).

Submodule names follow the flax modules (``value_proj``,
``sampling_offsets``, ``q_proj``, ``linear1``, ``norm`` ...) so weights map
mechanically (``utils/convert.py``). Tokens are ``(B, S, C)``.

Dropout sits where the JAX package has it and is active only in
``train()`` mode, drawing from a ``torch.Generator`` that the trainer owns
(``set_dropout_generator``). ``QLinear`` is the JAX package's ``QDense``:
an ``nn.Linear`` that runs W8A8 under ``ops/quant.int8_mode`` (the
MSDeformAttn projections, tag ``"proj"``, and the FFN linears, tag
``"ffn"``, as in the JAX package). Linear layers whose initial value is
part of the model's definition (zero kernels, the ring bias of
``sampling_offsets``) are marked ``keep_init`` so that
``models.init_parameters`` leaves them alone.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dfvod_tpu_torch.ops import ms_deform_attn, quant
from dfvod_tpu_torch.utils.weight_cache import WeightCache


def gelu(x):
    # exact (erf) form, torch's default
    return F.gelu(x)


ACTIVATIONS: dict = {"relu": F.relu, "gelu": gelu}


class Dropout(nn.Module):
    """Inverted dropout as flax's ``nn.Dropout``: in ``train()`` mode keep
    each element with probability ``1 - p`` and scale it by ``1 / (1 - p)``.
    The Bernoulli mask is drawn from ``self.generator``, which the trainer
    sets (``set_dropout_generator``); ``F.dropout`` takes no generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError("dropout in train mode needs a generator: "
                               "call set_dropout_generator(model, gen)")
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))

    def extra_repr(self):
        return f"p={self.p}"


def set_dropout_generator(model: nn.Module, generator: torch.Generator):
    """Let every ``Dropout`` of ``model`` draw from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def remat_call(module: nn.Module, *args):
    """``module(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant), the counterpart of flax's
    ``nn.remat``.

    ``checkpoint``'s ``preserve_rng_state`` covers only the global RNGs,
    and ``Dropout`` draws from its own generator. So the generators'
    states are taken before the call, set back for the recomputation, and
    the states the whole forward left are put back after it: the
    recomputation draws the forward's masks, and the next layer and step
    draw what they would without remat."""
    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, Dropout) and m.generator is not None
                 and m.training and m.p > 0.0}.values())
    start = [g.get_state() for g in gens]
    calls = []

    def run(*a):
        if not calls:
            calls.append(True)
            return module(*a)
        after = [g.get_state() for g in gens]
        for g, s in zip(gens, start):
            g.set_state(s)
        try:
            return module(*a)
        finally:
            # the recomputation may stop early, once it has what the
            # backward needs
            for g, s in zip(gens, after):
                g.set_state(s)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class QLinear(nn.Linear):
    """``nn.Linear`` (the same parameters and state-dict keys) that runs
    ``quant.linear_q`` when ``quant.enabled(tag)`` holds at call time, with
    its weight quantized once per change (``WeightCache``); with
    the mode off, ``nn.Linear``'s forward."""

    def __init__(self, in_features: int, out_features: int,
                 tag: str = "dense"):
        super().__init__(in_features, out_features)
        self.tag = tag
        self._quantized = WeightCache()

    def forward(self, x):
        if not quant.enabled(self.tag):
            return super().forward(x)
        quant.refuse_autograd(self.weight)

        def make():
            wq, sw = quant.quantize_weight(self.weight, reduce_axes=(1,))
            return wq, sw[:, 0]
        wq, sw = self._quantized.get((self.weight,), make)
        return quant.linear_q(x, wq, sw, self.bias)


def fixed_linear(in_features: int, out_features: int,
                 bias: Optional[np.ndarray] = None) -> nn.Linear:
    """Linear with a zero kernel and a given (default zero) bias, kept by
    ``init_parameters``."""
    lin = nn.Linear(in_features, out_features)
    with torch.no_grad():
        lin.weight.zero_()
        lin.bias.copy_(torch.zeros(out_features) if bias is None
                       else torch.as_tensor(bias, dtype=torch.float32))
    lin.keep_init = True
    return lin


def sampling_offset_bias(n_heads: int, n_levels: int, n_points: int):
    """Ring-of-directions bias init (``ms_deform_attn.py:62-70`` of the
    reference), flattened in (M, L, P, 2) order."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)  # (M, 2)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention module around the MSDA kernel;
    ``impl`` picks the MSDA form as the flax module's field does
    (``ops/msda.py::ms_deform_attn``)."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4, impl: str = "auto"):
        super().__init__()
        self.impl = impl
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"n_heads {n_heads}")
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        M, L, P = n_heads, n_levels, n_points
        self.value_proj = QLinear(d_model, d_model, tag="proj")
        self.sampling_offsets = fixed_linear(
            d_model, M * L * P * 2, sampling_offset_bias(M, L, P))
        self.attention_weights = fixed_linear(d_model, M * L * P)
        self.output_proj = QLinear(d_model, d_model, tag="proj")

    def forward(self, query, reference_points, input_flatten,
                spatial_shapes: Sequence[Tuple[int, int]],
                input_padding_mask=None):
        """
        query: (B, Lq, C); reference_points: (B, Lq, L, 2) in [0, 1] or
        (B, Lq, L, 4) boxes; input_flatten: (B, S, C) with S = sum(H*W);
        input_padding_mask: (B, S) bool, True for padding.
        Returns (B, Lq, C).
        """
        M, L, P = self.n_heads, self.n_levels, self.n_points
        D = self.d_model // M
        B, Lq, _ = query.shape
        S = input_flatten.shape[1]

        value = self.value_proj(input_flatten)
        if input_padding_mask is not None:
            value = value.masked_fill(input_padding_mask[..., None], 0.0)
        value = value.reshape(B, S, M, D)

        offsets = self.sampling_offsets(query).reshape(B, Lq, M, L, P, 2)
        attw = self.attention_weights(query).reshape(B, Lq, M, L * P)
        attw = attw.softmax(-1).reshape(B, Lq, M, L, P)

        if reference_points.shape[-1] == 2:
            # normalize offsets by (W, H) per level; wh in the offsets'
            # dtype, so f32 reference points + bf16 offsets give f32 loc,
            # as in the JAX package
            wh = torch.tensor([[w, h] for h, w in spatial_shapes],
                              dtype=offsets.dtype, device=offsets.device)
            loc = (reference_points[:, :, None, :, None, :]
                   + offsets / wh[None, None, None, :, None, :])
        elif reference_points.shape[-1] == 4:
            loc = (reference_points[:, :, None, :, None, :2]
                   + offsets / P
                   * reference_points[:, :, None, :, None, 2:] * 0.5)
        else:
            raise ValueError("reference_points last dim must be 2 or 4")

        out = ms_deform_attn(value.contiguous(), tuple(spatial_shapes),
                             loc.contiguous(), attw.contiguous(),
                             impl=self.impl)
        return self.output_proj(out)


class MultiHeadAttention(nn.Module):
    """Softmax MHA with separate q/k/v/out projections; logits and softmax
    in f32, probabilities cast back to the projection dtype, then dropout
    on them (``dfvod_tpu/models/layers.py:183-185``)."""

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.n_heads = d_model, n_heads
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.dropout = Dropout(dropout)

    def forward(self, q, k, v, key_padding_mask=None):
        M = self.n_heads
        D = self.d_model // M
        B, Lq, _ = q.shape
        Lk = k.shape[1]
        qp = self.q_proj(q).reshape(B, Lq, M, D)
        kp = self.k_proj(k).reshape(B, Lk, M, D)
        vp = self.v_proj(v).reshape(B, Lk, M, D)
        logits = torch.einsum("bqmd,bkmd->bmqk", qp.float(), kp.float())
        logits = logits / math.sqrt(D)
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        probs = self.dropout(logits.softmax(-1).to(qp.dtype))
        out = torch.einsum("bmqk,bkmd->bqmd", probs, vp)
        return self.out_proj(out.reshape(B, Lq, self.d_model))


class MLP(nn.Module):
    """ReLU MLP head (``deformable_detr_single.py:606-618``)."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layers_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class FFN(nn.Module):
    """Linear -> act -> dropout -> Linear -> dropout -> residual ->
    LayerNorm."""

    def __init__(self, d_model: int, d_ffn: int, activation: str = "relu",
                 dropout: float = 0.1):
        super().__init__()
        self.linear1 = QLinear(d_model, d_ffn, tag="ffn")
        self.linear2 = QLinear(d_ffn, d_model, tag="ffn")
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.act = ACTIVATIONS[activation]
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, x):
        h = self.dropout1(self.act(self.linear1(x)))
        return self.norm(x + self.dropout2(self.linear2(h)))


class SingleLinearFFN(nn.Module):
    """One-linear FFN of the fusion layers:
    LayerNorm(x + dropout(act(Linear(x))))."""

    def __init__(self, d_model: int, activation: str = "gelu",
                 dropout: float = 0.1):
        super().__init__()
        self.linear1 = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)
        self.act = ACTIVATIONS[activation]
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.norm(x + self.dropout(self.act(self.linear1(x))))


def with_pos(tensor, pos):
    return tensor if pos is None else tensor + pos
