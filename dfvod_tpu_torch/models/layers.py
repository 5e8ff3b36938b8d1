"""Shared model layers: MSDeformAttn, MHA, MLP, FFN blocks (counterpart of
``dfvod_tpu/models/layers.py``).

Submodule names follow the flax modules (``value_proj``,
``sampling_offsets``, ``q_proj``, ``linear1``, ``norm`` ...) so weights map
mechanically (``utils/convert.py``). Tokens are ``(B, S, C)``.

Dropout sits where the JAX package has it and is active only in
``train()`` mode, drawing from a ``torch.Generator`` that the trainer owns
(``set_dropout_generator``). The int8 path of ``QDense`` waits for a later
slice (here a plain ``nn.Linear``). Linear layers whose initial value is
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

from dfvod_tpu_torch.ops import ms_deform_attn


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
    """Multi-scale deformable attention module around the MSDA kernel."""

    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"n_heads {n_heads}")
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        M, L, P = n_heads, n_levels, n_points
        self.value_proj = nn.Linear(d_model, d_model)
        self.sampling_offsets = fixed_linear(
            d_model, M * L * P * 2, sampling_offset_bias(M, L, P))
        self.attention_weights = fixed_linear(d_model, M * L * P)
        self.output_proj = nn.Linear(d_model, d_model)

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
                             loc.contiguous(), attw.contiguous())
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
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
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
