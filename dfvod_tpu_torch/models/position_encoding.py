"""2-D sine position embeddings (counterpart of
``dfvod_tpu/models/position_encoding.py``), channels-last."""
from __future__ import annotations

import math

import torch


def _dim_t(num_pos_feats: int, temperature: float, device):
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    return temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)


def _interleave_sincos(vals, dim_t):
    """vals (..., 1) / dim_t (F,) -> DETR sin/cos interleave (..., F)."""
    p = vals / dim_t
    return torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])],
                       dim=-1).flatten(-2)


def sine_position_embedding(not_mask, num_pos_feats: int = 128,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: float = 2 * math.pi):
    """Sine position embedding from a validity mask.

    not_mask: (B, H, W) float/bool, 1 for valid pixels. Returns
    (B, H, W, 2 * num_pos_feats): y-embedding then x-embedding.
    """
    not_mask = not_mask.to(torch.float32)
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        eps = 1e-6
        y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + eps) * scale
        x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + eps) * scale
    dim_t = _dim_t(num_pos_feats, temperature, not_mask.device)
    pos_x = _interleave_sincos(x_embed[..., None], dim_t)
    pos_y = _interleave_sincos(y_embed[..., None], dim_t)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_position_embedding_rect(not_mask, num_pos_feats: int = 128,
                                 temperature: float = 10000.0,
                                 scale: float = 2 * math.pi):
    """``sine_position_embedding`` for rectangular top-left validity masks,
    the only masks the model produces (padding is bottom/right). The cumsum
    field is separable, so the embedding is a (B, H, F) row table, a
    (B, W, F) column table and one padded-region constant
    ``-0.5 / eps * scale``, broadcast and selected. Equal to the general
    form on such masks."""
    not_mask = not_mask.to(torch.float32)
    B, H, W = not_mask.shape
    dev = not_mask.device
    eps = 1e-6
    valid_h = not_mask[:, :, 0].sum(1)                 # (B,)
    valid_w = not_mask[:, 0, :].sum(1)
    rows = torch.arange(1, H + 1, dtype=torch.float32, device=dev)
    cols = torch.arange(1, W + 1, dtype=torch.float32, device=dev)
    r = torch.minimum(rows[None, :], valid_h[:, None])  # (B, H) cumsum row
    c = torch.minimum(cols[None, :], valid_w[:, None])  # (B, W)
    r = (r - 0.5) / (valid_h[:, None] + eps) * scale
    c = (c - 0.5) / (valid_w[:, None] + eps) * scale
    k = torch.full((1,), -0.5 / eps * scale, dtype=torch.float32,
                   device=dev)                          # padded-region value
    dim_t = _dim_t(num_pos_feats, temperature, dev)
    ty = _interleave_sincos(r[..., None], dim_t)        # (B, H, F)
    tx = _interleave_sincos(c[..., None], dim_t)        # (B, W, F)
    tk = _interleave_sincos(k, dim_t)                   # (F,)
    rowvalid = not_mask[:, :, 0] > 0                    # (B, H)
    colvalid = not_mask[:, 0, :] > 0                    # (B, W)
    pos_y = torch.where(colvalid[:, None, :, None], ty[:, :, None, :], tk)
    pos_x = torch.where(rowvalid[:, :, None, None], tx[:, None, :, :], tk)
    return torch.cat([pos_y, pos_x], dim=-1)


def proposal_pos_embed(proposals, num_pos_feats: int = 128,
                       temperature: float = 10000.0):
    """Sine embedding of two-stage proposal boxes (``proposal_pos_embed``
    of the JAX package). proposals: (..., 4) unactivated, ``+inf`` where a
    token is padded or out of the validity band (sigmoid gives 1 there).
    Returns (..., 4 * num_pos_feats) f32: for each coordinate the DETR
    sin/cos interleave, coordinates in order. The sigmoid and scale run in
    the proposals' dtype and the rest in f32, as the JAX function's type
    promotion does."""
    pos = torch.sigmoid(proposals) * (2 * math.pi)
    dim_t = _dim_t(num_pos_feats, temperature, proposals.device)
    return _interleave_sincos(pos[..., None].float(), dim_t).flatten(-2)
