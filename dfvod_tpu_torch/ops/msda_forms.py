"""The JAX package's other public MSDA forms, each reaching a Hopper kernel.

Counterparts of the public functions of ``dfvod_tpu/ops/msda_pallas.py``;
same contract as ``ops/msda.py``. On the TPU each is its own Pallas kernel,
shaped by Mosaic having no fast gather: a dense one-hot or tent matrix
contracted with the value slab on the MXU, or an in-kernel row gather. On
Hopper they compute two functions, so they reach two kernels:

- the folded-corner row gather, K5b/c (``csrc/corner_gather_fwd.cu``):
  ``ms_deform_attn_onehot``, ``ms_deform_attn_gather``;
- the per-level bilinear gather, K1 (``csrc/msda_fwd.cu``):
  ``ms_deform_attn_hat`` (dense), ``ms_deform_attn_hat_tiled`` and
  ``ms_deform_attn_hat_sep``. The tiled and separable forms differ from the
  dense one only in how they build the tent matrix for the MXU, which a
  gather never forms;
- ``ms_deform_attn_hat(sparse=True)`` samples the levels stacked along y,
  K5a (``ops/hat_sample.py::hat_sample_sparse``).

Each goes through ``ops.msda.ms_deform_attn`` with its form, so on the card
the first five take K2 as their backward; the sparse form has no backward
kernel, as the JAX function has none. On CPU tensors each takes its plain
version.
"""
from __future__ import annotations

import torch

from dfvod_tpu_torch.ops.hat_sample import hat_sample_sparse
from dfvod_tpu_torch.ops.msda import ms_deform_attn


def ms_deform_attn_onehot(value, spatial_shapes, sampling_locations,
                          attention_weights):
    """Counterpart of ``ms_deform_attn_pallas_onehot`` (K5b)."""
    return ms_deform_attn(value, spatial_shapes, sampling_locations,
                          attention_weights, impl="pallas_onehot")


def ms_deform_attn_gather(value, spatial_shapes, sampling_locations,
                          attention_weights):
    """Counterpart of ``ms_deform_attn_pallas`` (K5c)."""
    return ms_deform_attn(value, spatial_shapes, sampling_locations,
                          attention_weights, impl="pallas")


def ms_deform_attn_hat(value, spatial_shapes, sampling_locations,
                       attention_weights, sparse: bool = False):
    """Counterpart of ``ms_deform_attn_pallas_hat``: K1, or with
    ``sparse=True`` the level-stacked sampling K5a on the pixel coordinates
    the JAX function builds (``loc * W - 0.5``; ``py`` plus the level
    offset ``sum_{j<l} (H_j + 2)``)."""
    if not sparse:
        return ms_deform_attn(value, spatial_shapes, sampling_locations,
                              attention_weights, impl="pallas_hat")
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    B, S, M, D = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    loc = sampling_locations.float()
    pxs, pys = [], []
    y_off = 0.0
    for lvl, (H, W) in enumerate(spatial_shapes):
        pxs.append(loc[:, :, :, lvl, :, 0] * W - 0.5)
        pys.append(loc[:, :, :, lvl, :, 1] * H - 0.5 + y_off)
        y_off += H + 2.0

    def bm(t):                                 # (B, Lq, M, PL) -> (BM, Lq, PL)
        return t.transpose(1, 2).reshape(B * M, Lq, L * P).contiguous()

    aw = attention_weights.float().reshape(B, Lq, M, L * P)
    v_bm = value.transpose(1, 2).reshape(B * M, S, D).contiguous()
    out = hat_sample_sparse(v_bm, spatial_shapes, bm(torch.cat(pxs, -1)),
                            bm(torch.cat(pys, -1)), bm(aw))
    return out.reshape(B, M, Lq, D).transpose(1, 2).reshape(B, Lq, M * D)


def _single_level(spatial_shapes, form: str):
    if len(spatial_shapes) != 1:
        raise ValueError(f"the {form} hat form is single-level, not "
                         f"{len(spatial_shapes)} levels")


def ms_deform_attn_hat_tiled(value, spatial_shapes, sampling_locations,
                             attention_weights):
    """Counterpart of ``ms_deform_attn_pallas_hat_tiled`` (K5d): K1 at one
    level."""
    _single_level(spatial_shapes, "tiled")
    return ms_deform_attn(value, spatial_shapes, sampling_locations,
                          attention_weights, impl="pallas_hat")


def ms_deform_attn_hat_sep(value, spatial_shapes, sampling_locations,
                           attention_weights):
    """Counterpart of ``ms_deform_attn_pallas_hat_sep`` (K5e): K1 at one
    level."""
    _single_level(spatial_shapes, "separable")
    return ms_deform_attn(value, spatial_shapes, sampling_locations,
                          attention_weights, impl="pallas_hat")
