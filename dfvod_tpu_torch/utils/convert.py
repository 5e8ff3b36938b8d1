"""Weights carried across from the JAX package.

``load_jax_variables(model, variables)`` fills a port module from the flax
variables of its counterpart, given as nested dicts of numpy arrays:
``params``, ``constants`` (FrozenBatchNorm buffers) and ``batch_stats``
(DFormer BatchNorm running statistics). Port submodules carry the flax
module names, so the mapping is mechanical:

- Dense ``kernel`` (in, out) -> Linear ``weight`` (out, in)
- Conv ``kernel`` HWIO -> Conv2d ``weight`` OIHW
- LayerNorm / GroupNorm / BatchNorm ``scale`` -> ``weight``
- BatchNorm ``mean`` / ``var`` -> ``running_mean`` / ``running_var``
- everything else keeps its name (``bias``, ``level_embed``, the FrozenBN
  buffers ...)

Coverage is checked both ways: a flax leaf that fills no port key, or a
port key that no flax leaf fills, raises. A reference ``.pth`` loads
through ``utils/convert_reference.py``.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def port_key(collection: str, path, value: np.ndarray):
    """(state-dict key, value in the port's layout) of one flax leaf."""
    *mods, leaf = path
    if collection == "params":
        if leaf == "kernel":
            name = "weight"
            if value.ndim == 2:
                value = value.T
            elif value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            name = "weight"
        else:
            name = leaf
    elif collection == "batch_stats":
        name = {"mean": "running_mean", "var": "running_var"}[leaf]
    elif collection == "constants":
        name = leaf
    else:
        raise ValueError(f"unknown flax collection {collection!r}")
    return ".".join(mods + [name]), value


def load_jax_variables(model: nn.Module, variables) -> nn.Module:
    """Copy flax ``variables`` into ``model`` (in place, cast to each
    tensor's dtype and device). Returns the model."""
    state = model.state_dict()
    new = {}
    unused, mismatched = [], []
    for collection, tree in variables.items():
        for path, value in _leaves(tree):
            key, value = port_key(collection, path, value)
            if key not in state:
                unused.append(f"{collection}/{'/'.join(path)}")
            elif tuple(state[key].shape) != value.shape:
                mismatched.append(f"{key}: port {tuple(state[key].shape)}"
                                  f" vs flax {value.shape}")
            else:
                new[key] = torch.from_numpy(np.ascontiguousarray(value))
    unfilled = sorted(set(state) - set(new))
    if unused or mismatched or unfilled:
        raise ValueError(
            f"weight mapping incomplete: {len(unused)} flax leaves unused "
            f"{unused[:8]}, {len(unfilled)} port keys unfilled "
            f"{unfilled[:8]}, shape mismatches {mismatched[:8]}")
    model.load_state_dict(new)
    return model
