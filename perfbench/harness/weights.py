"""Seeded weights, drawn on the device in one call and shared by the
program and the reference.

Every floating tensor of the reference model's state dict (whose names are
the port's) is ``base + scale * z``, ``z`` a slice of one normal draw from
a ``torch.Generator`` seeded by the run's seed (the FrozenBN variances and
the norm scales: ``exp(scale * z)``). ``base`` and ``scale`` follow
Deformable DETR's initialization where it is random (He for the bias-free
ResNet convolutions, Xavier for the linear layers and biased convolutions,
N(0, 1) for the embeddings) and put small noise on what that
initialization sets to constants (biases, the zero box kernels, the ring
of sampling offsets), so that every parameter moves the output. The
reference module gives the constants (``PRIOR_PROB``, ``WH_BIAS``) and
the ring (``ring_bias``); each deformable attention's ring has the
module's own level count (``offset_levels``).
"""
from __future__ import annotations

import math

import torch


# Per-channel spread of the ResNet's folded FrozenBN scales and of the
# LayerNorm / GroupNorm scales, log-normal as in trained networks (whose
# per-channel scales span an order of magnitude and more). bf16 keeps its
# relative precision across such channels; a per-tensor int8 scale does
# not, which is what lets the check tell the two apart.
BN_VAR_SPREAD = 1.5
NORM_SCALE_SPREAD = 0.35


def frozen_bn(name):
    """A FrozenBatchNorm of the ResNet (``bn1``..``bn3``, ``downsample_bn``;
    the DFormer's trainable BNs are ``stem_bn*`` / ``stage*_bn``)."""
    return ".bn" in name or "downsample_bn" in name


def norm_scale(name, shape):
    """The scale of a LayerNorm (``norm*``) or an input projection's
    GroupNorm (``gn``)."""
    leaf = name.rsplit(".", 2)
    return (len(shape) == 1 and leaf[-1] == "weight"
            and (leaf[-2].startswith("norm") or leaf[-2] == "gn"))


def _rule(name, shape, model_cfg, ref, levels):
    """(base tensor or float, scale) of one state-dict entry; ``ref`` the
    reference module, ``levels`` {name: level count} of the sampling
    offsets' biases (1 where it has none)."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("sampling_offsets.bias"):
        M, L = model_cfg["nheads"], levels.get(name, 1)
        return ref.ring_bias(M, L, shape[0] // (2 * M * L)), 0.1
    if name.endswith("sampling_offsets.weight"):
        return 0.0, 0.02
    if name.endswith("attention_weights.weight") or name.endswith(
            "attention_weights.bias"):
        return 0.0, 0.2
    if name.endswith("bbox_layers_2.weight"):
        return 0.0, 0.02
    if name.endswith("bbox_layers_2.bias"):
        return torch.tensor([0.0, 0.0, ref.WH_BIAS, ref.WH_BIAS]), 0.02
    if name.endswith("class_embed.bias"):
        return -math.log((1 - ref.PRIOR_PROB) / ref.PRIOR_PROB), 0.02
    if leaf in ("level_embed", "query_embed"):
        return 0.0, 1.0
    if leaf == "running_mean":
        return 0.0, 0.02 if frozen_bn(name) else 0.1
    if leaf == "running_var":
        if frozen_bn(name):
            return 0.0, BN_VAR_SPREAD              # log-normal, see draw
        return 1.0, 0.1
    if norm_scale(name, shape):
        return 0.0, NORM_SCALE_SPREAD              # log-normal, see draw
    if len(shape) == 1:
        # every other scale around 1, every bias around 0
        return (1.0 if leaf == "weight" else 0.0), 0.02
    fan_out = shape[0] * (math.prod(shape[2:]) if len(shape) > 2 else 1)
    fan_in = math.prod(shape[1:])
    if len(shape) == 4 and name.startswith(("backbone.", "detr.backbone.")):
        return 0.0, math.sqrt(2.0 / fan_in)               # He, no bias
    return 0.0, math.sqrt(2.0 / (fan_in + fan_out))       # Xavier


def draw(state_shapes, seed: int, model_cfg, device, ref, levels):
    """{name: f32 tensor on ``device``} for ``state_shapes`` ({name:
    shape}, the reference's floating state-dict entries), from ``seed``;
    ``ref`` the reference module, ``levels`` as ``offset_levels`` gives
    them (a ring it does not name: one level)."""
    names = sorted(state_shapes)
    sizes = [math.prod(state_shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for name, part in zip(names, z.split(sizes)):
        shape = tuple(state_shapes[name])
        base, scale = _rule(name, shape, model_cfg, ref, levels)
        base = torch.as_tensor(base, dtype=torch.float32).to(device)
        t = (base + scale * part.view(shape)).view(shape)
        if name.endswith("running_var"):
            t = torch.exp(t) if frozen_bn(name) else t.clamp(min=0.5)
        elif norm_scale(name, shape):
            t = torch.exp(t)
        out[name] = t
    return out


def offset_levels(model):
    """{state-dict name of a sampling offsets' bias: the level count of
    its deformable attention} over ``model``'s modules."""
    return {f"{name}.sampling_offsets.bias": int(m.n_levels)
            for name, m in model.named_modules()
            if hasattr(m, "sampling_offsets") and hasattr(m, "n_levels")}


def floating_shapes(model):
    """{name: shape} of the floating entries of ``model``'s state dict."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if v.is_floating_point()}


@torch.no_grad()
def load(model, weights, strict_names=True):
    """Copy ``weights`` into ``model``'s parameters and buffers in place,
    cast to each tensor's dtype. With ``strict_names`` the floating
    entries of the model's state dict must be exactly ``weights``'s."""
    state = model.state_dict()
    floating = {k for k, v in state.items() if v.is_floating_point()}
    if strict_names and floating != set(weights):
        missing = sorted(floating - set(weights))[:5]
        extra = sorted(set(weights) - floating)[:5]
        raise KeyError(f"state dict names differ: the model lacks {extra}, "
                       f"the weights lack {missing}")
    for k, v in weights.items():
        state[k].copy_(v)
