"""Reference (PyTorch) checkpoint -> port state dict (counterpart of
``dfvod_tpu/utils/convert_reference.py``).

Lets a user of the reference repository load a trained ``checkpoint.pth``
into the port: Baseline, LateFusion, Encoder_CrossFusion,
Backbone_CrossFusion and the TransVOD / TransVOD++ temporal heads. Both
sides are PyTorch, so the conversion renames keys and keeps every layout;
the one split is ``nn.MultiheadAttention``'s packed ``in_proj_weight`` /
``in_proj_bias``, which become the port's ``q_proj`` / ``k_proj`` /
``v_proj``. Each rule cites the reference module it mirrors.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

from dfvod_tpu_torch.utils.checkpoint import (
    convert_torchvision_resnet50,
    dformer_module,
    merge_matching,
)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference checkpoint on the CPU as {name: tensor}: a raw
    state dict, the reference's ``{'model': ...}`` (``main.py:499``) or a
    DFormer pretrain's ``{'state_dict': ...}`` (``dformer_backbone.py:174``).

    A reference ``.pth`` holds an argparse ``Namespace`` under ``args``,
    which ``torch.load(weights_only=True)`` refuses, so this unpickles with
    ``weights_only=False``: load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        obj = obj.get("model", obj.get("state_dict", obj))
    return {k: v for k, v in obj.items() if torch.is_tensor(v)}


def _emit_mha(out, base, rest, w):
    """torch MultiheadAttention -> q/k/v/out_proj."""
    if rest in ("in_proj_weight", "in_proj_bias"):
        leaf = rest.split("_")[-1]
        for name, chunk in zip(("q_proj", "k_proj", "v_proj"),
                               torch.chunk(w, 3, dim=0)):
            out[f"{base}.{name}.{leaf}"] = chunk.clone()
    elif rest.startswith("out_proj."):
        out[f"{base}.{rest}"] = w
    else:
        return False
    return True


_MSDA_LEAVES = ("sampling_offsets", "attention_weights", "value_proj",
                "output_proj")
_SAME_NAME = ("depth_scale_adapt", "cross_scale_adapt", "dynamic_layer",
              "out_layer", "norm_depth_scale")


def _emit_generic(out, base, rest, w) -> bool:
    """Attention, linear and norm leaves under ``base``: deformable
    attention, linears and norms keep their names, a vanilla MHA splits."""
    parts = rest.split(".")
    if parts[0] in ("self_attn", "cross_attn") and len(parts) >= 2:
        if parts[1] in _MSDA_LEAVES:
            out[f"{base}.{rest}"] = w
            return True
        return _emit_mha(out, f"{base}.{parts[0]}", ".".join(parts[1:]), w)
    if parts[0].startswith(("norm", "linear")) or parts[0] in _SAME_NAME:
        out[f"{base}.{rest}"] = w
        return True
    return False


def _convert_block(out, base, rest, w, ffn_norm: str) -> bool:
    """An attention block's leaves; linear1/linear2/<ffn_norm> fold into
    its ``ffn`` submodule (``models/layers.py::FFN``)."""
    parts = rest.split(".")
    if parts[0] in ("linear1", "linear2"):
        out[f"{base}.ffn.{rest}"] = w
        return True
    if parts[0] == ffn_norm:
        out[f"{base}.ffn.norm.{parts[1]}"] = w
        return True
    return _emit_generic(out, base, rest, w)


# top-level module names of the temporal (video) model; everything else
# nests under its ``detr`` module (``models/temporal.py``)
_TEMPORAL_TOP = ("temporal_query_layer", "temporal_decoder",
                 "temporal_encoder_layer", "temp_head", "qrf_dynamic_layer")


def convert_reference_state_dict(sd: Mapping[str, torch.Tensor],
                                 with_box_refine: bool = True,
                                 verbose: bool = True, video: bool = False):
    """A reference state dict -> (port state dict, unmapped reference
    keys). ``video=True`` targets ``TemporalDeformableDETR``, whose spatial
    modules nest under ``detr.``. Without box refinement the reference's
    per-layer heads are copies of one, read from index 0."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    # --- ResNet RGB backbone (``backbone_scratch.py``)
    out = {f"backbone.{k}": v for k, v in convert_torchvision_resnet50(
        sd, prefix="backbone.0.body.").items()}
    unmapped = []
    for name, w in sd.items():
        if name.startswith("backbone.0.body.") or \
                "num_batches_tracked" in name:
            continue
        if not _convert_one(name, w, out, with_box_refine):
            unmapped.append(name)
    if verbose and unmapped:
        print(f"[convert] {len(unmapped)} unmapped reference keys "
              f"(first: {unmapped[:5]})")
    if video:
        out = {k if k.startswith(_TEMPORAL_TOP) else f"detr.{k}": v
               for k, v in out.items()}
    return out, unmapped


def _convert_one(name: str, w, out, with_box_refine: bool) -> bool:
    # --- DFormer depth backbone (``dformer_backbone.py:18-72``), and
    # Backbone Cross-Fusion's depth path, flat in the fused backbone
    # (``dformer_crossfusion_backbone.py``)
    m = re.match(r"(depth_backbone\.0\.depth_backbone|backbone\.0\.d_body)"
                 r"\.downsample_layers_e\.(\d+)\.(\d+)\.(.+)", name)
    if m:
        base = ("depth_backbone.downsample_path"
                if m.group(1).startswith("depth") else "backbone")
        mod = dformer_module(int(m.group(2)), int(m.group(3)))
        out[f"{base}.{mod}.{m.group(4)}"] = w
        return True
    m = re.match(r"backbone\.0\.((?:input|output)_(?:rgb|d)_proj\d)\."
                 r"([01])\.(.+)", name)
    if m:
        sub = "conv" if m.group(2) == "0" else "gn"
        out[f"backbone.{m.group(1)}.{sub}.{m.group(3)}"] = w
        return True
    m = re.match(r"backbone\.0\.((?:d2r|r2d)_fusion\d)\.(.+)", name)
    if m:
        return _convert_block(out, f"backbone.{m.group(1)}", m.group(2), w,
                              ffn_norm="norm3")

    # --- input projections (``deformable_detr_single.py:101-150``)
    m = re.match(r"(input_proj|input_proj_depth)\.(\d+)\.([01])\.(.+)", name)
    if m:
        sub = "conv" if m.group(3) == "0" else "gn"
        out[f"{m.group(1)}_{m.group(2)}.{sub}.{m.group(4)}"] = w
        return True

    # --- detection heads
    m = re.match(r"(?:transformer\.decoder\.)?class_embed\.(\d+)\.(.+)", name)
    if m:
        i = int(m.group(1))
        if not with_box_refine and i > 0:
            return True             # shared heads: the indices repeat one
        head = f"head_{i}" if with_box_refine else "head_shared"
        out[f"transformer.{head}.class_embed.{m.group(2)}"] = w
        return True
    m = re.match(r"(?:transformer\.decoder\.)?bbox_embed\.(\d+)\."
                 r"layers\.(\d+)\.(.+)", name)
    if m:
        i = int(m.group(1))
        if not with_box_refine and i > 0:
            return True
        head = f"head_{i}" if with_box_refine else "head_shared"
        out[f"transformer.{head}.bbox_layers_{m.group(2)}.{m.group(3)}"] = w
        return True

    # --- temporal heads (TransVOD / ++)
    m = re.match(r"temp_class_embed(?:_list\.(\d+))?\.(.+)", name)
    if m:
        head = "temp_head" + (f"_{m.group(1)}" if m.group(1) else "")
        out[f"{head}.class_embed.{m.group(2)}"] = w
        return True
    m = re.match(r"temp_bbox_embed(?:_list\.(\d+))?\.layers\.(\d+)\.(.+)",
                 name)
    if m:
        head = "temp_head" + (f"_{m.group(1)}" if m.group(1) else "")
        out[f"{head}.bbox_layers_{m.group(2)}.{m.group(3)}"] = w
        return True

    if name == "query_embed.weight":
        out["transformer.query_embed"] = w
        return True
    if name == "transformer.level_embed":
        out[name] = w
        return True
    # the reference point head and the two-stage proposal path
    # (``deformable_transformer_single.py:85-90``)
    if re.match(r"transformer\.(reference_points|enc_output_norm|"
                r"enc_output|pos_trans_norm|pos_trans)\.(weight|bias)$",
                name):
        out[name] = w
        return True

    # --- encoder / decoder layers
    m = re.match(r"transformer\.encoder\.layers\.(\d+)\.(.+)", name)
    if m:
        return _convert_block(out, f"transformer.encoder_layers_{m.group(1)}",
                              m.group(2), w, ffn_norm="norm2")
    m = re.match(r"transformer\.decoder\.layers\.(\d+)\.(.+)", name)
    if m:
        return _convert_block(out, f"transformer.decoder_layers_{m.group(1)}",
                              m.group(2), w, ffn_norm="norm3")

    # --- fusion layers
    m = re.match(r"transformer\.depth_encoder_layer\.(.+)", name)
    if m:
        return _convert_block(out, "transformer.depth_encoder_layer",
                              m.group(1), w, ffn_norm="norm3")
    m = re.match(r"transformer\.encoder\.fusion_layers\.(\d+)\.(.+)", name)
    if m:
        return _convert_block(out, f"transformer.fusion_layers_{m.group(1)}",
                              m.group(2), w, ffn_norm="norm2")

    # --- temporal modules
    m = re.match(r"transformer\.temporal_query_layer(\d)\.(.+)", name)
    if m:
        return _convert_block(out, f"temporal_query_layer{m.group(1)}",
                              m.group(2), w, ffn_norm="norm3")
    m = re.match(r"transformer\.temporal_decoder(\d?)\.layers\.(\d+)\.(.+)",
                 name)
    if m:
        return _convert_block(
            out, f"temporal_decoder{m.group(1)}.layers_{m.group(2)}",
            m.group(3), w, ffn_norm="norm3")
    m = re.match(r"transformer\.temporal_encoder_layer\.(.+)", name)
    if m:
        return _convert_block(out, "temporal_encoder_layer", m.group(1), w,
                              ffn_norm="norm3")
    m = re.match(r"transformer\.dynamic_layer_for_current_query1\.(.+)", name)
    if m:
        rest, base = m.group(1), "qrf_dynamic_layer1"
        if rest.startswith("inst_interact."):
            return _emit_generic(out, f"{base}.inst_interact",
                                 rest[len("inst_interact."):], w)
        if rest.startswith("self_attn."):
            return _emit_mha(out, f"{base}.self_attn",
                             rest[len("self_attn."):], w)
        return _emit_generic(out, base, rest, w)
    return False


def load_reference_checkpoint(path: str, model, verbose: bool = True):
    """Load a reference ``.pth`` into ``model`` (in place): convert it,
    then overlay it through ``merge_matching``. Box refinement and the
    video layout follow the model's config. Returns (model, report)."""
    video = model.cfg.temporal_mode != "none"
    state, _ = convert_reference_state_dict(
        load_torch_state_dict(path), model.cfg.with_box_refine, verbose,
        video=video)
    merged, report = merge_matching(model.state_dict(), state,
                                    verbose=verbose)
    model.load_state_dict(merged)
    return model, report
