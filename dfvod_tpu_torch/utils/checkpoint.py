"""Checkpoints: the reference's key-surgery tools, save and resume, and the
ResNet-50 / DFormer weight converters (counterpart of
``dfvod_tpu/utils/checkpoint.py``).

Everything here works on port state dicts: flat ``{dotted key: tensor}``
as ``nn.Module.state_dict()`` gives them.

Reference semantics (SURVEY.md §5):
- ``torch.save({model, optimizer, lr_scheduler, epoch, args})`` every
  epoch (``main.py:574-585``) -> ``save_checkpoint``, one
  ``checkpoint{epoch:04}.pth`` per epoch, old ones pruned as the JAX
  package's orbax manager prunes them;
- resume loads the model weights only, ``strict=False``, reporting
  missing and unexpected keys (``main.py:499-512``) -> ``merge_matching``;
- ``--del_class_weights`` drops ``class_embed.*`` (``main.py:470-478``) ->
  ``drop_keys(state, "class_embed")``;
- ``--transvod_temporal_weights`` / ``--spatial_weights``
  (``main_multi.py:342-364``) -> ``merge_temporal_weights``.

A pattern selects a key when it is a substring of ``"/" +
key.replace(".", "/")``: the JAX package matches the ``/``-joined flax
path with a leading ``/``, so one pattern selects the same weights in
both packages.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import torch

from dfvod_tpu_torch import parallel

# the JAX package's patterns, which carry the reference's head names
# (``temp_class_embed`` / ``temp_bbox_embed``), and ``temp_head``, the name
# both packages give those heads (``temp_head``, ``temp_head_{i}``): without
# it a TransVOD checkpoint's temporal heads would keep the base weights
TEMPORAL_KEY_PATTERNS = ("temporal_query", "temporal_decoder",
                         "temp_bbox_embed", "temp_class_embed",
                         "dynamic_layer", "temporal", "qrf", "temp_head")


# ---------------------------------------------------------------------------
# state-dict key surgery
# ---------------------------------------------------------------------------

def _matches(key: str, patterns) -> bool:
    path = "/" + key.replace(".", "/")
    return any(p in path for p in patterns)


def drop_keys(state: Mapping[str, torch.Tensor], *patterns: str) -> dict:
    """``state`` without the keys that match any pattern."""
    return {k: v for k, v in state.items() if not _matches(k, patterns)}


def select_keys(state: Mapping[str, torch.Tensor], *patterns: str) -> dict:
    """Only the keys of ``state`` that match one of the patterns."""
    return {k: v for k, v in state.items() if _matches(k, patterns)}


def merge_matching(base: Mapping[str, torch.Tensor],
                   overlay: Mapping[str, torch.Tensor],
                   verbose: bool = True) -> Tuple[dict, Dict[str, list]]:
    """Overlay ``overlay`` onto ``base`` where keys and shapes match, each
    value cast to the base tensor's dtype and device
    (``load_state_dict(strict=False)`` semantics). Returns (merged, report)
    with report['missing'|'unexpected'|'shape_mismatch']: base keys that
    ``overlay`` lacks, overlay keys that ``base`` lacks, and keys whose
    shapes differ (those keep the base value)."""
    report = {"missing": [], "unexpected": [], "shape_mismatch": []}
    merged = {}
    for k, b in base.items():
        if k not in overlay:
            report["missing"].append(k)
            merged[k] = b
            continue
        o = torch.as_tensor(overlay[k])
        if tuple(o.shape) != tuple(b.shape):
            report["shape_mismatch"].append(k)
            merged[k] = b
        else:
            merged[k] = o.to(dtype=b.dtype, device=b.device)
    report["unexpected"] = [k for k in overlay if k not in base]
    if verbose:
        for k in ("missing", "unexpected", "shape_mismatch"):
            if report[k]:
                print(f"[checkpoint] {k} keys: {len(report[k])} "
                      f"(first: {report[k][:3]})")
    return merged, report


def merge_temporal_weights(state: Mapping[str, torch.Tensor],
                           temporal_state=None, spatial_state=None) -> dict:
    """The TransVOD fine-tune surgery (``main_multi.py:342-364``): every
    key of a spatial (fusion) checkpoint, then the temporal-head keys of a
    TransVOD checkpoint, overlaid onto ``state``. A single-frame
    checkpoint's keys nest under ``detr.`` when ``state`` is a temporal
    model's (``models/temporal.py``)."""
    merged = dict(state)
    if spatial_state is not None:
        if any(k.startswith("detr.") for k in state) and \
                not any(k.startswith("detr.") for k in spatial_state):
            spatial_state = {f"detr.{k}": v for k, v in spatial_state.items()}
        merged, _ = merge_matching(merged, spatial_state)
    if temporal_state is not None:
        merged, _ = merge_matching(
            merged, select_keys(temporal_state, *TEMPORAL_KEY_PATTERNS))
    return merged


# ---------------------------------------------------------------------------
# save and resume
# ---------------------------------------------------------------------------

MAX_TO_KEEP = 3


def _checkpoint_path(output_dir: str, epoch: int) -> str:
    return os.path.join(output_dir, f"checkpoint{epoch:04}.pth")


def saved_epochs(output_dir: str):
    """The epochs with a checkpoint under ``output_dir``, ascending."""
    found = (re.fullmatch(r"checkpoint(\d+)\.pth", os.path.basename(p))
             for p in glob.glob(os.path.join(output_dir, "checkpoint*.pth")))
    return sorted(int(m.group(1)) for m in found if m)


def save_checkpoint(output_dir: str, state, epoch: int, cfg=None,
                    keep_every: int = 5) -> str:
    """Write ``checkpoint{epoch:04}.pth`` under ``output_dir``: {model,
    optimizer, step, epoch, generator (the dropout generator's state),
    args (``cfg``, default ``state.cfg``, as a plain dict)}. Returns its
    path.

    Retention is the JAX package's orbax policy (``max_to_keep=3,
    keep_period=keep_every``): the newest three epochs are kept, and every
    epoch divisible by ``keep_every``; the rest are deleted. Saving epochs
    0-11 leaves {0, 5, 9, 10, 11}.

    Under data parallelism every process calls it: every rank's dropout
    state is gathered (``generators``, and ``head_generators`` under
    clip-parallel training, one entry per rank), the main process writes
    (the unwrapped model's keys, no ``module.`` prefix), and every process
    waits at a barrier until the file is in place."""
    path = _checkpoint_path(output_dir, epoch)
    gens = _gather_generator_states(state)
    if parallel.is_main_process():
        _write_checkpoint(output_dir, state, epoch, cfg, keep_every, gens)
    parallel.barrier()
    return path


def _gather_generator_states(state) -> dict:
    """Every rank's dropout generator states, in rank order; nothing in
    one process, whose ``generator`` entry is its own."""
    if parallel.world() == 1:
        return {}

    def gather(gen):
        # a generator's state is a byte tensor of one length per device
        # type, so the ranks' states stack as rows
        mine = gen.get_state()[None].to(parallel.collective_device())
        return [g.clone() for g in parallel.all_gather_rows(mine).cpu()]

    out = {"generators": gather(state.generator)}
    if state.head_generator is not None:
        out["head_generators"] = gather(state.head_generator)
    return out


def _write_checkpoint(output_dir, state, epoch, cfg, keep_every, gens):
    os.makedirs(output_dir, exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "epoch": int(epoch),
        "generator": state.generator.get_state(),
        **gens,
        # a plain dict, so that torch.load(weights_only=True) reads it
        "args": dataclasses.asdict(cfg if cfg is not None else state.cfg),
    }
    path = _checkpoint_path(output_dir, epoch)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    epochs = saved_epochs(output_dir)
    keep = set(epochs[-MAX_TO_KEEP:]) | {e for e in epochs
                                         if e % keep_every == 0}
    for e in epochs:
        if e not in keep:
            os.remove(_checkpoint_path(output_dir, e))


def load_checkpoint(output_dir: str, state=None, epoch: Optional[int] = None,
                    weights_only: bool = True):
    """Restore epoch ``epoch`` (default: the newest) from ``output_dir``.
    Returns (state, epoch); with ``state=None``, (the checkpoint dict,
    epoch).

    ``weights_only=True`` is the reference resume (``main.py:522-540``):
    the model's weights are overlaid through ``merge_matching``, and the
    optimizer, step and generator stay fresh. ``weights_only=False`` is
    auto-resume: the model, the optimizer state, ``state.step`` and the
    dropout generator's state, so that the next step draws the masks an
    unbroken run would: rank r takes rank r's saved state. A checkpoint
    saved by another number of processes (one written before the states
    were gathered counts as one) re-seeds every rank's dropout from
    ``seed + rank``, the rule at the start of a run, and the main process
    says so. Tensors load onto the model's device."""
    epochs = saved_epochs(output_dir)
    if epoch is None:
        if not epochs:
            raise FileNotFoundError(f"no checkpoint under {output_dir}")
        epoch = epochs[-1]
    device = (next(state.model.parameters()).device if state is not None
              else torch.device("cpu"))
    ckpt = torch.load(_checkpoint_path(output_dir, epoch),
                      map_location=device, weights_only=True)
    if state is None:
        return ckpt, epoch
    if weights_only:
        merged, _ = merge_matching(state.model.state_dict(), ckpt["model"])
        state.model.load_state_dict(merged)
        return state, epoch
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    _restore_generators(state, ckpt)
    return state, epoch


def _restore_generators(state, ckpt):
    """This rank's saved dropout states, or the start's seeds when the
    checkpoint's world differs (the heads' too when it holds none of
    theirs)."""
    saved = ckpt.get("generators", [ckpt["generator"]])
    r, n = parallel.rank(), parallel.world()
    heads = ckpt.get("head_generators")
    if len(saved) != n:
        if parallel.is_main_process():
            print(f"[checkpoint] dropout states of {len(saved)} processes, "
                  f"this run has {n}: re-seeding dropout from seed + rank")
        state.generator.manual_seed(state.cfg.train.seed + r)
        heads = None
    else:
        # a generator's state is a CPU byte tensor, whatever map_location
        # did
        state.generator.set_state(saved[r].cpu().contiguous())
    if state.head_generator is not None:
        if heads is None:
            state.head_generator.manual_seed(state.head_seed)
        else:
            state.head_generator.set_state(heads[r].cpu().contiguous())


# ---------------------------------------------------------------------------
# ResNet-50 / DFormer converters (torch names -> port keys)
# ---------------------------------------------------------------------------

def convert_torchvision_resnet50(sd: Mapping[str, torch.Tensor],
                                 prefix: str = "") -> dict:
    """A torchvision or reference ResNet-50 state dict -> the port
    ``ResNet50``'s state-dict keys (``layer1.0.conv1.weight`` ->
    ``layer1.block_0.conv1.weight``, ``downsample.0`` / ``.1`` ->
    ``downsample_conv`` / ``downsample_bn``; the FrozenBN buffers keep
    their names). With ``prefix`` (e.g. the reference's
    ``backbone.0.body.``) only keys under it are read. Layouts are kept:
    both sides are PyTorch."""
    out = {}
    for name, w in sd.items():
        if prefix:
            if not name.startswith(prefix):
                continue
            name = name[len(prefix):]
        if "num_batches_tracked" in name:
            continue
        parts = name.split(".")
        if parts[0] in ("conv1", "bn1"):
            out[name] = torch.as_tensor(w)
            continue
        if not re.fullmatch(r"layer\d", parts[0]):
            continue
        mod = parts[2]
        if mod == "downsample":
            mod = "downsample_conv" if parts[3] == "0" else "downsample_bn"
            leaf = parts[4:]
        else:
            leaf = parts[3:]
        out[".".join([parts[0], f"block_{parts[1]}", mod, *leaf])] = \
            torch.as_tensor(w)
    return out


def dformer_module(stage: int, j: int) -> str:
    """``downsample_layers_e.{stage}.{j}`` of the reference's DFormer path
    as the port's flat module name (``dformer_backbone.py:34-49``: the stem
    is Sequential(conv, bn, GELU, conv, bn), each stage Sequential(bn,
    conv))."""
    if stage == 0:
        return {0: "stem_conv1", 1: "stem_bn1", 3: "stem_conv2",
                4: "stem_bn2"}[j]
    return f"stage{stage}_bn" if j == 0 else f"stage{stage}_conv"


def _dformer_flat_name(name: str):
    """A DFormer-pretrain key (``downsample_layers_e.i.j.leaf``) as the
    port's flat ``stem_conv1.weight`` scheme; already-flat names pass
    through; None for keys the reference skips (BN running statistics,
    ``dformer_backbone.py:183-189``)."""
    if "downsample_layers_e" not in name:
        return name
    parts = name.split("downsample_layers_e.", 1)[1].split(".")
    if len(parts) < 3:
        return None
    leaf = ".".join(parts[2:])
    if leaf in ("running_mean", "running_var", "num_batches_tracked"):
        return None
    return f"{dformer_module(int(parts[0]), int(parts[1]))}.{leaf}"


def convert_dformer_downsample_path(sd: Mapping[str, torch.Tensor]) -> dict:
    """A DFormer checkpoint's depth ``downsample_path`` -> the port
    ``DFormerDownsamplePath``'s state-dict keys.

    The reference loads the depth stem's convs and BNs from the DFormer
    pretrain (``dformer_backbone.py:161-198``), whose names follow
    ``downsample_layers_e.{i}...``; their running statistics are skipped,
    as the reference skips them. Flat names (``stem_conv1.weight``, a BN's
    ``scale`` for its weight) are taken too; other keys are ignored."""
    out = {}
    for name, w in sd.items():
        flat = _dformer_flat_name(name)
        if flat is None:
            continue
        mod, leaf = flat.split(".")[0], flat.split(".")[-1]
        if "bn" in mod and leaf == "scale":
            leaf = "weight"
        if ("conv" in mod and leaf in ("weight", "bias")) or (
                "bn" in mod and leaf in ("weight", "bias", "running_mean",
                                         "running_var")):
            out[f"{mod}.{leaf}"] = torch.as_tensor(w)
    return out
