"""The reference-checkpoint converter (``dfvod_tpu_torch/utils/
convert_reference.py``) and the ResNet-50 / DFormer converters
(``utils/checkpoint.py``), on state dicts of ``tests/torch_ref.py``: the
hand-typed PyTorch replicas of the reference's models, which carry the
reference's key names. No weight file is read.

(a) The port's converter gives, key for key and bitwise, the state dict
that the JAX package's ``convert_reference_state_dict`` followed by
``load_jax_variables`` gives, and both cover fully: no unmapped reference
key and no unfilled port key.

(b) The port, loaded through its converter, reproduces the replica's
``pred_logits``, ``pred_boxes`` and every ``aux_outputs`` on padded frames
in f32: atol 1e-4 / rtol 1e-3 (2e-4 for TransVOD++), the tolerances of
``tests/test_full_model_parity.py``. This holds the port against the
reference's own composition (the replica's MSDA is the reference's
``F.grid_sample`` oracle), not only against the JAX package.

Sizes are ``test_full_model_parity.py``'s ``DIMS`` (hidden 64, 4 heads,
2+2 layers, 12 queries, 96x128 frames with a 60x84 block on image 1).
"""
import functools
import re

import numpy as np
import pytest
import torch

from dfvod_tpu.utils.checkpoint import (
    convert_dformer_downsample_path as j_convert_dformer,
)
from dfvod_tpu.utils.checkpoint import (
    convert_torchvision_resnet50 as j_convert_resnet,
)
from dfvod_tpu.utils.convert_reference import (
    convert_reference_state_dict as j_convert,
)
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models.backbone_dformer import DFormerDownsamplePath
from dfvod_tpu_torch.models.backbone_resnet import ResNet50
from dfvod_tpu_torch.utils import convert_reference
from dfvod_tpu_torch.utils.checkpoint import (
    convert_dformer_downsample_path,
    convert_torchvision_resnet50,
    merge_matching,
)
from dfvod_tpu_torch.utils.config import Config, ModelConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables, port_key
import test_convert_reference
from test_full_model_parity import DEPTH_TYPE, DIMS, make_inputs
from torch_port_helpers import flat_params
from torch_ref import TorchDeformableDETR, TorchTransVODPP

N_REF = 2                      # TransVOD++ reference frames
# name: (fusion type, box refinement, temporal)
MODELS = {
    "Baseline": ("Baseline", True, False),
    "LateFusion": ("LateFusion", True, False),
    "Encoder_CrossFusion": ("Encoder_CrossFusion", True, False),
    "Backbone_CrossFusion": ("Backbone_CrossFusion", True, False),
    "no_box_refine": ("LateFusion", False, False),
    "transvod_pp": ("Baseline", True, True),
    "LateFusion_4_levels": ("LateFusion", True, False),
}
# feature levels where not 1: layer2-4 and one 3x3 stride-2 level
LEVELS = {"LateFusion_4_levels": 4}


@functools.lru_cache(maxsize=None)
def replica(name):
    """The replica of ``name`` in eval mode with random weights (its
    ``randomize`` gives the zero-initialized projections values), and its
    state dict as the reference would save it."""
    fusion, refine, video = MODELS[name]
    torch.manual_seed(3 if video else 0)
    kw = dict(with_box_refine=refine, two_stage=False, dilation=True,
              depth_type=DEPTH_TYPE[fusion], **DIMS)
    tm = (TorchTransVODPP(num_ref_frames=N_REF, **kw) if video
          else TorchDeformableDETR(num_feature_levels=LEVELS.get(name, 1),
                                   **kw)).eval()
    tm.randomize()
    return tm, {k: v.detach().clone() for k, v in tm.state_dict().items()}


def port_cfg(name):
    fusion, refine, video = MODELS[name]
    kw = dict(temporal_mode="transvod_pp", num_ref_frames=N_REF) if video \
        else {}
    return Config(model=ModelConfig(
        num_classes=3, num_queries=12, hidden_dim=64, nheads=4, enc_layers=2,
        dec_layers=2, dim_feedforward=128, dropout=0.0,
        num_feature_levels=LEVELS.get(name, 1), fusion_type=fusion,
        with_box_refine=refine, dilation=True, **kw))


def port_model(name):
    return build_model(port_cfg(name), device="cpu", seed=1)[0]


def unused_stage(key):
    """Reference modules that the forward never runs and that the port,
    like the JAX package, does not build, so their converted keys fill
    nothing: the fourth stage of the DFormer path
    (``dformer_backbone.py:74-160``), Backbone_CrossFusion's depth output
    projections (read only by the bidirectional backbone, which no config
    field reaches) and, at these 2 encoder layers, Encoder_CrossFusion's
    fusion layers 2 and 3 (it builds 4 and runs one after each of the
    first ``min(4, enc_layers)`` encoder layers)."""
    m = re.search(r"\.fusion_layers_(\d+)\.", key)
    return (".stage3_" in key or ".output_d_proj" in key
            or bool(m and int(m.group(1)) >= DIMS["enc_layers"]))


def load_converted(model, state):
    """``state`` into ``model``: every port key filled, nothing else left
    over but the unused stage."""
    merged, report = merge_matching(model.state_dict(), state, verbose=False)
    assert report["missing"] == [] and report["shape_mismatch"] == []
    assert all(unused_stage(k) for k in report["unexpected"])
    model.load_state_dict(merged)
    return report


@pytest.mark.parametrize("name", list(MODELS))
def test_converter_equals_jax_converter_then_load_jax_variables(name):
    """Check (a), with full coverage both ways."""
    _, sd = replica(name)
    video = MODELS[name][2]
    refine = MODELS[name][1]
    state, unmapped = convert_reference.convert_reference_state_dict(
        sd, with_box_refine=refine, verbose=False, video=video)
    assert unmapped == []
    params, model_state, j_unmapped = j_convert(
        {k: v.numpy() for k, v in sd.items()}, with_box_refine=refine,
        verbose=False, video=video)
    assert j_unmapped == []
    # load_jax_variables raises on a leaf that fills no port key or a port
    # key that no leaf fills
    variables = drop_unused_stage({"params": params, **model_state})
    want = load_jax_variables(port_model(name), variables).state_dict()
    assert sorted(k for k in state if not unused_stage(k)) == sorted(want)
    for k, v in want.items():
        assert state[k].dtype == v.dtype and torch.equal(state[k], v), k


def drop_unused_stage(variables):
    """Flax variables without the unused stage's leaves."""
    def walk(tree, path):
        return {k: walk(v, f"{path}.{k}") if isinstance(v, dict) else v
                for k, v in tree.items()
                if not unused_stage(f"{path}.{k}.")}
    return walk(variables, "")


def outputs_close(got, ref, atol, rtol):
    keys = ("pred_logits", "pred_boxes")
    assert len(got["aux_outputs"]) == len(ref["aux_outputs"]) > 0
    for tag, g, r in (("final", got, ref),
                      *((f"aux {i}", g, r) for i, (g, r) in enumerate(
                          zip(got["aux_outputs"], ref["aux_outputs"])))):
        for k in keys:
            np.testing.assert_allclose(g[k].numpy(), r[k].numpy(),
                                       atol=atol, rtol=rtol,
                                       err_msg=f"{tag} {k}")


@pytest.mark.parametrize("name", list(MODELS))
def test_port_through_the_converter_reproduces_the_replica(name):
    """Check (b): the replica's state dict loaded into the port
    (``load_state_dict`` strict: every port key filled), the same padded
    f32 frames through both."""
    tm, sd = replica(name)
    fusion, refine, video = MODELS[name]
    state, _ = convert_reference.convert_reference_state_dict(
        sd, with_box_refine=refine, verbose=False, video=video)
    model = port_model(name)
    load_converted(model, state)
    imgs, mask = make_inputs(B=1 + N_REF if video else 2,
                             channels=3 if fusion == "Baseline" else 4)
    with torch.no_grad():
        ref = tm(torch.from_numpy(imgs.transpose(0, 3, 1, 2)),
                 torch.from_numpy(mask))
        got = model(torch.from_numpy(imgs), torch.from_numpy(mask))
    outputs_close(got, ref, 2e-4 if video else 1e-4, 1e-3)


def test_load_reference_checkpoint_reads_a_reference_pth(tmp_path):
    """A ``.pth`` as the reference writes it, ``{'model', 'args'}`` with an
    argparse ``Namespace``, into a LateFusion model: every key filled."""
    import argparse
    tm, sd = replica("LateFusion")
    path = tmp_path / "checkpoint.pth"
    torch.save({"model": sd, "args": argparse.Namespace(lr=2e-4),
                "epoch": 3}, path)
    loaded = convert_reference.load_torch_state_dict(str(path))
    assert sorted(loaded) == sorted(sd)
    model, report = convert_reference.load_reference_checkpoint(
        str(path), port_model("LateFusion"), verbose=False)
    state, _ = convert_reference.convert_reference_state_dict(sd,
                                                              verbose=False)
    assert report == {"missing": [], "shape_mismatch": [], "unexpected": [
        k for k in state if unused_stage(k)]}
    assert report["unexpected"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_unknown_reference_keys_are_reported():
    sd = {"transformer.encoder.layers.0.norm1.weight": torch.ones(4),
          "something_new.weight": torch.ones(2),
          "transformer.decoder.layers.0.self_attn.bogus": torch.ones(2)}
    state, unmapped = convert_reference.convert_reference_state_dict(
        sd, verbose=False)
    assert list(state) == ["transformer.encoder_layers_0.norm1.weight"]
    assert unmapped == ["something_new.weight",
                        "transformer.decoder.layers.0.self_attn.bogus"]


# ------------------------------------------------ ResNet-50 and DFormer
@pytest.mark.parametrize("prefix", ["", "backbone.0.body."],
                         ids=["torchvision", "reference"])
def test_resnet50_converter_equals_jax(prefix):
    """torchvision names (or the reference's prefixed ones, with the keys
    of other modules beside them) into the port ``ResNet50``: the same
    state dict as JAX's converter followed by ``load_jax_variables``."""
    rng = np.random.default_rng(0)
    sd = {f"{prefix}{n}": rng.standard_normal(s).astype(np.float32)
          for n, s in test_convert_reference._resnet_names()}
    sd[f"{prefix}bn1.num_batches_tracked"] = np.array(5)
    sd[f"{prefix}fc.weight"] = np.ones((10, 2048), np.float32)
    if prefix:
        sd["transformer.level_embed"] = np.ones((1, 8), np.float32)
    got = convert_torchvision_resnet50(
        {k: torch.from_numpy(v) for k, v in sd.items()}, prefix=prefix)
    params, consts = j_convert_resnet(sd, prefix=prefix)
    want = load_jax_variables(ResNet50(dilation=True),
                              {"params": params, "constants": consts})
    want = want.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("flat", [False, True],
                         ids=["pretrain_names", "flat_names"])
def test_dformer_converter_equals_jax(flat):
    """A DFormer pretrain's ``downsample_layers_e`` keys (running
    statistics skipped, as the reference skips them; foreign keys
    ignored), or flat names with a BN ``scale`` and running statistics:
    the same port keys and values as JAX's converter through
    ``port_key``, and they fill the port ``DFormerDownsamplePath``."""
    rng = np.random.default_rng(2)
    sd = test_convert_reference.TestDFormerPretrainLoading()._pretrain_sd(rng)
    if flat:
        sd = {"stem_conv1.weight": sd["downsample_layers_e.0.0.weight"],
              "stem_bn1.scale": sd["downsample_layers_e.0.1.weight"],
              "stem_bn1.running_mean":
                  sd["downsample_layers_e.0.1.running_mean"],
              "stem_bn1.running_var":
                  np.abs(sd["downsample_layers_e.0.1.running_var"]),
              "stage2_conv.bias": sd["downsample_layers_e.2.1.bias"]}
    got = convert_dformer_downsample_path(
        {k: torch.from_numpy(v) for k, v in sd.items()})
    params, stats = j_convert_dformer(sd)
    want = flat_params(params)
    for mod, leaves in stats.items():
        for leaf, v in leaves.items():
            k, v = port_key("batch_stats", (mod, leaf), np.asarray(v))
            want[k] = v
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(np.asarray(v))), k
    _, report = merge_matching(DFormerDownsamplePath().state_dict(), got,
                               verbose=False)
    assert report["unexpected"] == [] and report["shape_mismatch"] == []
    if not flat:
        assert all(k.endswith(("running_mean", "running_var"))
                   for k in report["missing"]) and report["missing"]
