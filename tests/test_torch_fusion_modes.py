"""The paper's other two fusion modes against the flax model: the
``DeformableDETR`` forward of Encoder_CrossFusion and Backbone_CrossFusion,
``Server`` from uint8 frames to detections, the weight bridge, the
``CrossFusionBackbone`` alone (one-way and bidirectional), Encoder
CrossFusion without DC5 (RGB and depth token grids apart: the second branch
of the fusion layers' same-tokens rule), and a TransVOD++ Encoder
CrossFusion forward.

Small dims (hidden 64, 4 heads, 2+2 layers, 12 queries) on 96x128 uint8
frames with real padding, made with numpy from a seed; the flax variables
are random in every leaf (``torch_port_helpers.random_variables``) and
carried into the port by ``utils/convert.py``. Each flax model runs once
per module (module-scoped fixtures). Tolerance: atol 1e-4 / rtol 1e-3 on
logits and boxes of every decoder layer and on the backbone's features,
the JAX package's full-model torch-parity tolerance.

A model with a ``CrossFusionBackbone`` is run by flax without ``jax.jit``.
A padded pixel's sine embedding is the sine of about -3e6, which the
jitted flax program rounds differently from flax run op by op (by more
than 1e-2, ``test_padded_sine_embedding_differs_under_jit``); the
backbone's fusion sites add the padded tokens' outputs into the RGB map
and its next convs carry them into valid pixels, so the jitted model's
features leave the tolerance where flax run op by op and the port agree
within it (the transformer masks padded tokens, so the jitted
Encoder_CrossFusion model is compared as it is).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.models.backbone_crossfusion import (
    CrossFusionBackbone as JCrossFusionBackbone,
)
from dfvod_tpu.models.postprocess import postprocess as j_postprocess
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models import temporal as tm
from dfvod_tpu_torch.models.backbone_crossfusion import CrossFusionBackbone
from dfvod_tpu_torch.serve import Server
from dfvod_tpu_torch.utils.config import Config, ModelConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import assert_close, make_frames, random_variables

KEY = jax.random.PRNGKey(0)
TOL = dict(atol=1e-4, rtol=1e-3)
DIMS = dict(num_classes=3, num_queries=12, hidden_dim=64, nheads=4,
            enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0,
            num_feature_levels=1)
MODES = ("Encoder_CrossFusion", "Backbone_CrossFusion")
# the top-level modules of the Backbone_CrossFusion backbone (bn1, a
# FrozenBatchNorm, holds flax constants only)
CF_NAMES = {"conv1", "bn1", "layer1", "layer2", "layer3", "layer4",
            "stem_conv1", "stem_bn1", "stem_conv2", "stem_bn2", "stage1_bn",
            "stage1_conv", "stage2_bn", "stage2_conv",
            *(f"{n}{s}" for s in (2, 3, 4) for n in (
                "input_rgb_proj", "input_d_proj", "d2r_fusion",
                "output_rgb_proj"))}


def flax_forward(kw, imgs, sizes, seed=11):
    """(flax variables, flax outputs) of the JAX model of ``kw`` on uint8
    frames, with random variables drawn from ``seed``; jitted unless the
    model has a ``CrossFusionBackbone`` (module docstring)."""
    model = j_build_model(JConfig(model=JModelConfig(**kw)))[0]
    x, mask = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    variables = random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=seed)

    def apply(v, i, m):
        return model.apply(v, i, m, train=False)
    if kw["fusion_type"] != "Backbone_CrossFusion":
        apply = jax.jit(apply)
    return variables, apply(variables, x, mask)


def port_model(kw, variables):
    model = build_model(Config(model=ModelConfig(**kw)), device="cpu")[0]
    return load_jax_variables(model, variables)


def port_forward(model, imgs, sizes):
    x, mask = device_normalize(torch.from_numpy(imgs),
                               torch.from_numpy(sizes))
    with torch.no_grad():
        return model(x, mask)


def assert_heads_close(out, ref, n_layers, tag):
    """Logits and boxes of every decoder layer."""
    pairs = [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"]))
    assert len(pairs) == n_layers
    for i, (o, r) in enumerate(pairs):
        for k in ("pred_logits", "pred_boxes"):
            assert_close(o[k], r[k], **TOL, err_msg=f"{tag} layer {i} {k}")


@pytest.fixture(scope="module", params=MODES)
def flax_run(request):
    """(mode, model kwargs, frames, sizes, flax variables, flax outputs)."""
    kw = dict(DIMS, fusion_type=request.param)
    imgs, sizes = make_frames(4)
    variables, out = flax_forward(kw, imgs, sizes)
    return request.param, kw, imgs, sizes, variables, out


def test_deformable_detr_matches_flax(flax_run):
    mode, kw, imgs, sizes, variables, ref = flax_run
    out = port_forward(port_model(kw, variables), imgs, sizes)
    assert out["pred_logits"].shape == (2, 12, 3)
    assert_heads_close(out, ref, kw["dec_layers"], mode)
    assert_close(out["_trunk"]["valid_ratios"],
                 ref["_trunk"]["valid_ratios"], atol=1e-7, rtol=0)


def test_weight_bridge_covers_both_ways(flax_run):
    """Every flax leaf fills a port key and every port key is filled (the
    bridge raises otherwise); the modules sit where the JAX model has
    them: the fusion layers in the transformer, or the fusion sites and
    the depth path directly under ``backbone``, with no separate depth
    backbone."""
    mode, kw, _, _, variables, _ = flax_run
    model = port_model(kw, variables)
    n_flax = len(jax.tree_util.tree_leaves(variables))
    assert n_flax == len(model.state_dict())
    params = variables["params"]
    if mode == "Backbone_CrossFusion":
        assert set(params["backbone"]) == CF_NAMES - {"bn1"}
        assert {n for n, _ in model.backbone.named_children()} == CF_NAMES
        assert "depth_backbone" not in params
        assert not hasattr(model, "depth_backbone")
        assert not hasattr(model, "input_proj_depth_0")
        assert not any(n.startswith("fusion_layers")
                       for n in params["transformer"])
    else:
        fusion = {n for n in params["transformer"]
                  if n.startswith("fusion_layers")}
        assert fusion == {"fusion_layers_0", "fusion_layers_1"}
        assert all(hasattr(model.transformer, n) for n in fusion)
        assert "depth_backbone" in params and "input_proj_depth_0" in params
    trimmed = {k: dict(v) for k, v in variables.items()}
    trimmed["params"]["backbone"] = dict(params["backbone"])
    trimmed["params"]["backbone"].pop("layer4")
    with pytest.raises(ValueError, match="unfilled"):
        load_jax_variables(port_model(kw, variables), trimmed)


def test_server_uint8_to_detections(flax_run):
    mode, kw, imgs, sizes, variables, ref = flax_run
    server = Server(Config(model=ModelConfig(**kw)), variables,
                    device="cpu", dtype=torch.float32)
    det = server(imgs, sizes)
    jdet = j_postprocess(ref["pred_logits"], ref["pred_boxes"],
                         jnp.asarray(sizes))
    assert det["scores"].shape == (2, 24) and det["boxes"].shape == (2, 24, 4)
    js = np.asarray(jdet["scores"])
    np.testing.assert_allclose(np.sort(det["scores"].numpy(), 1),
                               np.sort(js, 1), atol=1e-4, rtol=1e-3)
    # boxes and labels where the score has no near-tie
    gap = np.abs(np.diff(js, axis=1))
    clear = np.ones_like(js, bool)
    clear[:, 1:] &= gap > 1e-3
    clear[:, :-1] &= gap > 1e-3
    np.testing.assert_array_equal(det["labels"].numpy()[clear],
                                  np.asarray(jdet["labels"])[clear])
    np.testing.assert_allclose(det["boxes"].numpy()[clear],
                               np.asarray(jdet["boxes"])[clear], atol=1e-2,
                               rtol=1e-3)


@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["one_way", "bidirectional"])
def test_crossfusion_backbone_matches_flax(bidirectional):
    """``CrossFusionBackbone`` alone at d_model 64 on a padded 96x128 input:
    the RGB stage-4 feature, its mask, and the returned depth feature and
    mask. The one-way module leaves the depth stream untouched by the
    fusion; the bidirectional one adds ``r2d_fusion{s}`` and
    ``output_d_proj{s}`` and changes it."""
    rng = np.random.default_rng(5)
    rgb = rng.standard_normal((2, 96, 128, 3)).astype(np.float32)
    depth = rng.standard_normal((2, 96, 128, 1)).astype(np.float32)
    mask = np.zeros((2, 96, 128), bool)
    mask[1, 60:] = True
    mask[1, :, 84:] = True
    jmod = JCrossFusionBackbone(d_model=64, n_heads=4, dropout=0.0,
                                bidirectional=bidirectional)
    jin = [jnp.asarray(a) for a in (rgb, depth, mask)]
    variables = random_variables(lambda: jmod.init(KEY, *jin), seed=13)
    jfeats, jmasks, jdfeat, jdmask = jmod.apply(variables, *jin)
    model = CrossFusionBackbone(d_model=64, n_heads=4, dropout=0.0,
                                bidirectional=bidirectional)
    load_jax_variables(model, variables).eval()
    names = set(variables["params"]) | set(variables["constants"])
    assert {"r2d_fusion2", "output_d_proj4"} <= names if bidirectional \
        else names == CF_NAMES
    assert len(jax.tree_util.tree_leaves(variables)) == len(
        model.state_dict())
    with torch.no_grad():
        feats, masks, dfeat, dmask = model(
            *[torch.from_numpy(a) for a in (rgb, depth, mask)])
    assert len(feats) == len(jfeats) == 1
    assert feats[0].shape == (2, 6, 8, 2048) and dfeat.shape == (2, 6, 8,
                                                                  128)
    assert_close(feats[0], jfeats[0], **TOL, err_msg="rgb stage 4")
    assert_close(dfeat, jdfeat, **TOL, err_msg="depth feature")
    np.testing.assert_array_equal(masks[0].numpy(), np.asarray(jmasks[0]))
    np.testing.assert_array_equal(dmask.numpy(), np.asarray(jdmask))
    assert bool(dmask.any()) and not bool(dmask.all())


def test_encoder_crossfusion_without_dc5_matches_flax():
    """``dilation=False``: the RGB tokens are at stride 32 (3x4) and the
    depth tokens at stride 16 (6x8), so every fusion layer reads the depth
    tokens under the depth mask (the rule's second branch)."""
    kw = dict(DIMS, fusion_type="Encoder_CrossFusion", dilation=False)
    imgs, sizes = make_frames(4, seed=3)
    variables, ref = flax_forward(kw, imgs, sizes, seed=17)
    out = port_forward(port_model(kw, variables), imgs, sizes)
    assert out["_trunk"]["spatial_shapes"] == ((3, 4),)
    assert_heads_close(out, ref, kw["dec_layers"], "dilation=False")


def test_transvod_pp_encoder_crossfusion_matches_flax():
    """A small TransVOD++ Encoder_CrossFusion model (2 clips of 3 frames,
    one reference frame of each clip padded): the key frames' final and
    per-round outputs and the single-frame outputs."""
    kw = dict(DIMS, fusion_type="Encoder_CrossFusion", hidden_dim=32,
              enc_layers=1, dim_feedforward=64, num_queries=100,
              temporal_mode="transvod_pp", num_ref_frames=2)
    rng = np.random.default_rng(7)
    F, B, H, W = 3, 2, 64, 96
    imgs = rng.integers(0, 256, (B * F, H, W, 4), dtype=np.uint8)
    sizes = np.array([[H, W]] * (B * F))
    sizes[1::F] = [40, 70]
    for i, (h, w) in enumerate(sizes):
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    variables, ref = flax_forward(kw, imgs, sizes, seed=21)
    model = port_model(kw, variables)
    assert isinstance(model, tm.TemporalDeformableDETR)
    assert hasattr(model.detr.transformer, "fusion_layers_0")
    out = port_forward(model, imgs, sizes)
    assert out["pred_logits"].shape == (B, 100, 3)
    pairs = [("final", out, ref),
             ("single_frame", out["_single_frame"], ref["_single_frame"])]
    pairs += [(f"aux {i}", o, r) for i, (o, r) in
              enumerate(zip(out["aux_outputs"], ref["aux_outputs"]))]
    assert len(pairs) == 4
    for tag, o, r in pairs:
        for k in ("pred_logits", "pred_boxes"):
            assert_close(o[k], r[k], **TOL, err_msg=f"{tag} {k}")


def test_padded_sine_embedding_differs_under_jit():
    """Why the models with a ``CrossFusionBackbone`` are compared with
    flax run op by op: on padded pixels the jitted JAX embedding differs
    from the same function run op by op by more than 1e-2, on valid pixels
    not at all; the port's equals the op-by-op one to 1e-6 everywhere."""
    from dfvod_tpu.models.position_encoding import (
        sine_position_embedding_rect as j_sine,
    )
    from dfvod_tpu_torch.models.position_encoding import (
        sine_position_embedding_rect as sine,
    )
    mask = np.zeros((2, 12, 16), bool)
    mask[1, 8:] = True
    mask[1, :, 11:] = True
    eager = np.asarray(j_sine(jnp.asarray(~mask), 32))
    jitted = np.asarray(jax.jit(lambda m: j_sine(m, 32))(jnp.asarray(~mask)))
    diff = np.abs(eager - jitted)
    assert diff[~mask].max() == 0 and diff[mask].max() > 1e-2
    assert_close(sine(torch.from_numpy(~mask), 32), eager, atol=1e-6,
                 rtol=0)
