"""The ResNet-18 research depth trunk (``models/research.py``,
``depth_backbone_type="resnet18"``) against the JAX package: the trunk
alone against flax ``ResNet18DepthBackbone`` at odd sizes with a padded
mask, LateFusion and Encoder_CrossFusion models built on it with DC5 on
and off (off, the RGB level is 3x4 tokens and the depth level 6x8: the
LateFusion layer's own depth shapes and Encoder_CrossFusion's fusion
layers on the depth tokens under the depth mask), forward and one train
step's loss and gradients, the CLI's default (``--fusion_type LateFusion``
without ``--dformer_backbone`` builds this trunk) and the refusal of
s2d-packed input.

Small dims (hidden 64, 4 heads, 2+2 layers, 12 queries) on 96x128 uint8
frames with real padding, made with numpy from a seed; random flax
variables in every leaf carried into the port by ``utils/convert.py``.
Tolerance atol 1e-4 / rtol 1e-3 (the JAX package's full-model parity
tolerance); gradients as ``tests/test_torch_train.py`` holds them.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.models import criterion as j_criterion
from dfvod_tpu.models.research import (
    ResNet18DepthBackbone as JResNet18DepthBackbone,
)
from dfvod_tpu.train.optim import build_optimizer as j_build_optimizer
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu.utils.config import TrainConfig as JTrainConfig
from dfvod_tpu_torch.cli import flags
from dfvod_tpu_torch.data.device_pipeline import (
    device_normalize,
    normalize_frames,
    pack_s2d,
)
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models.research import ResNet18DepthBackbone
from dfvod_tpu_torch.train.engine import create_train_state, forward, train_step
from dfvod_tpu_torch.utils.config import Config, ModelConfig, TrainConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import (
    assert_close,
    flat_params,
    make_frames,
    random_variables,
)

KEY = jax.random.PRNGKey(0)
TOL = dict(atol=1e-4, rtol=1e-3)
DIMS = dict(num_classes=3, num_queries=12, hidden_dim=64, nheads=4,
            enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0,
            num_feature_levels=1, depth_backbone_type="resnet18")
TRAIN = dict(lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1, epochs=3)
CASES = [("LateFusion", True), ("LateFusion", False),
         ("Encoder_CrossFusion", True), ("Encoder_CrossFusion", False)]
IDS = [f"{f}-{'dc5' if d else 'c5'}" for f, d in CASES]


def test_resnet18_trunk_equals_flax():
    """Depth (2, 75, 101, 1) with image 1 padded to 50x66: the stride-16
    feature (5, 7, 256) and its mask equal flax's; the trunk has conv1,
    bn1 and layers 1-3 with a projected shortcut where the stride or width
    changes."""
    rng = np.random.default_rng(0)
    depth = rng.standard_normal((2, 75, 101, 1)).astype(np.float32)
    mask = np.zeros((2, 75, 101), bool)
    mask[1, 50:] = True
    mask[1, :, 66:] = True
    depth[mask] = 0.0
    jmod = JResNet18DepthBackbone()
    jdepth, jmask = jnp.asarray(depth), jnp.asarray(mask)
    variables = random_variables(
        lambda: jmod.init(KEY, jdepth, jmask), seed=3)
    jfeat, jmask = jmod.apply(variables, jdepth, jmask)
    trunk = load_jax_variables(ResNet18DepthBackbone(), variables)
    with torch.no_grad():
        feat, m = trunk(torch.from_numpy(depth), torch.from_numpy(mask))
    assert tuple(feat.shape) == (2, 5, 7, 256)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jmask))
    assert_close(feat, jfeat, **TOL)
    keys = set(trunk.state_dict())
    assert "layer2.block_0.downsample_conv.weight" in keys
    assert not any(k.startswith("layer1.block_0.downsample") for k in keys)


def model_kw(fusion, dilation):
    return dict(DIMS, fusion_type=fusion, dilation=dilation)


@pytest.mark.parametrize("fusion,dilation", CASES, ids=IDS)
def test_resnet18_model_forward_equals_flax(fusion, dilation):
    kw = model_kw(fusion, dilation)
    model = j_build_model(JConfig(model=JModelConfig(**kw)))[0]
    imgs, sizes = make_frames(4)
    x, mask = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    variables = random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=11)
    ref = jax.jit(lambda v: model.apply(v, x, mask, train=False))(variables)
    port = load_jax_variables(
        build_model(Config(model=ModelConfig(**kw)), device="cpu")[0],
        variables)
    assert port.depth_backbone.layer3.block_0.conv1.in_channels == 128
    assert port.input_proj_depth_0.conv.in_channels == 256
    with torch.no_grad():
        out = port(*device_normalize(torch.from_numpy(imgs),
                                     torch.from_numpy(sizes)))
    assert out["_trunk"]["spatial_shapes"] == (((6, 8),) if dilation
                                               else ((3, 4),))
    for k in ("pred_logits", "pred_boxes"):
        assert_close(out[k], ref[k], **TOL, err_msg=k)
        for g, r in zip(out["aux_outputs"], ref["aux_outputs"]):
            assert_close(g[k], r[k], **TOL, err_msg=f"aux {k}")


def step_batch(seed):
    imgs, sizes = make_frames(4, seed=seed)
    rng = np.random.default_rng(100 + seed)
    T = 8
    return {"images": imgs, "sizes": sizes,
            "labels": rng.integers(0, 2, (2, T)).astype(np.int32),
            "boxes": np.concatenate([rng.uniform(0.2, 0.8, (2, T, 2)),
                                     rng.uniform(0.05, 0.35, (2, T, 2))],
                                    -1).astype(np.float32),
            "valid": np.arange(T)[None] < np.array([[3], [5]])}


@pytest.mark.parametrize("fusion,dilation", CASES[1::2], ids=IDS[1::2])
def test_resnet18_train_step_matches_jax_grad(fusion, dilation):
    """Without DC5 (the grids apart): the loss and every component against
    the JAX criterion on the train-mode forward, every trainable gradient
    against ``jax.grad`` of the loss ``make_train_step`` builds (frozen
    ResNet-50 stopped; atol 1e-5 + 1e-3 of the tensor's largest entry,
    rtol 1e-3), the ResNet-18's convolutions among them; then one
    ``train_step``, whose grad_norm is the global norm of JAX's gradients
    within the tolerance and whose loss is the one above."""
    kw = model_kw(fusion, dilation)
    jcfg = JConfig(model=JModelConfig(**kw), train=JTrainConfig(**TRAIN))
    jmodel = j_build_model(jcfg)[0]
    batch = step_batch(0)
    x, mask = j_normalize(jnp.asarray(batch["images"]),
                          jnp.asarray(batch["sizes"]))
    variables = dict(random_variables(
        lambda: jmodel.init(KEY, x, mask, train=False), seed=11))
    init = copy.deepcopy(variables)
    params = variables.pop("params")
    _, labels = j_build_optimizer(params, jcfg.model, jcfg.train,
                                  steps_per_epoch=1)
    jcrit = j_criterion.SetCriterion(3, jcfg.loss, dec_layers=2)
    targets = {k: jnp.asarray(batch[k]) for k in ("labels", "boxes",
                                                  "valid")}

    def loss_fn(p):
        p = jax.tree_util.tree_map(
            lambda v, lab: jax.lax.stop_gradient(v) if lab == "frozen"
            else v, p, labels)
        out, _ = jmodel.apply({"params": p, **variables}, x, mask,
                              train=True, rngs={"dropout": KEY},
                              mutable=["batch_stats"])
        return jcrit(out, targets)

    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    jflat = flat_params(jgrads)
    jnorm = float(np.sqrt(sum(float(np.square(g).sum())
                              for g in jflat.values())))

    cfg = Config(model=ModelConfig(**kw), train=TrainConfig(**TRAIN))
    model, criterion, _ = build_model(cfg, device="cpu")
    load_jax_variables(model, copy.deepcopy(init))
    gstate = create_train_state(copy.deepcopy(model), cfg, steps_per_epoch=1)
    loss, parts = criterion(*forward(gstate, batch))
    loss.backward()
    assert set(parts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]), **TOL,
                                   err_msg=k)
    r18 = 0
    for k, p in gstate.model.named_parameters():
        if p.grad is None:
            assert k.startswith("backbone.")
            np.testing.assert_array_equal(jflat[k], 0.0)
            continue
        scale = float(np.abs(jflat[k]).max())
        assert_close(p.grad, jflat[k], 1e-5 + 1e-3 * scale, 1e-3, err_msg=k)
        r18 += k.startswith("depth_backbone.")
    assert r18 == 1 + 3 * 2 * 2 + 2     # stem, 12 block convs, 2 shortcuts
    state = create_train_state(model, cfg, steps_per_epoch=1)
    metrics = train_step(state, criterion, batch)
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), **TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]), jnorm, **TOL)


def test_cli_default_late_fusion_builds_resnet18(tmp_path):
    """``--fusion_type LateFusion`` without ``--dformer_backbone`` selects
    the ResNet-18 trunk (the reference's and the JAX CLI's default), which
    builds and serves; ``--dformer_backbone`` selects DFormer."""
    base = ["--fusion_type", "LateFusion", "--hidden_dim", "64",
            "--nheads", "4", "--enc_layers", "1", "--dec_layers", "1",
            "--dim_feedforward", "64", "--num_queries", "12",
            "--num_feature_levels", "1", "--dilation"]
    parser = flags.get_args_parser()
    cfg = flags.config_from_args(parser.parse_args(base))
    assert cfg.model.depth_backbone_type == "resnet18"
    dformer = flags.config_from_args(parser.parse_args(
        [*base, "--dformer_backbone"]))
    assert dformer.model.depth_backbone_type == "dformer"
    model = build_model(cfg, device="cpu")[0]
    assert isinstance(model.depth_backbone, ResNet18DepthBackbone)
    imgs, sizes = make_frames(4)
    with torch.no_grad():
        out = model(*device_normalize(torch.from_numpy(imgs),
                                      torch.from_numpy(sizes)))
    assert out["pred_logits"].shape == (2, 12, 3)
    assert bool(torch.isfinite(out["pred_boxes"]).all())


def test_s2d_input_with_resnet18_is_refused():
    """The ResNet-18 trunk has no s2d stem (the JAX model asserts the
    same): packed frames raise, naming it; the same frames unpacked
    serve."""
    model = build_model(Config(model=ModelConfig(
        **model_kw("LateFusion", True))), device="cpu")[0]
    imgs, sizes = make_frames(4)
    packed, mask = normalize_frames(torch.from_numpy(pack_s2d(imgs)),
                                    torch.from_numpy(sizes))
    with pytest.raises(ValueError, match="ResNet-18"):
        model(packed, mask)
    with torch.no_grad():
        model(*normalize_frames(torch.from_numpy(imgs),
                                torch.from_numpy(sizes)))
