"""Multi-level features (``num_feature_levels`` L > 1) against the flax
model: ResNet stages 2-4 and L - 3 extra 3x3 stride-2 levels
(``input_proj_{3..}``), level embeddings and valid ratios over L levels,
and the depth stream at one level (LateFusion's depth layer and
Encoder_CrossFusion's fusion layers take the first level of the reference
points; with the grids apart the fusion layers read the depth tokens under
the depth mask).

Small dims (hidden 64, 4 heads, 2+2 layers, 12 queries) on 96x128 uint8
frames with real padding, made with numpy from a seed; random flax
variables in every leaf (``torch_port_helpers.random_variables``) carried
into the port by ``utils/convert.py``. Tolerances: the forward's logits and
boxes of every decoder layer atol 1e-4 / rtol 1e-3 (the JAX package's
full-model torch-parity tolerance); the train step as
``tests/test_torch_train.py`` holds it.

L = 2 is refused: stages 2-4 already give 3 levels, and the JAX package's
model (like the reference's) fails at 2
(``test_two_levels_and_multi_level_video_are_refused``).
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
from dfvod_tpu.train.engine import TrainState as JTrainState
from dfvod_tpu.train.engine import make_train_step
from dfvod_tpu.train.optim import build_optimizer as j_build_optimizer
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu.utils.config import TrainConfig as JTrainConfig
from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.train.engine import create_train_state, train_step
from dfvod_tpu_torch.utils.config import (
    Config,
    ModelConfig,
    TrainConfig,
    check_supported,
)
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
            enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0)
TRAIN = dict(lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1, epochs=3)
# (fusion, levels, DC5)
CASES = [("LateFusion", 4, True), ("LateFusion", 4, False),
         ("LateFusion", 3, True), ("LateFusion", 3, False),
         ("Encoder_CrossFusion", 4, True), ("Baseline", 4, False)]


def model_kw(fusion, levels, dilation):
    kw = dict(DIMS, fusion_type=fusion, num_feature_levels=levels,
              dilation=dilation)
    if fusion == "Baseline":
        kw["with_box_refine"] = False
    return kw


def flax_forward(kw, imgs, sizes, seed=11):
    model = j_build_model(JConfig(model=JModelConfig(**kw)))[0]
    x, mask = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    variables = random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=seed)
    out = jax.jit(lambda v, i, m: model.apply(v, i, m, train=False))(
        variables, x, mask)
    return variables, out


def assert_outputs_close(got, ref):
    assert_close(got["pred_logits"], ref["pred_logits"], **TOL)
    assert_close(got["pred_boxes"], ref["pred_boxes"], **TOL)
    assert len(got["aux_outputs"]) == len(ref["aux_outputs"])
    for g, r in zip(got["aux_outputs"], ref["aux_outputs"]):
        assert_close(g["pred_logits"], r["pred_logits"], **TOL)
        assert_close(g["pred_boxes"], r["pred_boxes"], **TOL)


@pytest.mark.parametrize("fusion,levels,dilation", CASES,
                         ids=[f"{f}-L{n}-{'dc5' if d else 'c5'}"
                              for f, n, d in CASES])
def test_multi_level_forward_equals_flax(fusion, levels, dilation):
    kw = model_kw(fusion, levels, dilation)
    imgs, sizes = make_frames(3 if fusion == "Baseline" else 4)
    variables, ref = flax_forward(kw, imgs, sizes)
    model = load_jax_variables(
        build_model(Config(model=ModelConfig(**kw)), device="cpu")[0],
        variables)
    out = model.eval()(*device_normalize(torch.from_numpy(imgs),
                                         torch.from_numpy(sizes)))
    # stages 2-4 then the extra levels, each half the one before
    shapes = out["_trunk"]["spatial_shapes"]
    h4 = 6 if dilation else 3
    want = ((12, 16), (6, 8), (h4, 8 * h4 // 6))
    for _ in range(levels - 3):
        h, w = want[-1]
        want += (((h + 1) // 2, (w + 1) // 2),)
    assert shapes == want
    assert_outputs_close(out, ref)


def test_two_levels_and_multi_level_video_are_refused():
    with pytest.raises(NotImplementedError, match="fail at 2"):
        check_supported(ModelConfig(num_feature_levels=2))
    with pytest.raises(NotImplementedError, match="one level"):
        check_supported(ModelConfig(num_feature_levels=4,
                                    temporal_mode="transvod_pp"),
                        training=True)
    for levels in (1, 3, 4, 5):
        check_supported(ModelConfig(num_feature_levels=levels,
                                    fusion_type="LateFusion"),
                        training=True)


# ------------------------------------------------------------- train step
def make_targets(seed, B=2, T=8, K=3, n_valid=(3, 5)):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, K - 1, (B, T)).astype(np.int32)
    cxcy = rng.uniform(0.2, 0.8, (B, T, 2))
    wh = rng.uniform(0.05, 0.35, (B, T, 2))
    valid = np.zeros((B, T), bool)
    for b, n in enumerate(n_valid):
        valid[b, :n] = True
    return {"labels": labels,
            "boxes": np.concatenate([cxcy, wh], -1).astype(np.float32),
            "valid": valid}


def step_batch(seed):
    imgs, sizes = make_frames(4, seed=seed)
    return {"images": imgs, "sizes": sizes, **make_targets(100 + seed)}


@pytest.fixture(scope="module")
def jax_steps():
    """Two steps of ``make_train_step`` (f32, 4-level LateFusion with DC5,
    dropout 0) from random flax variables."""
    kw = model_kw("LateFusion", 4, True)
    jcfg = JConfig(model=JModelConfig(**kw), train=JTrainConfig(**TRAIN))
    model = j_build_model(jcfg)[0]
    imgs, sizes = make_frames(4)
    x, mask = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    variables = dict(random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=11))
    init = copy.deepcopy(variables)
    params = variables.pop("params")
    tx, labels = j_build_optimizer(params, jcfg.model, jcfg.train,
                                   steps_per_epoch=1)
    criterion = j_criterion.SetCriterion(3, jcfg.loss, dec_layers=2)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        model_state=variables, opt_state=tx.init(params))
    step = make_train_step(model, criterion, tx, donate=False, labels=labels)
    metrics, states = [], []
    for s in (0, 1):
        state, m = step(state, jax.tree_util.tree_map(
            jnp.asarray, step_batch(s)), KEY)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(state)
    return kw, init, metrics, states


def test_multi_level_train_step_matches_make_train_step(jax_steps):
    """Loss, every component and grad_norm after one and two steps within
    atol 1e-4 / rtol 1e-3; after two steps every trainable parameter within
    atol 2e-6 / rtol 1e-5 of flax's (two Adam updates of lr 1e-5 whose
    direction a rounding-level gradient can flip), the frozen ResNet-50
    bitwise unchanged."""
    kw, init, jmetrics, jstates = jax_steps
    cfg = Config(model=ModelConfig(**kw), train=TrainConfig(**TRAIN))
    model, criterion, _ = build_model(cfg, device="cpu")
    load_jax_variables(model, copy.deepcopy(init))
    state = create_train_state(model, cfg, steps_per_epoch=1)
    for s, jm in enumerate(jmetrics):
        pm = {k: float(v) for k, v in
              train_step(state, criterion, step_batch(s)).items()}
        assert set(pm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], atol=1e-4, rtol=1e-3,
                                       err_msg=f"step {s} {k}")
    jparams = flat_params(jstates[-1].params)
    start = flat_params(init["params"])
    moved = 0
    for k, p in model.named_parameters():
        if k.startswith("backbone."):
            np.testing.assert_array_equal(p.detach().numpy(), start[k])
            continue
        assert_close(p, jparams[k], 2e-6, 1e-5, err_msg=k)
        moved += int(not np.array_equal(p.detach().numpy(), start[k]))
    assert moved > 0
    assert any(k.startswith("input_proj_3.") for k, _ in
               model.named_parameters())
