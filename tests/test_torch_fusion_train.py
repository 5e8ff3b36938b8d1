"""The train step of the paper's other two fusion modes against the JAX
package: one and two ``train_step``s of Encoder_CrossFusion and
Backbone_CrossFusion against ``make_train_step``, the gradients against
``jax.grad`` of the loss that step builds, and the DFormer BN running
statistics against flax's ``batch_stats``.

Small sizes (hidden 64, 4 heads, 2+2 layers, 12 queries, 96x128 uint8
frames), f32, dropout 0; every input is made with numpy from a seed and the
flax variables are random (``torch_port_helpers.random_variables``),
carried into the port by ``utils/convert.py``. One JAX run per mode is
shared by its tests (``jax_run``).

Frames. Both modes train on padded frames (image 1 keeps a 60 x 84
block). The jitted flax program rounds a padded pixel's sine embedding
differently from flax run op by op, and the fused backbone's sites and
convs carry that into valid pixels (``tests/test_torch_fusion_modes.py``,
``test_padded_sine_embedding_differs_under_jit``). So for
Backbone_CrossFusion the JAX step and ``jax.grad`` stay jitted but its
backbone's embedding runs op by op, through ``jax.pure_callback``
(``op_by_op_embedding``): the same JAX function on the same masks, and a
mask takes no gradient.

Tolerances, those of ``tests/test_torch_train.py`` unless named. Loss,
components and grad_norm atol 1e-4 / rtol 1e-3 (the JAX package's
full-model parity tolerance). Every gradient atol 1e-5 + 1e-3 of the
tensor's largest entry / rtol 1e-3, Backbone_CrossFusion's trained
ResNet-50 included (measured worst 1.5e-5 in relative L2 norm).
Parameters atol 1e-7 / rtol 1e-6 where the clipped step-one gradient
exceeds 1e-6. The exception: Backbone_CrossFusion's whole backbone trains
(``base``, and the fusion sites ``fusion10x``), and the update after each
step of each tensor under ``backbone.`` (the ResNet-50, the depth path
and the fusion sites) is compared in relative L2 norm, within 3e-2, the
gate of ``tests/test_torch_temporal_train.py`` (measured worst 2.4e-4 after
one step, 2.1e-4 after two). Adam's second step on an entry whose
step-two gradient is rounding noise moves it by about the learning rate
either way, and only the step-one gradient is known here, so whether an
entry of the trained ResNet-50 meets atol 1e-7 / rtol 1e-6 after two steps
depends on the data and on the order of the CPU's sums, not on the port.
DFormer BN running statistics atol 1e-5 / rtol 1e-4.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.models import backbone_crossfusion as j_bcf
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.models.position_encoding import (
    sine_position_embedding_rect as j_sine,
)
from dfvod_tpu.train.engine import TrainState as JTrainState
from dfvod_tpu.train.engine import make_train_step
from dfvod_tpu.train.optim import build_optimizer as j_build_optimizer
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu.utils.config import TrainConfig as JTrainConfig
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models.backbone_dformer import BatchNorm
from dfvod_tpu_torch.train.engine import create_train_state, forward, train_step
from dfvod_tpu_torch.utils.config import Config, ModelConfig, TrainConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables, port_key
from torch_port_helpers import assert_close, flat_params, random_variables

KEY = jax.random.PRNGKey(0)
DIMS = dict(num_classes=3, num_queries=12, hidden_dim=64, nheads=4,
            enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0,
            num_feature_levels=1)
# the recipes' optimizer, on a short cosine schedule
TRAIN = dict(lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1, epochs=3)
TOL = dict(atol=1e-4, rtol=1e-3)
UPDATE_L2 = 3e-2
MODES = ("Encoder_CrossFusion", "Backbone_CrossFusion")


def configs(mode):
    kw = dict(DIMS, fusion_type=mode)
    return (JConfig(model=JModelConfig(**kw), train=JTrainConfig(**TRAIN)),
            Config(model=ModelConfig(**kw), train=TrainConfig(**TRAIN)))


def step_batch(seed, B=2, H=96, W=128, T=8):
    """uint8 RGB-D frames (image 1 keeps a 60 x 84 block) and padded
    targets, 3 and 5 valid boxes."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, H, W, 4), dtype=np.uint8)
    sizes = np.array([[H, W], [60, 84]])
    for i, (h, w) in enumerate(sizes):
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    cxcy = rng.uniform(0.2, 0.8, (B, T, 2))
    wh = rng.uniform(0.05, 0.35, (B, T, 2))
    return {"images": imgs, "sizes": sizes,
            "labels": rng.integers(0, 2, (B, T)).astype(np.int32),
            "boxes": np.concatenate([cxcy, wh], -1).astype(np.float32),
            "valid": np.arange(T)[None] < np.array([[3], [5]])}


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def op_by_op_embedding(not_mask, num_pos_feats):
    """The fused backbone's sine embedding evaluated op by op inside a
    jitted program (module docstring)."""
    B, H, W = not_mask.shape
    return jax.pure_callback(
        lambda m: np.asarray(j_sine(jnp.asarray(m), num_pos_feats)),
        jax.ShapeDtypeStruct((B, H, W, 2 * num_pos_feats), jnp.float32),
        not_mask)


@pytest.fixture(scope="module", params=MODES)
def jax_run(request):
    """Two steps of ``make_train_step`` and ``jax.grad`` of the loss it
    builds (frozen parameters stopped) at the initial variables: (mode,
    initial variables, batches, grads, metrics, states)."""
    mode = request.param
    with pytest.MonkeyPatch.context() as mp:
        if mode == "Backbone_CrossFusion":
            mp.setattr(j_bcf, "sine_position_embedding", op_by_op_embedding)
        return jax_steps(mode)


def jax_steps(mode):
    jcfg, _ = configs(mode)
    model, criterion, _ = j_build_model(jcfg)
    batches = [step_batch(s) for s in (0, 1)]
    x, mask = j_normalize(jnp.asarray(batches[0]["images"]),
                          jnp.asarray(batches[0]["sizes"]))
    variables = dict(random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=11))
    params = variables.pop("params")
    tx, labels = j_build_optimizer(params, jcfg.model, jcfg.train,
                                   steps_per_epoch=1)

    def loss_fn(p, model_state, batch):
        p = jax.tree_util.tree_map(
            lambda v, lab: jax.lax.stop_gradient(v) if lab == "frozen"
            else v, p, labels)
        images, mask = j_normalize(batch["images"], batch["sizes"])
        out, _ = model.apply({"params": p, **model_state}, images, mask,
                             train=True, rngs={"dropout": KEY},
                             mutable=["batch_stats"])
        targets = {k: batch[k] for k in ("labels", "boxes", "valid")}
        return criterion(out, targets)

    grads, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(
        params, variables, to_jax(batches[0]))
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        model_state=variables, opt_state=tx.init(params))
    step = make_train_step(model, criterion, tx, donate=False, labels=labels)
    metrics, states = [], [state]
    for batch in batches:
        state, m = step(state, to_jax(batch), KEY)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(state)
    init = {"params": params, **variables}
    return mode, init, batches, grads, metrics, states


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's gradients before the clip at the initial weights, and
    its metrics, parameters, state and exactly-zero gradient entries over
    two steps."""
    mode, init, batches, _, _, _ = jax_run
    _, cfg = configs(mode)
    model, criterion, _ = build_model(cfg, device="cpu")
    model = load_jax_variables(model, copy.deepcopy(init))
    gstate = create_train_state(copy.deepcopy(model), cfg, steps_per_epoch=1)
    loss, _ = criterion(*forward(gstate, batches[0]))
    loss.backward()
    grads = {k: p.grad for k, p in gstate.model.named_parameters()}
    state = create_train_state(model, cfg, steps_per_epoch=1)
    metrics, params, zero = [], [], []
    for batch in batches:
        metrics.append({k: float(v) for k, v in
                        train_step(state, criterion, batch).items()})
        params.append({k: p.detach().clone()
                       for k, p in model.named_parameters()})
        zero.append({k: True if p.grad is None else (p.grad == 0).numpy()
                     for k, p in model.named_parameters()})
    return grads, metrics, params, state, zero


def rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(float(np.linalg.norm(want)), 1e-30))


def norm_gated(mode, name):
    """Whether the tensor's update is compared in relative L2 norm (module
    docstring): Backbone_CrossFusion's backbone."""
    return mode == "Backbone_CrossFusion" and name.startswith("backbone.")


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_steps"])
def test_train_step_metrics_match_make_train_step(jax_run, port_run, step):
    """Loss, every component and grad_norm after one and two steps."""
    mode, _, _, _, jmetrics, _ = jax_run
    jm, pm = jmetrics[step], port_run[1][step]
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], **TOL,
                                   err_msg=f"{mode} step {step} {k}")


def test_train_step_gradients_match_jax_grad(jax_run, port_run):
    """Every gradient against ``jax.grad``, atol 1e-5 + 1e-3 of the
    tensor's largest entry / rtol 1e-3. Encoder_CrossFusion's frozen
    ResNet-50 has no gradient in the port and an exact zero one in JAX;
    its fusion layers have one. Backbone_CrossFusion's whole backbone has
    one."""
    mode, _, _, jgrads, _, _ = jax_run
    jgrads = flat_params(jgrads)
    grads = port_run[0]
    frozen = {k for k, g in grads.items() if g is None}
    if mode == "Encoder_CrossFusion":
        assert frozen and all(k.startswith("backbone.") for k in frozen)
        assert grads["transformer.fusion_layers_1.cross_attn.value_proj."
                     "weight"] is not None
    else:
        assert not frozen
    for k, g in grads.items():
        if g is None:
            np.testing.assert_array_equal(jgrads[k], 0.0, err_msg=k)
        else:
            scale = float(np.abs(jgrads[k]).max())
            assert_close(g, jgrads[k], 1e-5 + 1e-3 * scale, 1e-3,
                         err_msg=k)


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_steps"])
def test_train_step_parameters_match(jax_run, port_run, step):
    """Parameters after each step, at the tolerances of the module
    docstring, over the entries whose every clipped gradient so far
    exceeds 1e-6 (or, for an update compared in norm, is exactly zero on
    both sides: a dead ReLU, where the step is weight decay alone); frozen parameters bitwise
    unchanged; more than half of the trainable entries compared."""
    mode, init, _, jgrads, jmetrics, jstates = jax_run
    jparams = flat_params(jstates[step + 1].params)
    jgrads = flat_params(jgrads)
    clip = min(1.0, TRAIN["clip_max_norm"] / jmetrics[0]["grad_norm"])
    init = flat_params(init["params"])
    labels = port_run[3].labels
    zero = port_run[4][0]
    kept = total = 0
    for k, p in port_run[2][step].items():
        if labels[k] == "frozen":
            np.testing.assert_array_equal(p.numpy(), init[k])
            continue
        g = np.abs(jgrads[k]) * clip
        keep = g > 1e-6
        if norm_gated(mode, k):
            keep |= (g == 0) & zero[k]
        kept, total = kept + int(keep.sum()), total + keep.size
        if not keep.any():
            continue
        if norm_gated(mode, k):
            rel = rel_l2((p.numpy() - init[k])[keep],
                         (jparams[k] - init[k])[keep])
            assert rel <= UPDATE_L2, (k, rel)
        else:
            np.testing.assert_allclose(p.numpy()[keep], jparams[k][keep],
                                       atol=1e-7, rtol=1e-6, err_msg=k)
    assert kept > 0.5 * total, kept / total


def test_depth_bn_statistics_match_flax(jax_run, port_run):
    """The DFormer BN running statistics after two steps against flax's
    ``batch_stats``: under ``depth_backbone.`` for Encoder_CrossFusion,
    under ``backbone.`` (the depth path in the fused backbone) for
    Backbone_CrossFusion; every one of them moved."""
    mode, init, _, _, _, jstates = jax_run
    model = port_run[3].model
    bns = {n for n, m in model.named_modules() if isinstance(m, BatchNorm)}
    prefix = ("backbone." if mode == "Backbone_CrossFusion"
              else "depth_backbone.")
    assert len(bns) == 4 and all(n.startswith(prefix) for n in bns)
    state = model.state_dict()
    stats = jstates[2].model_state["batch_stats"]
    start = init["batch_stats"]
    n = 0
    for path, v in jax.tree_util.tree_flatten_with_path(stats)[0]:
        keys = tuple(k.key for k in path)
        key, val = port_key("batch_stats", keys, np.asarray(v))
        assert key.startswith(prefix), key
        assert_close(state[key], val, 1e-5, 1e-4, err_msg=key)
        before = start
        for k in keys:
            before = before[k]
        assert not np.array_equal(np.asarray(before), val), key
        n += 1
    assert n == 2 * len(bns)
