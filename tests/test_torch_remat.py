"""Encoder remat (``ModelConfig.remat``): each encoder layer's activations
recomputed in the backward (``models/layers.py::remat_call``, the
counterpart of ``nn.remat(DeformableTransformerEncoderLayer)`` in
``dfvod_tpu/models/transformer.py``).

- A small LateFusion remat train step against JAX's ``make_train_step``
  on the flax model with ``remat=True`` (dropout 0: the two packages' RNGs
  differ): the loss and its components atol 1e-4 / rtol 1e-3; every
  gradient against ``jax.grad`` of the engine's loss at atol 1e-5 + 1e-3
  of the tensor's largest entry, rtol 1e-3 (``tests/test_torch_train.py``'s
  gate).
- With dropout 0.2, the port's remat step against its non-remat step from
  the same weights, batch and generator state: loss, every gradient and
  the generator's state afterwards bitwise equal on the CPU (the
  recomputation repeats the same ops on the same masks). The same for
  Encoder_CrossFusion, whose fusion layers are not recomputed. A
  recomputation without the generator's state draws other masks: the
  gradients then differ.

Small sizes (hidden 64, 4 heads, 2+2 layers, 12 queries, 96x128 uint8
frames with real padding); inputs made with numpy from a seed.
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
from dfvod_tpu_torch.models import build_model, layers
from dfvod_tpu_torch.train.engine import create_train_state, forward
from dfvod_tpu_torch.utils.config import Config, ModelConfig, TrainConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import (
    assert_close,
    flat_params,
    make_frames,
    random_variables,
)

DIMS = dict(num_classes=3, num_queries=12, hidden_dim=64, nheads=4,
            enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0,
            num_feature_levels=1, fusion_type="LateFusion")
TRAIN = dict(lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1, epochs=3)


def step_batch(seed):
    rng = np.random.default_rng(100 + seed)
    imgs, sizes = make_frames(4, seed=seed)
    valid = np.arange(8)[None] < np.array([[3], [5]])
    return {"images": imgs, "sizes": sizes,
            "labels": rng.integers(0, 2, (2, 8)).astype(np.int32),
            "boxes": np.concatenate([rng.uniform(0.2, 0.8, (2, 8, 2)),
                                     rng.uniform(0.05, 0.35, (2, 8, 2))],
                                    -1).astype(np.float32),
            "valid": valid}


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """One ``make_train_step`` of the flax remat model and ``jax.grad`` of
    the loss it builds, at random flax variables."""
    jcfg = JConfig(model=JModelConfig(**DIMS, remat=True),
                   train=JTrainConfig(**TRAIN))
    model = j_build_model(jcfg)[0]
    batch = step_batch(0)
    x, mask = j_normalize(jnp.asarray(batch["images"]),
                          jnp.asarray(batch["sizes"]))
    variables = dict(random_variables(
        lambda: model.init(jax.random.PRNGKey(0), x, mask, train=False),
        seed=11))
    init = copy.deepcopy({k: jax.tree_util.tree_map(np.asarray, v)
                          for k, v in variables.items()})
    criterion = j_criterion.SetCriterion(3, jcfg.loss, dec_layers=2)
    params = variables.pop("params")
    tx, labels = j_build_optimizer(params, jcfg.model, jcfg.train,
                                   steps_per_epoch=1)

    def loss_fn(p):
        p = jax.tree_util.tree_map(
            lambda v, lab: jax.lax.stop_gradient(v) if lab == "frozen"
            else v, p, labels)
        images, m = j_normalize(batch["images"], batch["sizes"])
        out, _ = model.apply({"params": p, **variables}, images, m,
                             train=True,
                             rngs={"dropout": jax.random.PRNGKey(0)},
                             mutable=["batch_stats"])
        return criterion(out, {k: batch[k] for k in ("labels", "boxes",
                                                     "valid")})

    grads, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        model_state=variables, opt_state=tx.init(params))
    step = make_train_step(model, criterion, tx, donate=False, labels=labels)
    _, metrics = step(state, to_jax(batch), jax.random.PRNGKey(0))
    return init, batch, flat_params(grads), {k: float(v) for k, v in
                                             metrics.items()}


def port_step(cfg, batch, variables=None, seed=0):
    """The loss, its parts and every gradient of one train-step forward
    and backward, the dropout generator's state after it, and the MSDA
    calls made (forward and recomputation)."""
    model, criterion, _ = build_model(cfg, device="cpu", seed=seed)
    if variables is not None:
        load_jax_variables(model, copy.deepcopy(variables))
    state = create_train_state(model, cfg, steps_per_epoch=1)
    calls = []
    msda = layers.ms_deform_attn

    def counting(*a, **kw):
        calls.append(1)
        return msda(*a, **kw)
    layers.ms_deform_attn = counting
    try:
        loss, parts = criterion(*forward(state, batch))
        loss.backward()
    finally:
        layers.ms_deform_attn = msda
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    return loss.detach(), parts, grads, state.generator.get_state(), \
        len(calls)


def test_remat_step_matches_make_train_step(jax_run):
    init, batch, jgrads, jmetrics = jax_run
    cfg = Config(model=ModelConfig(**DIMS, remat=True),
                 train=TrainConfig(**TRAIN))
    loss, parts, grads, _, calls = port_step(cfg, batch, init)
    assert calls == 5 + 2          # 5 MSDA layers, 2 encoder layers again
    np.testing.assert_allclose(float(loss), jmetrics["loss"], atol=1e-4,
                               rtol=1e-3)
    for k, v in parts.items():
        np.testing.assert_allclose(float(v.detach()), jmetrics[k],
                                   atol=1e-4, rtol=1e-3, err_msg=k)
    assert set(grads) == {k for k in jgrads if not k.startswith("backbone.")}
    for k, g in grads.items():
        scale = float(np.abs(jgrads[k]).max())
        assert_close(g, jgrads[k], 1e-5 + 1e-3 * scale, 1e-3, err_msg=k)


@pytest.mark.parametrize("fusion,msda_layers",
                         [("LateFusion", 5), ("Encoder_CrossFusion", 6)])
def test_remat_step_equals_the_plain_step_with_dropout(fusion, msda_layers):
    """Dropout 0.2: bitwise equal loss, gradients and generator state;
    only the 2 encoder layers' MSDA runs again (not the LateFusion or
    fusion layers)."""
    batch = step_batch(1)
    kw = dict(DIMS, fusion_type=fusion, dropout=0.2)
    results = [port_step(Config(model=ModelConfig(**kw, remat=remat),
                                train=TrainConfig(**TRAIN)), batch)
               for remat in (False, True)]
    (loss0, parts0, g0, gen0, c0), (loss1, parts1, g1, gen1, c1) = results
    assert (c0, c1) == (msda_layers, msda_layers + 2)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(parts0[k], parts1[k]) for k in parts0)
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert torch.equal(gen0, gen1)


def test_recomputation_without_the_generator_state_draws_other_masks(
        monkeypatch):
    """The witness of the trap ``remat_call`` handles: a plain
    ``checkpoint`` recomputes with the generator where the forward left
    it, and the encoder layers' gradients change."""
    from torch.utils.checkpoint import checkpoint

    def naive(module, *args):
        return checkpoint(module, *args, use_reentrant=False)
    batch = step_batch(1)
    cfg = Config(model=ModelConfig(**dict(DIMS, dropout=0.2), remat=True),
                 train=TrainConfig(**TRAIN))
    ref = port_step(cfg, batch)[2]
    from dfvod_tpu_torch.models import transformer
    monkeypatch.setattr(transformer, "remat_call", naive)
    got = port_step(cfg, batch)[2]
    differ = [k for k in ref if not torch.equal(ref[k], got[k])]
    assert any(k.startswith("transformer.encoder_layers_") for k in differ)


def test_remat_is_a_no_op_in_eval():
    batch = step_batch(2)
    outs = []
    for remat in (False, True):
        cfg = Config(model=ModelConfig(**dict(DIMS, dropout=0.2),
                                       remat=remat))
        model = build_model(cfg, device="cpu", seed=0)[0]
        from dfvod_tpu_torch.train.evaluate import eval_forward
        outs.append(eval_forward(model, batch["images"], batch["sizes"]))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
