"""The port's video training step against the JAX package: two
``train_step``s of TransVOD++ and TransVOD+TDAM models against
``make_train_step(frames=F, labels=labels)``, gradients against
``jax.grad`` of the loss that step builds, and the temporal label tree.

Tiny widths (hidden 32, 4 heads, 1+3 layers, 100 queries so that every
top-k round really selects), f32, dropout 0, uint8 frames with targets on
every frame row (``cli/main.py::to_batch``); the criterion reads the key
frames' rows. Every input is made with numpy from a seed, the flax
variables are random in every leaf and carried into the port by
``utils/convert.py``. One JAX run per configuration is shared by its tests
(``jax_run``).

Tolerances. Loss, components and grad_norm atol 1e-4 / rtol 1e-3 (the JAX
package's full-model parity tolerance). Gradients and parameter updates
are compared per tensor in relative L2 norm, not entry by entry: at these
random weights the ReLUs of the trunk and of the QRF head make the
gradient ill-conditioned, and XLA and PyTorch round differently at every
op. Noise of 1e-6 on the normalized frames, a few f32 ulps, moves the
port's own gradients beyond any elementwise tolerance of the single-frame
step's tests, but by less than half the norm tolerance
(``test_gradient_tolerance_sits_above_the_noise_floor``; measured up to
5.2e-3). Each gradient within 1.5e-2 of JAX's (measured worst 2.2e-3
TransVOD++, 1.05e-2 TransVOD+TDAM, 1.2e-4 with the trunk fixed; a
structurally zero one, JAX's largest entry below 1e-4, within atol 1e-4).
Each tensor's update after one and two steps (parameters minus their
initial values) within 3e-2 (measured worst 8.8e-3, 2.19e-2, 1.5e-3), over
the entries whose every Adam step so far is decided: its clipped gradient
exceeds 1e-6 (100x Adam's epsilon, as the single-frame test masks), or is
exactly zero in JAX and in the port (a dead ReLU: the step is weight decay
alone). A step on a gradient between those is the sign of rounding noise,
+-lr. At least ``MIN_KEPT`` of the trainable entries are compared. Frozen
parameters are bitwise unchanged, the frozen trunk has no gradient where
JAX's is exactly zero, and the DFormer BN running statistics match at
atol 1e-5 / rtol 1e-4.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.train.engine import TrainState as JTrainState
from dfvod_tpu.train.engine import make_train_step
from dfvod_tpu.train.optim import build_optimizer as j_build_optimizer
from dfvod_tpu.train.optim import label_params as j_label_params
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu.utils.config import TrainConfig as JTrainConfig
from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.train import engine
from dfvod_tpu_torch.train.engine import create_train_state, forward, train_step
from dfvod_tpu_torch.utils.config import Config, ModelConfig, TrainConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables, port_key
from torch_port_helpers import assert_close, flat_params, random_variables

KEY = jax.random.PRNGKey(0)
DIMS = dict(num_classes=3, num_queries=100, hidden_dim=32, nheads=4,
            enc_layers=1, dec_layers=3, dim_feedforward=64, dropout=0.0,
            num_feature_levels=1, fusion_type="LateFusion")
TRAIN = dict(lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1, epochs=3)
# name: (model kwargs, clips, padded frames). The TDAM model reads the
# reference frames' padded tokens unmasked, whose sine embedding XLA and
# PyTorch round differently (ROADMAP Queue 3): it runs on unpadded frames
CONFIGS = {
    "transvod_pp": (dict(temporal_mode="transvod_pp", num_ref_frames=2), 2,
                    True),
    "transvod_tdam": (dict(temporal_mode="transvod", use_tdam=True,
                           num_ref_frames=3), 1, False),
    "transvod_pp_fixed": (dict(temporal_mode="transvod_pp", num_ref_frames=2,
                               fixed_pretrained_model=True), 1, True),
}
TOL = dict(atol=1e-4, rtol=1e-3)
GRAD_L2, UPDATE_L2 = 1.5e-2, 3e-2
# the least share of the trainable entries whose update after one / two
# steps is compared (measured 0.797 / 0.709, 0.831 / 0.743, 0.913 / 0.852)
MIN_KEPT = {"transvod_pp": (0.75, 0.65), "transvod_tdam": (0.8, 0.7),
            "transvod_pp_fixed": (0.9, 0.8)}


def clip_batch(seed, clips, F, padded, H=64, W=96, T=6):
    """uint8 RGB-D frames of ``clips`` clips of F frames (with ``padded``
    the second frame of every clip keeps a 40 x 70 block) and targets on
    every frame row, different per frame, 2..4 valid boxes per row."""
    rng = np.random.default_rng(seed)
    n = clips * F
    imgs = rng.integers(0, 256, (n, H, W, 4), dtype=np.uint8)
    sizes = np.array([[H, W]] * n)
    if padded:
        sizes[1::F] = [40, 70]
    for i, (h, w) in enumerate(sizes):
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    valid = np.arange(T)[None] < rng.integers(2, 5, (n, 1))
    cxcy = rng.uniform(0.2, 0.8, (n, T, 2))
    wh = rng.uniform(0.05, 0.35, (n, T, 2))
    return {"images": imgs, "sizes": sizes,
            "labels": rng.integers(0, 2, (n, T)).astype(np.int32),
            "boxes": np.concatenate([cxcy, wh], -1).astype(np.float32),
            "valid": valid}


def configs(name):
    kw = dict(DIMS, **CONFIGS[name][0])
    return (JConfig(model=JModelConfig(**kw), train=JTrainConfig(**TRAIN)),
            Config(model=ModelConfig(**kw), train=TrainConfig(**TRAIN)))


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module", params=list(CONFIGS))
def jax_run(request):
    """Two steps of ``make_train_step(frames=F, labels=labels)`` and, before
    each, ``jax.grad`` of the loss it builds (frozen parameters stopped,
    targets of the key frames), at the same random flax variables: (name,
    initial variables, batches, grads per step, metrics, states)."""
    name = request.param
    jcfg, _ = configs(name)
    _, clips, padded = CONFIGS[name]
    F = 1 + jcfg.model.num_ref_frames
    model, criterion, _ = j_build_model(jcfg)
    batches = [clip_batch(s, clips, F, padded) for s in (0, 1)]
    x, mask = j_normalize(jnp.asarray(batches[0]["images"]),
                          jnp.asarray(batches[0]["sizes"]))
    variables = dict(random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=31))
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
        targets = {k: batch[k].reshape(-1, F, *batch[k].shape[1:])[:, 0]
                   for k in ("labels", "boxes", "valid")}
        return criterion(out, targets)

    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        model_state=variables, opt_state=tx.init(params))
    step = make_train_step(model, criterion, tx, donate=False, frames=F,
                           labels=labels)
    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    grads, metrics, states = [], [], [state]
    for batch in batches:
        grads.append(grad_fn(state.params, state.model_state,
                             to_jax(batch))[0])
        state, m = step(state, to_jax(batch), KEY)
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(state)
    init = {"params": params, **variables}
    return name, init, batches, grads, metrics, states


def port_grads(name, init, batch, noise=0.0):
    """The port's gradients before the clip at the initial weights; with
    ``noise``, N(0, noise^2) added to the normalized frames (seeded)."""
    _, cfg = configs(name)
    model, criterion, _ = build_model(cfg, device="cpu")
    state = create_train_state(load_jax_variables(model, copy.deepcopy(init)),
                               cfg, steps_per_epoch=1)

    def noisy(images, sizes):
        x, mask = device_normalize(images, sizes)
        gen = torch.Generator().manual_seed(1)
        return x + noise * torch.randn(x.shape, generator=gen), mask

    engine.device_normalize = noisy
    try:
        loss, _ = criterion(*forward(state, batch))
    finally:
        engine.device_normalize = device_normalize
    loss.backward()
    return {k: p.grad for k, p in model.named_parameters()}


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's gradients before the clip, and its metrics, parameters,
    state and where each step's gradient is exactly zero, over two
    steps."""
    name, init, batches, _, _, _ = jax_run
    _, cfg = configs(name)
    model, criterion, _ = build_model(cfg, device="cpu")
    model = load_jax_variables(model, copy.deepcopy(init))
    state = create_train_state(model, cfg, steps_per_epoch=1)
    metrics, params, zero = [], [], []
    for batch in batches:
        metrics.append({k: float(v) for k, v in
                        train_step(state, criterion, batch).items()})
        params.append({k: p.detach().clone()
                       for k, p in model.named_parameters()})
        zero.append({k: True if p.grad is None else (p.grad == 0).numpy()
                     for k, p in model.named_parameters()})
    return (port_grads(name, init, batches[0]), metrics, params, state,
            zero)


def rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(float(np.linalg.norm(want)), 1e-30))


def grads_agree(got, want):
    """(ok, relative L2 error) of one gradient tensor against another, at
    the tolerance of the module docstring."""
    got = got.numpy()
    rel = rel_l2(got, want)
    tiny = float(np.abs(want).max()) < 1e-4
    return (rel <= GRAD_L2
            or (tiny and float(np.abs(got - want).max()) <= 1e-4)), rel


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_steps"])
def test_video_train_step_metrics_match_make_train_step(jax_run, port_run,
                                                        step):
    """Loss, every component (the final round's and rounds 1-2's ``_0`` /
    ``_1`` for TransVOD++) and grad_norm after one and two steps; every
    component is weighted into the loss."""
    name, _, _, _, jmetrics, _ = jax_run
    jm, pm = jmetrics[step], port_run[1][step]
    assert set(pm) == set(jm)
    aux = {k for k in pm if k.endswith(("_0", "_1"))}
    assert bool(aux) == name.startswith("transvod_pp")
    weights = build_model(configs(name)[1], device="cpu")[1].weight_dict
    assert all(k in weights for k in pm
               if k not in ("loss", "grad_norm", "cardinality_error"))
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], **TOL,
                                   err_msg=f"{name} step {step} {k}")


def test_video_train_step_gradients_match_jax_grad(jax_run, port_run):
    """Every gradient against ``jax.grad``, at the tolerance of the module
    docstring. The ResNet-50 trains here (the temporal optimizer is flat),
    unless ``fixed_pretrained_model`` freezes the trunk; a parameter
    without a gradient in the port (the frozen trunk, the trunk's heads,
    whose outputs the temporal loss does not read) has an exact zero one
    in JAX."""
    name, _, _, jgrads, _, _ = jax_run
    jgrads = flat_params(jgrads[0])
    grads = port_run[0]
    fixed = name.endswith("_fixed")
    assert (grads["detr.backbone.conv1.weight"] is None) == fixed
    assert all(g is not None for k, g in grads.items()
               if not k.startswith("detr."))
    for k, g in grads.items():
        if g is None:
            np.testing.assert_array_equal(jgrads[k], 0.0, err_msg=k)
            continue
        ok, rel = grads_agree(g, jgrads[k])
        assert ok, f"{name} {k}: relative L2 error {rel:.3e}"


def test_gradient_tolerance_sits_above_the_noise_floor(jax_run, port_run):
    """Noise of 1e-6 on the normalized frames (a few f32 ulps) moves the
    port's own gradients beyond atol 1e-4 / rtol 1e-3 entry by entry, but
    each tensor by less than half the norm tolerance the gradients are
    compared with."""
    name, init, batches, _, _, _ = jax_run
    grads = port_run[0]
    noisy = port_grads(name, init, batches[0], noise=1e-6)
    elementwise = True
    for k, g in grads.items():
        if g is None:
            assert noisy[k] is None, k
            continue
        rel = rel_l2(noisy[k].numpy(), g.numpy())
        assert rel <= GRAD_L2 / 2 or float(g.abs().max()) < 1e-4, (k, rel)
        elementwise &= bool(torch.isclose(noisy[k], g, atol=1e-4,
                                          rtol=1e-3).all())
    assert not elementwise


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_steps"])
def test_video_train_step_parameters_match(jax_run, port_run, step):
    """Parameters after each step, at the tolerance of the module
    docstring: each tensor's update over the entries whose every Adam step
    so far is decided (see ``MIN_KEPT``), and at least that share of the
    trainable entries kept; frozen parameters bitwise unchanged; the
    DFormer BN running statistics match flax's after both steps."""
    name, init, _, jgrads, jmetrics, jstates = jax_run
    jparams = flat_params(jstates[step + 1].params)
    jgrads = [flat_params(g) for g in jgrads[:step + 1]]
    clips = [min(1.0, TRAIN["clip_max_norm"] / m["grad_norm"])
             for m in jmetrics]
    zero = port_run[4]
    init = flat_params(init["params"])
    labels = port_run[3].labels
    kept = total = 0
    for k, p in port_run[2][step].items():
        if labels[k] == "frozen":
            np.testing.assert_array_equal(p.numpy(), init[k])
            continue
        keep = np.ones(p.shape, bool)
        for i, g in enumerate(jgrads):
            g = np.abs(g[k]) * clips[i]
            keep &= (g > 1e-6) | ((g == 0) & zero[i][k])
        kept, total = kept + int(keep.sum()), total + keep.size
        if keep.any():
            rel = rel_l2((p.numpy() - init[k])[keep],
                         (jparams[k] - init[k])[keep])
            assert rel <= UPDATE_L2, f"{name} {k}: {rel:.3e}"
    assert kept >= MIN_KEPT[name][step] * total, kept / total
    if step == 1:
        state = port_run[3].model.state_dict()
        stats = jstates[2].model_state["batch_stats"]
        for path, v in jax.tree_util.tree_flatten_with_path(stats)[0]:
            key, val = port_key("batch_stats", tuple(k.key for k in path),
                                np.asarray(v))
            assert_close(state[key], val, 1e-5, 1e-4, err_msg=key)


@pytest.mark.parametrize("fixed", [False, True],
                         ids=["flat", "fixed_pretrained_model"])
def test_temporal_labels_match_jax(fixed):
    """The port's label of every parameter equals the JAX package's
    ``label_params(..., temporal=True)``: the flat 2-group optimizer
    (``base`` and ``linear_proj``), and with ``fixed_pretrained_model``
    every parameter outside the temporal head ``frozen``."""
    name = "transvod_pp_fixed" if fixed else "transvod_pp"
    jcfg, cfg = configs(name)
    model = j_build_model(jcfg)[0]
    batch = clip_batch(0, 1, 3, True)
    x, mask = j_normalize(jnp.asarray(batch["images"]),
                          jnp.asarray(batch["sizes"]))
    params = jax.eval_shape(lambda: model.init(KEY, x, mask, train=False)
                            )["params"]
    jlabels = j_label_params(params, "LateFusion", fixed, temporal=True)
    want = {}
    for kp, lab in jax.tree_util.tree_flatten_with_path(jlabels)[0]:
        key, _ = port_key("params", tuple(k.key for k in kp),
                          np.zeros((1, 1)))
        want[key] = lab
    state = create_train_state(build_model(cfg, device="cpu")[0], cfg)
    assert state.labels == want
    assert set(want.values()) == ({"base", "linear_proj", "frozen"} if fixed
                                  else {"base", "linear_proj"})
    groups = {g["label"] for g in state.optimizer.param_groups}
    assert groups == {"base", "linear_proj"}
