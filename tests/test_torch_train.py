"""The port's training slice against the JAX package: box ops, matcher,
criterion, optimizer, train-mode DFormer BatchNorm, and whole train steps.

Small sizes (hidden 64, 4 heads, 2+2 layers, 12 queries, 96x128 uint8
frames with real padding); every input is made with numpy from a seed and
the flax variables are random (``torch_port_helpers.random_variables``),
carried into the port by ``utils/convert.py``. Every tolerance is stated
where it is used. The JAX step program is compiled and run once per module
(``jax_run``), and its results are shared.
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.models import criterion as j_criterion
from dfvod_tpu.models.backbone_dformer import (
    DFormerBackbone as JDFormerBackbone,
)
from dfvod_tpu.models.matcher import hungarian_lapjv
from dfvod_tpu.models.matcher import matching_cost as j_matching_cost
from dfvod_tpu.train.engine import TrainState as JTrainState
from dfvod_tpu.train.engine import make_train_step
from dfvod_tpu.train.optim import build_optimizer as j_build_optimizer
from dfvod_tpu.utils import box_ops as j_box_ops
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import LossConfig as JLossConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu.utils.config import TrainConfig as JTrainConfig
from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models.backbone_dformer import DFormerBackbone
from dfvod_tpu_torch.models.criterion import SetCriterion
from dfvod_tpu_torch.models.layers import Dropout, set_dropout_generator
from dfvod_tpu_torch.models.matcher import match_layers, matching_cost, solve
from dfvod_tpu_torch.train.engine import (
    apply_gradients,
    create_train_state,
    forward,
    train_step,
)
from dfvod_tpu_torch.utils import box_ops
from dfvod_tpu_torch.utils.config import (
    Config,
    LossConfig,
    ModelConfig,
    TrainConfig,
    check_supported,
)
from dfvod_tpu_torch.utils.convert import load_jax_variables, port_key
from torch_port_helpers import (
    assert_close,
    flat_params,
    random_variables,
)

DIMS = dict(num_classes=3, num_queries=12, hidden_dim=64, nheads=4,
            enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0,
            num_feature_levels=1)
# the LateFusion_bf16.sh recipe's optimizer, on a short cosine schedule
TRAIN = dict(lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1, epochs=3)


def t(x):
    return torch.from_numpy(np.asarray(x))


def make_frames(channels, seed=0, B=2, H=96, W=128):
    """uint8 frames padded bottom/right: image 1 keeps a 60 x 84 block."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, H, W, channels), dtype=np.uint8)
    sizes = np.array([[H, W], [60, 84]][:B])
    for i, (h, w) in enumerate(sizes):
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    return imgs, sizes


def make_targets(seed, B=2, T=8, K=3, n_valid=(3, 5), prefix=True):
    """Padded targets. With ``prefix=False`` the valid slots are scattered
    among the invalid ones."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, K - 1, (B, T)).astype(np.int32)
    cxcy = rng.uniform(0.2, 0.8, (B, T, 2))
    wh = rng.uniform(0.05, 0.35, (B, T, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    valid = np.zeros((B, T), bool)
    for b, n in enumerate(n_valid):
        idx = np.arange(n) if prefix else rng.choice(T, n, replace=False)
        valid[b, idx] = True
    return {"labels": labels, "boxes": boxes, "valid": valid}


def make_outputs(seed, B=2, Q=12, K=3, layers=2):
    """Model-like outputs: final layer plus ``layers - 1`` aux layers."""
    rng = np.random.default_rng(seed)

    def one():
        cxcy = rng.uniform(0.1, 0.9, (B, Q, 2))
        wh = rng.uniform(0.02, 0.5, (B, Q, 2))
        return {"pred_logits": rng.standard_normal((B, Q, K)).astype(
                    np.float32),
                "pred_boxes": np.concatenate([cxcy, wh], -1).astype(
                    np.float32)}
    out = one()
    out["aux_outputs"] = [one() for _ in range(layers - 1)]
    return out


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def to_torch(tree):
    return jax.tree_util.tree_map(t, tree)


# ---------------------------------------------------------------- box ops
def test_box_ops_match_jax():
    rng = np.random.default_rng(0)
    a = box_ops.box_cxcywh_to_xyxy(t(rng.uniform(0.1, 0.6, (7, 4)).astype(
        np.float32)))
    b = box_ops.box_cxcywh_to_xyxy(t(rng.uniform(0.1, 0.6, (5, 4)).astype(
        np.float32)))
    ja, jb = jnp.asarray(a.numpy()), jnp.asarray(b.numpy())
    assert_close(box_ops.box_area(a), j_box_ops.box_area(ja), 1e-7, 1e-6)
    iou, union = box_ops.box_iou(a, b)
    jiou, junion = j_box_ops.box_iou(ja, jb)
    assert_close(iou, jiou, 1e-6, 1e-6)
    assert_close(union, junion, 1e-6, 1e-6)
    assert_close(box_ops.generalized_box_iou(a, b),
                 j_box_ops.generalized_box_iou(ja, jb), 1e-6, 1e-6)
    # batched pairwise GIoU is the 2-D one per batch row
    assert_close(box_ops.generalized_box_iou(a[None].expand(3, -1, -1),
                                             b[None].expand(3, -1, -1))[1],
                 j_box_ops.generalized_box_iou(ja, jb), 1e-6, 1e-6)
    assert_close(box_ops.elementwise_generalized_box_iou(a[:5], b),
                 j_box_ops.elementwise_generalized_box_iou(ja[:5], jb),
                 1e-6, 1e-6)
    x = t(rng.uniform(-0.1, 1.1, (20,)).astype(np.float32))
    assert_close(box_ops.inverse_sigmoid(x),
                 j_box_ops.inverse_sigmoid(jnp.asarray(x.numpy())), 1e-6,
                 1e-6)


# ---------------------------------------------------------------- matcher
@pytest.mark.parametrize("prefix", [True, False],
                         ids=["valid_prefix", "valid_scattered"])
def test_matching_cost_matches_jax(prefix):
    """The batched cost against the JAX per-image cost, atol/rtol 1e-5."""
    out = make_outputs(1)
    tg = make_targets(2, prefix=prefix)
    got = matching_cost(t(out["pred_logits"]), t(out["pred_boxes"]),
                        t(tg["labels"]), t(tg["boxes"]), t(tg["valid"]))
    ref = jax.vmap(j_matching_cost)(*to_jax((
        out["pred_logits"], out["pred_boxes"], tg["labels"], tg["boxes"],
        tg["valid"])))
    assert_close(got, ref, 1e-5, 1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assignment_equals_lapjv(seed):
    """scipy's exact assignment equals the JAX package's on-device LAPJV on
    random costs, with the valid target columns scattered among invalid
    ones (assignments of invalid slots are arbitrary and not compared)."""
    rng = np.random.default_rng(seed)
    B, Q, T = 4, 30, 10
    cost = rng.standard_normal((B, Q, T)).astype(np.float32)
    valid = rng.random((B, T)) < 0.6
    valid[0] = False                       # an image without targets
    got = solve(cost, valid)
    ref = np.asarray(hungarian_lapjv(jnp.asarray(cost), jnp.asarray(valid)))
    np.testing.assert_array_equal(got[valid], ref[valid])
    for b in range(B):                     # a matching: no query twice
        assert len(set(got[b][valid[b]])) == valid[b].sum()


def test_nan_costs_do_not_hang():
    """A diverged step's NaN outputs still give an assignment (the costs
    are sanitized as in ``matcher.py:209``)."""
    out = make_outputs(3)
    out["pred_logits"][0, :4] = np.nan
    out["pred_boxes"][1] = np.inf
    tg = make_targets(4)
    assign = match_layers([{k: t(out[k]) for k in ("pred_logits",
                                                   "pred_boxes")}],
                          to_torch(tg), LossConfig())
    assert assign.shape == (1, 2, 8)
    assert bool(((assign >= 0) & (assign < 12)).all())


# -------------------------------------------------------------- criterion
@pytest.mark.parametrize("K", [3, 5], ids=["modified_focal", "focal"])
def test_criterion_matches_jax(K):
    """Every loss, aux layers included, and the weighted total against the
    JAX SetCriterion (LAPJV matcher), atol/rtol 1e-5."""
    out = make_outputs(5, K=K, layers=3)
    tg = make_targets(6, K=K, prefix=False)
    jcrit = j_criterion.SetCriterion(K, JLossConfig(), dec_layers=3)
    jtotal, jparts = jcrit(to_jax(out), to_jax(tg))
    crit = SetCriterion(K, LossConfig(), dec_layers=3)
    total, parts = crit(to_torch(out), to_torch(tg))
    assert set(parts) == set(jparts)
    assert crit.weight_dict == jcrit.weight_dict
    for k in parts:
        assert_close(parts[k], jparts[k], 1e-5, 1e-5, err_msg=k)
    assert_close(total, jtotal, 1e-5, 1e-5)


def test_criterion_raises_for_later_slices():
    crit = SetCriterion(3, LossConfig(), dec_layers=2)
    out = to_torch(make_outputs(7))
    tg = to_torch(make_targets(8))
    with pytest.raises(NotImplementedError, match="segmentation"):
        crit({**out, "pred_masks": torch.zeros(2, 12, 4, 4)}, tg)
    with pytest.raises(NotImplementedError, match="two-stage"):
        crit({**out, "enc_outputs": out}, tg)


# -------------------------------------------------------- flax/port models
def jax_cfg(fusion, **train):
    kw = dict(DIMS, fusion_type=fusion)
    if fusion == "Baseline":
        kw["with_box_refine"] = False
    return JConfig(model=JModelConfig(**kw),
                   train=JTrainConfig(**dict(TRAIN, **train)))


def port_cfg(fusion, **train):
    kw = dict(DIMS, fusion_type=fusion)
    if fusion == "Baseline":
        kw["with_box_refine"] = False
    return Config(model=ModelConfig(**kw),
                  train=TrainConfig(**dict(TRAIN, **train)))


@functools.lru_cache(maxsize=None)
def _flax_init(fusion, seed):
    model = j_build_model(jax_cfg(fusion))[0]
    imgs, sizes = make_frames(4 if fusion == "LateFusion" else 3)
    x, mask = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    variables = random_variables(
        lambda: model.init(jax.random.PRNGKey(0), x, mask, train=False),
        seed=seed)
    return model, variables


def flax_variables(fusion, seed=11):
    """The flax model and random variables (a fresh top-level dict; the
    arrays are shared and never written)."""
    model, variables = _flax_init(fusion, seed)
    return model, dict(variables)


def port_model(fusion, variables):
    model = build_model(port_cfg(fusion), device="cpu")[0]
    return load_jax_variables(model, variables)


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("sgd", [False, True], ids=["adamw", "sgd"])
@pytest.mark.parametrize("fusion", ["LateFusion", "Baseline"])
def test_optimizer_matches_optax(fusion, sgd):
    """Three steps on the same given gradients: the port's grouped
    optimizer against the optax chain of ``build_optimizer``. The labels
    agree name by name; the gradients' global norm is 5x, 0.5x and 3x the
    clip threshold, so both sides of the clip run; two steps per epoch put
    the cosine multiplier's first change at step 3. Parameters agree to
    atol 1e-7 / rtol 1e-6 (an f32 rounding of the update)."""
    _, variables = flax_variables(fusion)
    params = variables["params"]
    jcfg = jax_cfg(fusion, sgd=sgd, lr=1e-3, clip_max_norm=1.0)
    tx, jlabels = j_build_optimizer(params, jcfg.model, jcfg.train,
                                    steps_per_epoch=2)
    model = port_model(fusion, variables)
    state = create_train_state(model, port_cfg(fusion, sgd=sgd, lr=1e-3,
                                               clip_max_norm=1.0),
                               steps_per_epoch=2)
    want_labels = {}
    for kp, lab in jax.tree_util.tree_flatten_with_path(jlabels)[0]:
        key, _ = port_key("params", tuple(k.key for k in kp),
                          np.zeros((1,) * 2))
        want_labels[key] = lab
    assert state.labels == want_labels
    frozen = {k for k, lab in want_labels.items() if lab == "frozen"}
    assert bool(frozen) == (fusion == "LateFusion")
    assert all(not p.requires_grad
               for k, p in model.named_parameters() if k in frozen)

    rng = np.random.default_rng(3)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    for scale in (5.0, 0.5, 3.0):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32),
            params)
        grads = jax.tree_util.tree_map_with_path(
            lambda kp, g: g * 0.0 if port_key(
                "params", tuple(k.key for k in kp), np.zeros((1, 1)))[0]
            in frozen else g, grads)
        norm = np.sqrt(sum(float(np.sum(np.square(g))) for g in
                           jax.tree_util.tree_leaves(grads)))
        grads = jax.tree_util.tree_map(
            lambda g: (g * (scale / norm)).astype(np.float32), grads)
        updates, opt_state = update(to_jax(grads), opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        port_grads = flat_params(grads)
        for k, p in model.named_parameters():
            p.grad = None if k in frozen else t(port_grads[k]).clone()
        grad_norm = apply_gradients(state)
        assert_close(grad_norm, scale, 1e-6, 1e-6)
    want = flat_params(params)
    for k, p in model.named_parameters():
        assert_close(p, want[k], 1e-7, 1e-6, err_msg=k)


# ----------------------------------------------------------------- DFormer
def test_dformer_train_mode_bn_matches_flax_batch_stats():
    """Train-mode BN: the output and the updated running statistics
    against flax's mutable ``batch_stats``, atol 1e-5 / rtol 1e-4. flax
    updates the running variance with the *biased* batch variance; the
    unbiased one (``F.batch_norm(training=True)``) differs here by
    n/(n-1) with n = 2*4*4 at the last BN, far outside the tolerance."""
    rng = np.random.default_rng(9)
    depth = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    mask = np.zeros((2, 64, 64), bool)
    mask[1, 40:] = True
    jmodel = JDFormerBackbone()
    variables = random_variables(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(depth), jnp.asarray(mask)),
        seed=4)
    (jfeat, _), mut = jmodel.apply(variables, jnp.asarray(depth),
                                   jnp.asarray(mask), train=True,
                                   mutable=["batch_stats"])
    model = load_jax_variables(DFormerBackbone(), variables).train()
    feat, _ = model(t(depth), t(mask))
    assert_close(feat, jfeat, 1e-5, 1e-4)
    got = model.state_dict()
    for path, v in jax.tree_util.tree_flatten_with_path(
            mut["batch_stats"])[0]:
        key, val = port_key("batch_stats", tuple(k.key for k in path),
                            np.asarray(v))
        assert_close(got[key], val, 1e-5, 1e-4, err_msg=key)
    # a bf16 forward keeps the running statistics f32
    with torch.autocast("cpu", dtype=torch.bfloat16):
        model(t(depth), t(mask))
    assert all(b.dtype == torch.float32 for b in model.buffers())


def test_dropout_is_active_only_in_train_mode_and_reproducible():
    """Dropout draws its mask from the trainer's generator: in train mode
    two forwards from the same seed agree exactly and differ from the
    forward without dropout; in eval mode dropout is the identity. A bare
    Dropout keeps each element with probability 1 - p (4-sigma band) and
    scales it by 1 / (1 - p), as flax does."""
    cfg = Config(model=ModelConfig(**dict(DIMS, fusion_type="LateFusion",
                                          dropout=0.3)))
    model = build_model(cfg, device="cpu", seed=0)[0]
    plain = build_model(Config(model=ModelConfig(
        **dict(DIMS, fusion_type="LateFusion"))), device="cpu", seed=0)[0]
    imgs, sizes = make_frames(4)
    x, mask = device_normalize(t(imgs), t(sizes))
    outs = []
    with torch.no_grad():
        # eval first: train-mode forwards move the BN running statistics
        torch.testing.assert_close(model.eval()(x, mask)["pred_logits"],
                                   plain.eval()(x, mask)["pred_logits"],
                                   atol=0, rtol=0)
        ref_train = plain.train()(x, mask)["pred_logits"]
        for _ in range(2):
            set_dropout_generator(model, torch.Generator().manual_seed(5))
            outs.append(model.train()(x, mask)["pred_logits"])
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    assert not torch.allclose(outs[0], ref_train)

    drop = Dropout(0.25).train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(torch.ones(100_000))
    kept = y != 0
    sigma = (0.75 * 0.25 / 1e5) ** 0.5
    assert abs(float(kept.float().mean()) - 0.75) < 4 * sigma
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))


def test_remat_waits_for_the_next_training_slice():
    check_supported(ModelConfig(remat=True))            # serving: fine
    with pytest.raises(NotImplementedError, match="training slice"):
        check_supported(ModelConfig(remat=True), training=True)


def test_from_flat_builds_every_part():
    cfg = Config.from_flat(fusion_type="LateFusion", dropout=0.2, lr=1e-5,
                           set_cost_giou=3.0, max_boxes=32,
                           train_dtype="bfloat16", output_dir="out")
    assert (cfg.model.dropout, cfg.train.lr, cfg.loss.set_cost_giou,
            cfg.data.max_boxes, cfg.train.train_dtype, cfg.output_dir) == (
        0.2, 1e-5, 3.0, 32, "bfloat16", "out")
    assert cfg.data.use_depth
    jfields = {f.name for f in dataclasses.fields(JTrainConfig)}
    assert jfields == {f.name for f in dataclasses.fields(TrainConfig)}


# ------------------------------------------------------------- whole step
def step_batch(seed):
    imgs, sizes = make_frames(4, seed=seed)
    return {"images": imgs, "sizes": sizes,
            **make_targets(100 + seed, n_valid=(3, 5))}


@pytest.fixture(scope="module")
def jax_run():
    """Two steps of the JAX package's ``make_train_step`` (f32, LateFusion,
    dropout 0) and ``jax.grad`` of the loss ``engine.py:126-154`` builds,
    at the same random flax variables."""
    model, variables = flax_variables("LateFusion")
    jcfg = jax_cfg("LateFusion")
    criterion = j_criterion.SetCriterion(3, jcfg.loss, dec_layers=2)
    params = variables.pop("params")
    tx, labels = j_build_optimizer(params, jcfg.model, jcfg.train,
                                   steps_per_epoch=1)
    batches = [step_batch(0), step_batch(1)]

    def loss_fn(p, model_state, batch):
        p = jax.tree_util.tree_map(
            lambda x, lab: jax.lax.stop_gradient(x) if lab == "frozen"
            else x, p, labels)
        images, mask = j_normalize(batch["images"], batch["sizes"])
        out, _ = model.apply({"params": p, **model_state}, images, mask,
                             train=True, rngs={"dropout":
                                               jax.random.PRNGKey(0)},
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
        state, m = step(state, to_jax(batch), jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
        states.append(state)
    init = {"params": params, **variables}
    return init, batches, grads, metrics, states


@pytest.fixture(scope="module")
def port_run(jax_run):
    init, batches, _, _, _ = jax_run
    cfg = port_cfg("LateFusion")
    model = load_jax_variables(build_model(cfg, device="cpu")[0],
                               copy.deepcopy(init))
    criterion = build_model(cfg, device="cpu")[1]
    # gradients before the clip, from a copy at the initial weights
    gstate = create_train_state(copy.deepcopy(model), cfg, steps_per_epoch=1)
    loss, _ = criterion(*forward(gstate, batches[0]))
    loss.backward()
    grads = {k: p.grad for k, p in gstate.model.named_parameters()}
    state = create_train_state(model, cfg, steps_per_epoch=1)
    metrics, params = [], []
    for batch in batches:
        metrics.append({k: float(v) for k, v in
                        train_step(state, criterion, batch).items()})
        params.append({k: p.detach().clone()
                       for k, p in model.named_parameters()})
    return grads, metrics, params, state


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_steps"])
def test_train_step_metrics_match_make_train_step(jax_run, port_run, step):
    """Loss, every component and grad_norm after one and two steps, atol
    1e-4 / rtol 1e-3 (the JAX package's full-model parity tolerance)."""
    jm = jax_run[3][step]
    pm = port_run[1][step]
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], atol=1e-4, rtol=1e-3,
                                   err_msg=f"step {step} {k}")


def test_train_step_gradients_match_jax_grad(jax_run, port_run):
    """Every trainable gradient against ``jax.grad`` of the engine's loss,
    atol 1e-5 + rtol 1e-3 relative to the tensor's largest entry (sums in
    another order through ResNet-free backward paths); frozen parameters
    have no gradient in the port and an exact zero one in JAX."""
    jgrads = flat_params(jax_run[2])
    grads = port_run[0]
    for k, g in grads.items():
        if g is None:
            assert k.startswith("backbone.")
            np.testing.assert_array_equal(jgrads[k], 0.0)
            continue
        scale = float(np.abs(jgrads[k]).max())
        assert_close(g, jgrads[k], 1e-5 + 1e-3 * scale, 1e-3, err_msg=k)


@pytest.mark.parametrize("step", [0, 1], ids=["one_step", "two_steps"])
def test_train_step_parameters_match(jax_run, port_run, step):
    """Parameters after each step, atol 1e-7 / rtol 1e-6, wherever the
    step-one gradient is not tiny: Adam's first update is g / (|g| + 1e-8)
    times lr, about lr * sign(g), so an entry whose clipped gradient is
    near Adam's epsilon or is rounding noise can move by up to lr either
    way. The mask keeps the entries whose clipped JAX gradient exceeds 1e-6
    (100x epsilon); it drops the structurally zero gradients (conv biases
    before a train-mode BN, key biases under a softmax, all below 5e-7
    here). The frozen ResNet-50
    is unchanged bitwise, and the DFormer BN running statistics match
    flax's after both steps."""
    jparams = flat_params(jax_run[4][step + 1].params)
    jgrads = flat_params(jax_run[2])
    clip = min(1.0, TRAIN["clip_max_norm"] / jax_run[3][0]["grad_norm"])
    params = port_run[2][step]
    init = flat_params(jax_run[0]["params"])
    kept = 0
    for k, p in params.items():
        if k.startswith("backbone."):
            np.testing.assert_array_equal(p.numpy(), init[k])
            continue
        g = jgrads[k]
        keep = np.abs(g) * clip > 1e-6
        kept += int(keep.sum())
        np.testing.assert_allclose(p.numpy()[keep], jparams[k][keep],
                                   atol=1e-7, rtol=1e-6, err_msg=k)
    assert kept > 0.5 * sum(p.numel() for k, p in params.items()
                            if not k.startswith("backbone."))
    state = port_run[3].model.state_dict()
    stats = jax_run[4][2].model_state["batch_stats"]
    for path, v in jax.tree_util.tree_flatten_with_path(stats)[0]:
        key, val = port_key("batch_stats", tuple(k.key for k in path),
                            np.asarray(v))
        assert_close(state[key], val, 1e-5, 1e-4, err_msg=key)
