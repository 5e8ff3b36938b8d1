"""The port's segmentation branch (``dfvod_tpu_torch/models/segmentation.py``)
against the JAX package's (``dfvod_tpu/models/segmentation.py``): the
resizes at odd sizes, ``MaskBranch`` forward and gradients, ``dice_loss``,
the mask losses of the criterion, a LateFusion model with ``masks=True``
(forward, and a train step against ``make_train_step`` and ``jax.grad``),
``postprocess_segm`` and ``postprocess_panoptic``.

Small sizes (hidden 32, 4 heads, 1+1 layers, 12 queries, 64x96 uint8
frames with real padding), random flax variables made with numpy from a
seed (``torch_port_helpers.random_variables``) carried into the port by
``utils/convert.py``, f32, dropout 0. Tolerance: atol 1e-4 / rtol 1e-3
(the JAX package's full-model parity tolerance) unless a test says
otherwise.
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
from dfvod_tpu.models import segmentation as jseg
from dfvod_tpu.train.engine import TrainState as JTrainState
from dfvod_tpu.train.engine import make_train_step
from dfvod_tpu.train.optim import build_optimizer as j_build_optimizer
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import LossConfig as JLossConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu.utils.config import TrainConfig as JTrainConfig
from dfvod_tpu_torch.data.device_pipeline import normalize_frames
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models import segmentation as seg
from dfvod_tpu_torch.models.criterion import SetCriterion
from dfvod_tpu_torch.train.engine import (
    create_train_state,
    forward,
    train_step,
)
from dfvod_tpu_torch.utils.config import (
    Config,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import (
    assert_close,
    flat_params,
    make_frames,
    random_variables,
)

TOL = dict(atol=1e-4, rtol=1e-3)
# gradients that are zero but for rounding: at hidden 32 the mask head's
# last GroupNorm has one channel per group, which cancels the bias of the
# conv and of the adapter before it
STRUCTURALLY_ZERO = ("mask_head.lay5_conv.bias", "mask_head.adapter3.bias")
KEY = jax.random.PRNGKey(0)
DIMS = dict(num_classes=3, num_queries=12, hidden_dim=32, nheads=4,
            enc_layers=1, dec_layers=2, dim_feedforward=64, dropout=0.0,
            num_feature_levels=1, fusion_type="LateFusion", masks=True)
TRAIN = dict(lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1, epochs=3)
H, W, T = 64, 96, 5


def t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ resize
@pytest.mark.parametrize("size_in,size_out", [
    ((5, 7), (10, 13)), ((10, 13), (19, 25)), ((75, 100), (38, 50)),
    ((16, 24), (64, 96)), ((19, 25), (7, 9))],
    ids=["up_odd", "up_odd2", "down_odd", "up_4x", "down_antialias"])
def test_resizes_equal_jax_image_resize(size_in, size_out):
    """``resize_nearest`` is ``jax.image.resize(..., "nearest")`` bitwise
    (half-pixel centres, not torch's legacy ``nearest``), and
    ``resize_bilinear`` its ``"bilinear"`` within 1e-5 (the two axes
    contracted in another order), antialiased when downsampling."""
    x = np.random.default_rng(0).standard_normal(
        (2, 3, *size_in)).astype(np.float32)
    want = jax.image.resize(x, (2, 3, *size_out), "nearest")
    assert torch.equal(seg.resize_nearest(t(x), size_out), t(want))
    want = jax.image.resize(x, (2, 3, *size_out), "bilinear")
    assert_close(seg.resize_bilinear(t(x), size_out), want, 1e-5, 1e-5)


# ------------------------------------------------------------ mask branch
B, Q, C, M = 2, 6, 32, 4
# the level-0 map and the ResNet laterals 3, 2, 1 at odd sizes (a
# 600-row frame's 75 -> 38 at layer4 is the full-width case)
MAP, LATS = (5, 7), ((5, 7), (10, 13), (19, 25))


def branch_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    queries = rng.standard_normal((B, Q, C)).astype(f)
    memory = rng.standard_normal((B, *MAP, C)).astype(f)
    mask = np.zeros((B, *MAP), bool)
    mask[1, 3:] = True
    mask[1, :, 5:] = True
    lats = [rng.standard_normal((B, *s, ch)).astype(f)
            for s, ch in zip(LATS, seg.LATERAL_CHANNELS)]
    return queries, memory, mask, lats


@pytest.fixture(scope="module")
def branch():
    """Flax ``MaskBranch``'s output and the gradients of a weighted sum
    (inputs and parameters), and the port's from the same variables."""
    queries, memory, mask, lats = branch_inputs()
    jm = jseg.MaskBranch(hidden_dim=C, num_heads=M)
    variables = random_variables(
        lambda: jm.init(KEY, queries, memory, mask, lats), seed=3)
    w = np.random.default_rng(1).standard_normal(
        (B, Q, *LATS[-1])).astype(np.float32)

    def loss(v, q, m, la):
        out = jm.apply(v, q, m, mask, la)
        return (out * w).sum(), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(
        variables, queries, memory, lats)
    pm = seg.MaskBranch(hidden_dim=C, num_heads=M)
    load_jax_variables(pm, copy.deepcopy(variables))
    ins = [t(x).requires_grad_() for x in (queries, memory)]
    lat_t = [t(x).requires_grad_() for x in lats]
    pout = pm(ins[0], ins[1], t(mask), lat_t)
    (pout * t(w)).sum().backward()
    return {"jax": (jout, jgrads), "port": (pout, pm, ins, lat_t)}


def test_mask_branch_equals_flax(branch):
    """(B, Q, H/4, W/4) mask logits from the query / memory / lateral
    inputs at odd sizes, within atol 1e-4 / rtol 1e-3."""
    jout, _ = branch["jax"]
    pout = branch["port"][0]
    assert pout.shape == (B, Q, *LATS[-1])
    assert_close(pout, jout, **TOL)


def test_mask_branch_gradients_equal_flax(branch):
    """The gradients of a weighted sum of the logits: every parameter,
    the queries, the memory map and each lateral, within atol 1e-5 + 1e-3
    of the tensor's largest entry, rtol 1e-3 (``test_torch_train.py``'s
    gradient gate; ``k_linear``'s bias has a structurally zero gradient,
    the softmax over the keys cancelling it, here rounding noise of
    1e-8), except the structurally zero ones, where both are below
    1e-4."""
    _, (gv, gq, gm, gl) = branch["jax"]
    _, pm, ins, lat_t = branch["port"]
    want = flat_params(gv["params"])
    params = dict(pm.named_parameters())
    assert set(want) == set(params)
    for k, g in want.items():
        scale = float(np.abs(g).max())
        if k in STRUCTURALLY_ZERO:
            assert scale < 1e-4 and float(params[k].grad.abs().max()) \
                < 1e-4, k
            continue
        assert_close(params[k].grad, g, 1e-5 + 1e-3 * scale, 1e-3,
                     err_msg=k)
    for got, g in zip([*ins, *lat_t], [gq, gm, *gl]):
        scale = float(np.abs(g).max())
        assert_close(got.grad, g, 1e-5 + 1e-3 * scale, 1e-3)


def test_dice_loss_equals_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 50)).astype(np.float32) * 3
    y = (rng.random((6, 50)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(float(seg.dice_loss(t(x), t(y), 4.0)),
                               float(jseg.dice_loss(x, y, 4.0)), rtol=1e-6)


# ------------------------------------------------------------- criterion
def criterion_inputs(seed=4, Hp=16, Wp=24):
    rng = np.random.default_rng(seed)
    f = np.float32
    out = {"pred_logits": rng.standard_normal((2, 12, 3)).astype(f),
           "pred_boxes": rng.uniform(0.1, 0.9, (2, 12, 4)).astype(f),
           "pred_masks": (3 * rng.standard_normal((2, 12, Hp, Wp))
                          ).astype(f)}
    masks = np.zeros((2, T, H, W), np.uint8)
    for b in range(2):
        for j in range(T):
            y0, x0 = rng.integers(0, H - 20), rng.integers(0, W - 30)
            masks[b, j, y0:y0 + rng.integers(4, 20),
                  x0:x0 + rng.integers(4, 30)] = 1
    targets = {"labels": rng.integers(0, 2, (2, T)).astype(np.int32),
               "boxes": np.concatenate([rng.uniform(0.2, 0.8, (2, T, 2)),
                                        rng.uniform(0.05, 0.3, (2, T, 2))],
                                       -1).astype(f),
               "valid": np.arange(T)[None] < np.array([[2], [4]]),
               "masks": masks}
    return out, targets


def test_mask_losses_equal_jax_criterion():
    """``loss_mask`` / ``loss_dice`` (the last layer's matches, the
    predictions resized bilinearly 4x to the target masks) and the total
    against JAX's ``SetCriterion``, with the gradient of the total with
    respect to the mask logits; without ``masks`` in the targets there
    is no mask loss, as in JAX."""
    out, targets = criterion_inputs()
    jc = j_criterion.SetCriterion(3, JLossConfig(), dec_layers=1)

    def jloss(pm):
        return jc({**out, "pred_masks": pm}, targets)

    (jtotal, jparts), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        out["pred_masks"])
    pc = SetCriterion(3, LossConfig(), dec_layers=1)
    pm = t(out["pred_masks"]).requires_grad_()
    ptotal, pparts = pc({**{k: t(v) for k, v in out.items()},
                         "pred_masks": pm},
                        {k: t(v) for k, v in targets.items()})
    ptotal.backward()
    assert {"loss_mask", "loss_dice"} <= set(pparts)
    for k in jparts:
        np.testing.assert_allclose(float(pparts[k].detach()),
                                   float(jparts[k]),
                                   atol=1e-5, rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(ptotal.detach()), float(jtotal),
                               atol=1e-5, rtol=1e-4)
    scale = float(np.abs(jgrad).max())
    assert scale > 0
    assert_close(pm.grad, jgrad, 1e-4 * scale, 1e-3)
    no_masks = {k: t(v) for k, v in targets.items() if k != "masks"}
    _, parts = pc({k: t(v) for k, v in out.items()}, no_masks)
    assert "loss_mask" not in parts


# ------------------------------------------------------------- the model
def batch_of(seed):
    imgs, sizes = make_frames(4, seed=seed, H=H, W=W)
    _, targets = criterion_inputs(seed + 10)
    for b, (h, w) in enumerate(sizes):
        targets["masks"][b, :, h:] = 0
        targets["masks"][b, :, :, w:] = 0
    return {"images": imgs, "sizes": sizes, **targets}


@pytest.fixture(scope="module")
def jax_masked():
    """The flax LateFusion model with ``masks=True``: random variables,
    its eval forward, ``jax.grad`` of the engine's loss and one
    ``make_train_step`` on a batch with masks."""
    jcfg = JConfig(model=JModelConfig(**DIMS), train=JTrainConfig(**TRAIN))
    model, criterion, _ = j_build_model(jcfg)
    batch = batch_of(0)
    x, mask = j_normalize(jnp.asarray(batch["images"]),
                          jnp.asarray(batch["sizes"]))
    variables = dict(random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=5))
    fwd = jax.jit(lambda v, i, m: model.apply(v, i, m, train=False))(
        variables, x, mask)
    params = variables.pop("params")
    tx, labels = j_build_optimizer(params, jcfg.model, jcfg.train,
                                   steps_per_epoch=1)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p):
        p = jax.tree_util.tree_map(
            lambda v, lab: jax.lax.stop_gradient(v) if lab == "frozen"
            else v, p, labels)
        out, _ = model.apply({"params": p, **variables}, x, mask,
                             train=True, rngs={"dropout": KEY},
                             mutable=["batch_stats"])
        return criterion(out, {k: jb[k] for k in ("labels", "boxes",
                                                  "valid", "masks")})

    grads, _ = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        model_state=variables, opt_state=tx.init(params))
    step = make_train_step(model, criterion, tx, donate=False, labels=labels)
    new_state, metrics = step(state, jb, KEY)
    return {"variables": {"params": params, **variables}, "batch": batch,
            "forward": fwd, "grads": flat_params(grads),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": flat_params(new_state.params)}


def port_model(jax_masked):
    cfg = Config(model=ModelConfig(**DIMS), train=TrainConfig(**TRAIN))
    model, criterion, _ = build_model(cfg, device="cpu")
    load_jax_variables(model, copy.deepcopy(jax_masked["variables"]))
    return cfg, model, criterion


def test_masked_forward_equals_flax(jax_masked):
    """``pred_masks`` (B, Q, H/4, W/4), ``pred_logits`` and
    ``pred_boxes`` of the eval forward against flax's."""
    cfg, model, _ = port_model(jax_masked)
    batch = jax_masked["batch"]
    with torch.no_grad():
        x, mask = normalize_frames(t(batch["images"]), t(batch["sizes"]))
        out = model(x, mask)
    ref = jax_masked["forward"]
    assert out["pred_masks"].shape == (2, 12, H // 4, W // 4)
    for k in ("pred_logits", "pred_boxes", "pred_masks"):
        assert_close(out[k], np.asarray(ref[k]), **TOL, err_msg=k)


def test_masks_train_step_equals_make_train_step(jax_masked):
    """One f32 step on a batch with masks: loss, every component
    (``loss_mask`` and ``loss_dice`` included) and grad_norm against
    ``make_train_step`` within atol 1e-4 / rtol 1e-3; every trainable
    gradient before the clip against ``jax.grad`` of the engine's loss
    within atol 1e-5 + 1e-3 of the tensor's largest entry, rtol 1e-3
    (``test_torch_train.py``'s gate; the mask branch's too), except the
    structurally zero ones, where both are below 1e-4; the parameters
    wherever Adam's step is decided (the clipped gradient above 1e-6)
    within atol 1e-7 / rtol 1e-6 of JAX's."""
    cfg, model, criterion = port_model(jax_masked)
    batch = jax_masked["batch"]
    gstate = create_train_state(copy.deepcopy(model), cfg,
                                steps_per_epoch=1)
    loss, _ = criterion(*forward(gstate, batch))
    loss.backward()
    jgrads = jax_masked["grads"]
    branch = 0
    for k, p in gstate.model.named_parameters():
        if p.grad is None:
            assert not p.requires_grad, k
            continue
        g = jgrads[k]
        scale = float(np.abs(g).max())
        if k[len("mask_branch."):] in STRUCTURALLY_ZERO:
            assert scale < 1e-4 and float(p.grad.abs().max()) < 1e-4, k
            continue
        assert_close(p.grad, g, 1e-5 + 1e-3 * scale, 1e-3, err_msg=k)
        branch += k.startswith("mask_branch.") and scale > 0
    assert branch >= 20, branch
    state = create_train_state(model, cfg, steps_per_epoch=1)
    metrics = {k: float(v) for k, v in
               train_step(state, criterion, batch).items()}
    jm = jax_masked["metrics"]
    assert {"loss_mask", "loss_dice"} <= set(jm)
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(metrics[k], jm[k], **TOL, err_msg=k)
    params = dict(model.named_parameters())
    clip = min(1.0, TRAIN["clip_max_norm"] / jm["grad_norm"])
    for k, want in jax_masked["params"].items():
        decided = np.abs(jgrads[k]) * clip > 1e-6
        got = params[k].detach().numpy()
        np.testing.assert_allclose(got[decided], want[decided], atol=1e-7,
                                   rtol=1e-6, err_msg=k)


# ------------------------------------------------------------ postprocess
def test_postprocess_segm_equals_jax():
    """The mask logits resized bilinearly to the first target size (odd,
    4x and more) and thresholded at 0.5: the probabilities within 1e-5,
    the masks equal wherever the probability is not within 1e-5 of the
    threshold."""
    logits = (2 * np.random.default_rng(6).standard_normal(
        (2, 5, 13, 19))).astype(np.float32)
    sizes = np.array([[51, 77], [40, 60]])
    want = np.asarray(jseg.postprocess_segm(logits, sizes))
    got = seg.postprocess_segm(t(logits), t(sizes))
    prob = torch.sigmoid(seg.resize_bilinear(t(logits), (51, 77)))
    jprob = jax.nn.sigmoid(jax.image.resize(logits, (2, 5, 51, 77),
                                            "bilinear"))
    assert_close(prob, jprob, 1e-5, 1e-5)
    sure = np.abs(np.asarray(jprob) - 0.5) > 1e-5
    assert got.dtype == torch.bool and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy()[sure], want[sure])


def panoptic_case():
    """``tests/test_tools.py``'s case: a thing, two masks of one stuff
    class to merge, a no-object query."""
    logits = np.full((1, 4, 3), -8.0, np.float32)
    logits[0, 0, 0] = logits[0, 1, 1] = logits[0, 2, 1] = 8.0
    logits[0, 3, 2] = 8.0
    masks = np.full((1, 4, 8, 8), -10.0, np.float32)
    masks[0, 0, :4] = 10.0
    masks[0, 1, 4:, :4] = 10.0
    masks[0, 2, 4:, 4:] = 10.0
    return logits, masks, {0: True, 1: False}, 0.5


def random_panoptic_case():
    """Three images of 10 queries over 4 classes (class 3 no object),
    things and stuff, segments of every size (a tiny one dropped)."""
    rng = np.random.default_rng(7)
    logits = (4 * rng.standard_normal((3, 10, 4))).astype(np.float32)
    masks = (4 * rng.standard_normal((3, 10, 12, 16))).astype(np.float32)
    masks[0, 0] = -20.0
    masks[0, 0, :2, :2] = 20.0
    return logits, masks, {0: True, 1: False, 2: False}, 0.6


@pytest.mark.parametrize("case", [panoptic_case, random_panoptic_case],
                         ids=["merges_stuff", "random"])
def test_postprocess_panoptic_equals_jax(case):
    """The segment map and the segments' infos equal JAX's exactly."""
    logits, masks, things, threshold = case()
    want = jseg.postprocess_panoptic(logits, masks, things, threshold)
    got = seg.postprocess_panoptic(t(logits), t(masks), things, threshold)
    assert len(got) == len(want)
    assert any(infos for _, infos in want)
    for (gm, gi), (wm, wi) in zip(got, want):
        np.testing.assert_array_equal(gm, wm)
        assert gi == wi
