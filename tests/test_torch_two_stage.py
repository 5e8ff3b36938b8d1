"""Two-stage proposals (``ModelConfig.two_stage``) against the JAX package:
the proposal generation and its sine embedding, Baseline and LateFusion
forwards with and without box refinement at 1 and 3 feature levels
(``enc_outputs`` included), the criterion's ``_enc`` losses, one
``train_step`` against ``make_train_step`` and ``jax.grad``, TransVOD++ on
a two-stage trunk, the weight bridge's coverage, and the reference's own
two-stage composition (``tests/torch_ref.py``) through the reference
converter.

Small dims (hidden 64, 4 heads, 2+2 layers, 12 queries) on 96x128 uint8
frames with real padding, made with numpy from a seed; random flax
variables in every leaf (``torch_port_helpers.random_variables``) carried
into the port by ``utils/convert.py``. Tolerance: atol 1e-4 / rtol 1e-3,
the JAX package's full-model parity tolerance, unless stated.

Ties. Every padded token, and every token whose proposal leaves the
(0.01, 0.99) band, gets the same class logit (the head of
``LN(Dense(0))``) and the same ``+inf`` proposal, so ``torch.topk`` and
``jax.lax.top_k`` may order them differently. Their queries are then
identical inputs and give identical outputs, so the comparison query by
query holds whatever the order. Two *valid* tokens whose logits differ by
rounding alone could swap; ``assert_no_valid_ties`` checks, before a
comparison, that no two distinct logits up to the top-k boundary lie
within 1e-4 of each other, so every comparison here is one where no valid
token ties.
"""
import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.models import criterion as j_criterion
from dfvod_tpu.models.position_encoding import (
    proposal_pos_embed as j_proposal_pos_embed,
)
from dfvod_tpu.models.transformer import (
    DeformableTransformer as JDeformableTransformer,
)
from dfvod_tpu.train.engine import TrainState as JTrainState
from dfvod_tpu.train.engine import make_train_step
from dfvod_tpu.train.optim import build_optimizer as j_build_optimizer
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import LossConfig as JLossConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu.utils.config import TrainConfig as JTrainConfig
from dfvod_tpu.utils.convert_reference import (
    convert_reference_state_dict as j_convert,
)
from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models.criterion import SetCriterion
from dfvod_tpu_torch.models.position_encoding import proposal_pos_embed
from dfvod_tpu_torch.models.transformer import gen_encoder_output_proposals
from dfvod_tpu_torch.train.engine import create_train_state, forward, train_step
from dfvod_tpu_torch.utils import convert_reference
from dfvod_tpu_torch.utils.config import (
    Config,
    LossConfig,
    ModelConfig,
    TrainConfig,
)
from dfvod_tpu_torch.utils.convert import load_jax_variables, port_key
from test_full_model_parity import DEPTH_TYPE
from test_full_model_parity import DIMS as REF_DIMS
from test_full_model_parity import make_inputs
from torch_port_helpers import (
    assert_close,
    flat_params,
    make_frames,
    random_variables,
)
from torch_ref import TorchDeformableDETR

KEY = jax.random.PRNGKey(0)
TOL = dict(atol=1e-4, rtol=1e-3)
DIMS = dict(num_classes=3, num_queries=12, hidden_dim=64, nheads=4,
            enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0,
            two_stage=True)
TRAIN = dict(lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1, epochs=3)
# (fusion, box refinement, feature levels)
CASES = [("Baseline", True, 1), ("Baseline", False, 3),
         ("LateFusion", True, 3), ("LateFusion", False, 1)]


def model_kw(fusion, refine, levels):
    return dict(DIMS, fusion_type=fusion, with_box_refine=refine,
                num_feature_levels=levels)


def assert_no_valid_ties(enc_logits, k, gap=1e-4):
    """No two distinct class-0 encoder logits among each image's k + 1
    largest lie within ``gap`` (equal ones are the padded and out-of-band
    tokens' shared logit)."""
    top = -np.sort(-np.asarray(enc_logits, np.float64)[..., 0], axis=1)
    top = top[:, :k + 1]
    d = top[:, :-1] - top[:, 1:]
    assert not ((d > 0) & (d < gap)).any(), "valid tokens tie near top-k"


# ------------------------------------------------------------- proposals
class JProposals(JDeformableTransformer):
    """The JAX trunk's ``_gen_encoder_output_proposals`` as a module of
    its own (the method defines its Dense and LayerNorm inline)."""

    @fnn.compact
    def __call__(self, memory, mask_flat, spatial_shapes):
        return self._gen_encoder_output_proposals(memory, mask_flat,
                                                  spatial_shapes)


class Proposals(nn.Module):
    """The port's proposals with the trunk's ``enc_output`` and
    ``enc_output_norm`` after them."""

    def __init__(self, d):
        super().__init__()
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, memory, mask_flat, spatial_shapes):
        out, proposals = gen_encoder_output_proposals(memory, mask_flat,
                                                      spatial_shapes)
        return self.enc_output_norm(self.enc_output(out)), proposals


def test_proposals_and_pos_embed_equal_jax():
    """Two levels (8x10, 2x64) on a padded batch, image 1 keeping 5x7 and
    1x40 tokens: padded tokens, and on image 0's 64-wide level the first
    and last columns, whose centres (0.5 / 64, 63.5 / 64) leave the
    (0.01, 0.99) band. Proposals within 1e-6 where finite (XLA's and
    PyTorch's ``log`` differ in the last bit) and ``+inf`` at the same
    tokens, the memory after ``enc_output`` and its LayerNorm within
    the tolerance, and ``proposal_pos_embed`` of the proposals within 1e-6
    (``sigmoid(inf)`` is 1 in both)."""
    shapes = ((8, 10), (2, 64))
    d, B = 32, 2
    masks = []
    for H, W, vh, vw in ((8, 10, 5, 7), (2, 64, 1, 40)):
        m = np.zeros((B, H, W), bool)
        m[1, vh:] = True
        m[1, :, vw:] = True
        masks.append(m.reshape(B, -1))
    mask = np.concatenate(masks, 1)
    rng = np.random.default_rng(0)
    memory = rng.standard_normal((B, mask.shape[1], d)).astype(np.float32)
    jmod = JProposals(d_model=d)
    variables = random_variables(
        lambda: jmod.init(KEY, memory, mask, shapes), seed=1)
    j_mem, j_prop = jmod.apply(variables, memory, mask, shapes)
    port = load_jax_variables(Proposals(d), variables)
    with torch.no_grad():
        mem, prop = port(torch.from_numpy(memory), torch.from_numpy(mask),
                         shapes)
    j_prop = np.asarray(j_prop)
    inf = np.isinf(j_prop)
    np.testing.assert_array_equal(np.isinf(prop.numpy()), inf)
    assert inf.any() and not inf.all()
    # the band alone: image 0 has no padded token
    assert inf[0].all(-1).sum() == 4
    assert (np.isposinf(j_prop) == inf).all()
    assert_close(prop.numpy()[~inf], j_prop[~inf], 1e-6, 0)
    assert_close(mem, j_mem, **TOL)
    emb = proposal_pos_embed(prop, d // 2)
    assert emb.shape == (B, mask.shape[1], 2 * d)
    assert bool(torch.isfinite(emb).all())
    assert_close(emb, j_proposal_pos_embed(j_prop, d // 2), 1e-6, 0)


# -------------------------------------------------------------- forwards
def flax_forward(kw, imgs, sizes, seed=11):
    model = j_build_model(JConfig(model=JModelConfig(**kw)))[0]
    x, mask = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    variables = random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=seed)
    out = jax.jit(lambda v, i, m: model.apply(v, i, m, train=False))(
        variables, x, mask)
    return variables, out


def assert_outputs_close(got, ref):
    for k in ("pred_logits", "pred_boxes"):
        assert_close(got[k], ref[k], **TOL, err_msg=k)
        assert_close(got["enc_outputs"][k], ref["enc_outputs"][k], **TOL,
                     err_msg=f"enc {k}")
    assert len(got["aux_outputs"]) == len(ref["aux_outputs"])
    for g, r in zip(got["aux_outputs"], ref["aux_outputs"]):
        for k in ("pred_logits", "pred_boxes"):
            assert_close(g[k], r[k], **TOL, err_msg=f"aux {k}")


@pytest.mark.parametrize("fusion,refine,levels", CASES,
                         ids=[f"{f}-{'refine' if r else 'shared'}-L{n}"
                              for f, r, n in CASES])
def test_two_stage_forward_equals_flax(fusion, refine, levels):
    kw = model_kw(fusion, refine, levels)
    imgs, sizes = make_frames(3 if fusion == "Baseline" else 4)
    variables, ref = flax_forward(kw, imgs, sizes)
    assert_no_valid_ties(ref["enc_outputs"]["pred_logits"],
                         kw["num_queries"])
    model = load_jax_variables(
        build_model(Config(model=ModelConfig(**kw)), device="cpu")[0],
        variables)
    with torch.no_grad():
        out = model(*device_normalize(torch.from_numpy(imgs),
                                      torch.from_numpy(sizes)))
    S = sum(h * w for h, w in out["_trunk"]["spatial_shapes"])
    assert out["enc_outputs"]["pred_logits"].shape == (2, S, 3)
    # the padded image's padded tokens propose (1, 1, 1, 1)
    pad = out["_trunk"]["mask_flat"][1]
    assert bool((out["enc_outputs"]["pred_boxes"][1][pad] == 1).all())
    assert_outputs_close(out, ref)


@pytest.mark.parametrize("refine", [True, False],
                         ids=["refine", "shared"])
def test_weight_bridge_covers_two_stage_both_ways(refine):
    """The port's state-dict keys are exactly the flax leaves' under the
    bridge's names: ``enc_output*``, ``pos_trans*`` and the encoder's head
    (``head_{dec_layers}``, or the shared head) in, ``query_embed`` and
    ``reference_points`` out."""
    kw = model_kw("LateFusion", refine, 1)
    jmodel = j_build_model(JConfig(model=JModelConfig(**kw)))[0]
    imgs, sizes = make_frames(4)
    x, mask = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    shapes = jax.eval_shape(lambda: jmodel.init(KEY, x, mask, train=False))
    flax_keys = {
        port_key(kp[0].key, tuple(k.key for k in kp[1:]),
                 np.zeros(v.shape))[0]
        for kp, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    port = build_model(Config(model=ModelConfig(**kw)), device="cpu")[0]
    keys = set(port.state_dict())
    assert keys == flax_keys
    for k in ("enc_output.weight", "enc_output_norm.weight",
              "pos_trans.bias", "pos_trans_norm.bias"):
        assert f"transformer.{k}" in keys
    head = "head_2" if refine else "head_shared"
    assert f"transformer.{head}.class_embed.weight" in keys
    assert not any("query_embed" in k or "reference_points" in k
                   for k in keys)


# -------------------------------------------------------------- criterion
def make_outputs(seed, B=2, Q=12, S=40, K=3):
    rng = np.random.default_rng(seed)

    def one(n):
        cxcy = rng.uniform(0.1, 0.9, (B, n, 2))
        wh = rng.uniform(0.02, 0.5, (B, n, 2))
        return {"pred_logits": rng.standard_normal((B, n, K)).astype(
                    np.float32),
                "pred_boxes": np.concatenate([cxcy, wh], -1).astype(
                    np.float32)}
    out = one(Q)
    out["aux_outputs"] = [one(Q)]
    enc = one(S)
    # padded proposals: sigmoid(inf) = 1
    enc["pred_boxes"][1, S // 2:] = 1.0
    out["enc_outputs"] = enc
    return out


def test_enc_losses_match_jax_set_criterion():
    """The ``_enc`` losses (binary targets: every label 0, the proposals
    matched in the same host call as the decoder layers), every other
    component and the weighted total against the JAX ``SetCriterion``,
    atol / rtol 1e-5 (``tests/test_torch_train.py``'s criterion gate)."""
    out = make_outputs(3)
    rng = np.random.default_rng(4)
    T = 6
    valid = np.arange(T)[None] < np.array([[2], [5]])
    tg = {"labels": rng.integers(0, 2, (2, T)).astype(np.int32),
          "boxes": np.concatenate([rng.uniform(0.2, 0.8, (2, T, 2)),
                                   rng.uniform(0.05, 0.35, (2, T, 2))],
                                  -1).astype(np.float32),
          "valid": valid}
    jcrit = j_criterion.SetCriterion(3, JLossConfig(), dec_layers=2)
    jtotal, jparts = jcrit(jax.tree_util.tree_map(jnp.asarray, out),
                           jax.tree_util.tree_map(jnp.asarray, tg))
    crit = SetCriterion(3, LossConfig(), dec_layers=2)
    total, parts = crit(jax.tree_util.tree_map(torch.from_numpy, out),
                        jax.tree_util.tree_map(torch.from_numpy, tg))
    assert set(parts) == set(jparts)
    assert {"loss_ce_enc", "loss_bbox_enc", "loss_giou_enc"} <= set(parts)
    for k in parts:
        assert_close(parts[k], jparts[k], 1e-5, 1e-5, err_msg=k)
    assert_close(total, jtotal, 1e-5, 1e-5)


# ------------------------------------------------------------- train step
def step_batch(seed):
    imgs, sizes = make_frames(4, seed=seed)
    rng = np.random.default_rng(100 + seed)
    T = 8
    valid = np.arange(T)[None] < np.array([[3], [5]])
    return {"images": imgs, "sizes": sizes,
            "labels": rng.integers(0, 2, (2, T)).astype(np.int32),
            "boxes": np.concatenate([rng.uniform(0.2, 0.8, (2, T, 2)),
                                     rng.uniform(0.05, 0.35, (2, T, 2))],
                                    -1).astype(np.float32),
            "valid": valid}


@pytest.fixture(scope="module")
def jax_run():
    """One ``make_train_step`` of two-stage LateFusion with box refinement
    (f32, dropout 0) and ``jax.grad`` of the loss it builds, at the same
    random flax variables; the encoder's logits for the tie check."""
    kw = model_kw("LateFusion", True, 1)
    jcfg = JConfig(model=JModelConfig(**kw), train=JTrainConfig(**TRAIN))
    model = j_build_model(jcfg)[0]
    batch = step_batch(0)
    x, mask = j_normalize(jnp.asarray(batch["images"]),
                          jnp.asarray(batch["sizes"]))
    variables = dict(random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=11))
    init = copy.deepcopy(variables)
    params = variables.pop("params")
    tx, labels = j_build_optimizer(params, jcfg.model, jcfg.train,
                                   steps_per_epoch=1)
    criterion = j_criterion.SetCriterion(3, jcfg.loss, dec_layers=2)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    def loss_fn(p, model_state):
        p = jax.tree_util.tree_map(
            lambda v, lab: jax.lax.stop_gradient(v) if lab == "frozen"
            else v, p, labels)
        out, _ = model.apply({"params": p, **model_state}, x, mask,
                             train=True, rngs={"dropout": KEY},
                             mutable=["batch_stats"])
        targets = {k: jb[k] for k in ("labels", "boxes", "valid")}
        return criterion(out, targets)[0], out["enc_outputs"]

    grads, enc = jax.jit(jax.grad(loss_fn, has_aux=True))(params, variables)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        model_state=variables, opt_state=tx.init(params))
    step = make_train_step(model, criterion, tx, donate=False, labels=labels)
    _, m = step(state, jb, KEY)
    return (kw, init, batch, grads, enc["pred_logits"],
            {k: float(v) for k, v in m.items()})


def test_two_stage_train_step_matches_make_train_step(jax_run):
    """Loss, every component (the ``_enc`` ones included) and grad_norm
    within the tolerance; every trainable gradient against ``jax.grad``
    within atol 1e-5 + 1e-3 of the tensor's largest entry and rtol 1e-3
    (``tests/test_torch_train.py``'s gradient gate); the frozen ResNet-50
    gets none."""
    kw, init, batch, jgrads, enc_logits, jm = jax_run
    assert_no_valid_ties(enc_logits, kw["num_queries"])
    cfg = Config(model=ModelConfig(**kw), train=TrainConfig(**TRAIN))
    model, criterion, _ = build_model(cfg, device="cpu")
    load_jax_variables(model, copy.deepcopy(init))
    gstate = create_train_state(copy.deepcopy(model), cfg, steps_per_epoch=1)
    loss, _ = criterion(*forward(gstate, batch))
    loss.backward()
    jflat = flat_params(jgrads)
    n = 0
    for k, p in gstate.model.named_parameters():
        if p.grad is None:
            assert k.startswith("backbone.")
            np.testing.assert_array_equal(jflat[k], 0.0)
            continue
        scale = float(np.abs(jflat[k]).max())
        assert_close(p.grad, jflat[k], 1e-5 + 1e-3 * scale, 1e-3, err_msg=k)
        n += k.startswith("transformer.pos_trans")
    assert n == 4
    state = create_train_state(model, cfg, steps_per_epoch=1)
    pm = {k: float(v) for k, v in train_step(state, criterion,
                                             batch).items()}
    assert set(pm) == set(jm)
    assert "loss_giou_enc" in pm
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], **TOL, err_msg=k)


# --------------------------------------------------------------- TransVOD++
VIDEO = dict(DIMS, num_queries=20, hidden_dim=32, enc_layers=1, dec_layers=2,
             dim_feedforward=64, fusion_type="LateFusion",
             temporal_mode="transvod_pp", num_ref_frames=2)


def clip_batch(seed, F=3, H=64, W=96, T=6):
    """One clip of F unpadded uint8 RGB-D frames (the QRF reads padded
    tokens unmasked, where XLA's and PyTorch's sine embeddings differ:
    ROADMAP Queue 3) with targets on every row."""
    rng = np.random.default_rng(seed)
    valid = np.arange(T)[None] < rng.integers(2, 5, (F, 1))
    return {"images": rng.integers(0, 256, (F, H, W, 4), dtype=np.uint8),
            "sizes": np.array([[H, W]] * F),
            "labels": rng.integers(0, 2, (F, T)).astype(np.int32),
            "boxes": np.concatenate([rng.uniform(0.2, 0.8, (F, T, 2)),
                                     rng.uniform(0.05, 0.35, (F, T, 2))],
                                    -1).astype(np.float32),
            "valid": valid}


def test_two_stage_transvod_pp_forward_and_step():
    """TransVOD++ on a two-stage trunk (JAX ``tests/test_temporal.py``'s
    two-stage cases): the key frame's outputs, both aux rounds and the
    key frame's ``enc_outputs`` against flax; then one ``train_step``, as
    the JAX test steps it: finite loss and gradient norm, no ``_enc``
    loss (the train step's criterion reads the top level of a temporal
    model's output, and its ``enc_outputs`` sit under ``_single_frame``,
    in both packages), and the temporal heads and ``pos_trans`` moved
    (``enc_output`` and the encoder's head get no gradient there: the
    top-k and the detached proposals pass none)."""
    jmodel = j_build_model(JConfig(model=JModelConfig(**VIDEO)))[0]
    batch = clip_batch(0)
    x, mask = j_normalize(jnp.asarray(batch["images"]),
                          jnp.asarray(batch["sizes"]))
    variables = dict(random_variables(
        lambda: jmodel.init(KEY, x, mask, train=False), seed=21))
    ref = jax.jit(lambda v: jmodel.apply(v, x, mask, train=False))(variables)
    assert_no_valid_ties(ref["_single_frame"]["enc_outputs"]["pred_logits"],
                         VIDEO["num_queries"])
    cfg = Config(model=ModelConfig(**VIDEO), train=TrainConfig(**TRAIN))
    model, criterion, _ = build_model(cfg, device="cpu")
    load_jax_variables(model, copy.deepcopy(variables))
    with torch.no_grad():
        out = model(*device_normalize(torch.from_numpy(batch["images"]),
                                      torch.from_numpy(batch["sizes"])))
    for k in ("pred_logits", "pred_boxes"):
        assert_close(out[k], ref[k], **TOL, err_msg=k)
        for g, r in zip(out["aux_outputs"], ref["aux_outputs"]):
            assert_close(g[k], r[k], **TOL, err_msg=f"aux {k}")
        assert_close(out["_single_frame"]["enc_outputs"][k],
                     ref["_single_frame"]["enc_outputs"][k], **TOL,
                     err_msg=f"enc {k}")

    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    pm = train_step(create_train_state(model, cfg, steps_per_epoch=1),
                    criterion, batch)
    assert "loss_ce_1" in pm and not any("_enc" in k for k in pm)
    assert all(np.isfinite(float(v)) for v in pm.values())
    moved = {k for k, p in model.named_parameters()
             if not torch.equal(p.detach(), before[k])}
    for part in ("temp_head_0.", "qrf_dynamic_layer1.",
                 "detr.transformer.pos_trans."):
        assert any(k.startswith(part) for k in moved), part


# ------------------------------------------------ the reference's composition
def test_reference_two_stage_replica_through_the_converter():
    """``tests/torch_ref.py``'s two-stage Baseline with box refinement (the
    reference's ``deformable_transformer_single.py:108-153, 306-322``
    composition; without refinement the reference's decoder has no box
    head and its two-stage path fails) converted into the port: the port's converter gives bitwise the state
    dict of the JAX converter followed by ``load_jax_variables`` (no
    unmapped key, no unfilled one), and the port reproduces the replica's
    outputs and ``enc_outputs`` on padded f32 frames within the
    tolerance."""
    refine = True
    torch.manual_seed(7)
    tm = TorchDeformableDETR(with_box_refine=refine, two_stage=True,
                             dilation=True, depth_type=DEPTH_TYPE["Baseline"],
                             **REF_DIMS).eval()
    tm.randomize()
    sd = {k: v.detach().clone() for k, v in tm.state_dict().items()}
    state, unmapped = convert_reference.convert_reference_state_dict(
        sd, with_box_refine=refine, verbose=False)
    assert unmapped == []
    params, model_state, j_unmapped = j_convert(
        {k: v.numpy() for k, v in sd.items()}, with_box_refine=refine,
        verbose=False)
    assert j_unmapped == []
    cfg = Config(model=ModelConfig(**dict(
        DIMS, fusion_type="Baseline", with_box_refine=refine,
        num_feature_levels=1, dilation=True)))
    want = load_jax_variables(build_model(cfg, device="cpu", seed=1)[0],
                              {"params": params, **model_state})
    assert sorted(state) == sorted(want.state_dict())
    for k, v in want.state_dict().items():
        assert torch.equal(state[k], v), k
    imgs, mask = make_inputs(channels=3)
    with torch.no_grad():
        ref = tm(torch.from_numpy(imgs.transpose(0, 3, 1, 2)),
                 torch.from_numpy(mask))
        got = want(torch.from_numpy(imgs), torch.from_numpy(mask))
    assert_no_valid_ties(ref["enc_outputs"]["pred_logits"].numpy(), 12)
    for k in ("pred_logits", "pred_boxes"):
        assert_close(got[k], ref[k].numpy(), **TOL, err_msg=k)
        assert_close(got["enc_outputs"][k], ref["enc_outputs"][k].numpy(),
                     **TOL, err_msg=f"enc {k}")
        for g, r in zip(got["aux_outputs"], ref["aux_outputs"]):
            assert_close(g[k], r[k].numpy(), **TOL, err_msg=f"aux {k}")
