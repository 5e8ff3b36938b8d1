"""The port's checkpoints (``dfvod_tpu_torch/utils/checkpoint.py``): the
key-surgery tools against the JAX package's (``dfvod_tpu/utils/
checkpoint.py``) on the same random flax weights, the retention rule, and
save / resume of a train state.

Surgery: flax variables of a small TransVOD++ LateFusion model and of a
single-frame LateFusion model (random in every leaf,
``torch_port_helpers.random_variables``; traced, never run) go through
each package's tool; the port's result must equal the JAX result mapped
through ``port_key``, key for key and bitwise.

Resume: two steps in a row of a small LateFusion model with dropout 0.1
must equal one step, ``save_checkpoint``, a fresh train state from
another seed, ``load_checkpoint(weights_only=False)`` and one step: loss,
every parameter, the DFormer BN statistics and the optimizer's moments
bitwise, on the CPU.
"""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.utils import checkpoint as j_ckpt
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.train.engine import (
    TrainState,
    create_train_state,
    train_step,
)
from dfvod_tpu_torch.utils import checkpoint as ckpt
from dfvod_tpu_torch.utils.config import Config, ModelConfig, TrainConfig
from dfvod_tpu_torch.utils.convert import port_key
from torch_port_helpers import flat_params, make_frames, random_variables

DIMS = dict(num_classes=3, num_queries=12, hidden_dim=32, nheads=4,
            enc_layers=1, dec_layers=2, dim_feedforward=64, dropout=0.0,
            num_feature_levels=1, fusion_type="LateFusion")
VIDEO = dict(temporal_mode="transvod_pp", num_ref_frames=2)


def flax_params(seed, **kw):
    """Random flax ``params`` of the small model of ``DIMS`` + ``kw``."""
    cfg = JConfig(model=JModelConfig(**dict(DIMS, **kw)))
    model = j_build_model(cfg)[0]
    F = 1 + kw["num_ref_frames"] if kw else 1
    x = jnp.zeros((F, 64, 96, 4), jnp.float32)
    mask = jnp.zeros((F, 64, 96), bool)
    return random_variables(
        lambda: model.init(jax.random.PRNGKey(0), x, mask, train=False),
        seed=seed)["params"]


@pytest.fixture(scope="module")
def video_params():
    return flax_params(1, **VIDEO)


def as_port(tree):
    return {k: torch.from_numpy(np.array(v))
            for k, v in flat_params(tree).items()}


def assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], torch.as_tensor(np.array(want[k]))), k


PATTERNS = [("class_embed",), ("mask_branch",), j_ckpt.TEMPORAL_KEY_PATTERNS,
            ("transformer/head_0", "qrf_dynamic_layer1/inst_interact"),
            ("/bias",)]


@pytest.mark.parametrize("patterns", PATTERNS,
                         ids=["class_embed", "mask_branch", "temporal",
                              "slash_paths", "leaf"])
def test_drop_and_select_keys_match_jax(video_params, patterns):
    """The same weights survive ``drop_keys`` and ``select_keys`` in both
    packages, and the two split the weights between them."""
    # the port's temporal patterns are JAX's and ``temp_head`` (ROADMAP.md
    # Queue 3, known differences)
    assert ckpt.TEMPORAL_KEY_PATTERNS == j_ckpt.TEMPORAL_KEY_PATTERNS + (
        "temp_head",)
    state = as_port(video_params)
    dropped = ckpt.drop_keys(state, *patterns)
    selected = ckpt.select_keys(state, *patterns)
    assert_same_state(dropped, flat_params(
        j_ckpt.drop_keys(video_params, *patterns)))
    assert_same_state(selected, flat_params(
        j_ckpt.select_keys(video_params, *patterns)))
    assert sorted({**dropped, **selected}) == sorted(state)
    assert not set(dropped) & set(selected)
    if patterns != ("mask_branch",):
        assert dropped and selected


def report_as_port(report):
    """A JAX ``merge_matching`` report with each flax path as a port
    key."""
    def key(path):
        parts = path.split("/")
        return port_key("params", parts, np.zeros((1, 1)))[0]
    return {k: sorted(key(p) for p in v) for k, v in report.items()}


def test_merge_matching_reports_and_casts_like_jax(video_params):
    """Missing, unexpected and shape-mismatched keys as JAX reports them;
    matched values cast to the base tensor's dtype, mismatched ones keep
    the base value."""
    base_tree = copy.deepcopy(video_params)
    over_tree = copy.deepcopy(flax_params(2, **VIDEO))
    del over_tree["temp_head_0"]["class_embed"]
    over_tree["extra"] = {"kernel": np.ones((3, 2), np.float32)}
    qe = over_tree["detr"]["transformer"]["query_embed"]
    over_tree["detr"]["transformer"]["query_embed"] = qe[:5]
    merged_tree, jreport = j_ckpt.merge_matching(base_tree, over_tree,
                                                 verbose=False)
    base = {k: v.to(torch.bfloat16) for k, v in as_port(base_tree).items()}
    merged, report = ckpt.merge_matching(base, as_port(over_tree),
                                         verbose=False)
    assert {k: sorted(v) for k, v in report.items()} == \
        report_as_port(jreport)
    assert sorted(report["missing"]) == ["temp_head_0.class_embed.bias",
                                         "temp_head_0.class_embed.weight"]
    assert report["unexpected"] == ["extra.weight"]
    assert report["shape_mismatch"] == ["detr.transformer.query_embed"]
    want = as_port(jax.tree_util.tree_map(np.asarray, merged_tree))
    assert sorted(merged) == sorted(want)
    for k, v in merged.items():
        assert v.dtype == torch.bfloat16 and v.device == base[k].device, k
        assert torch.equal(v, want[k].to(torch.bfloat16)), k
    assert torch.equal(merged["detr.transformer.query_embed"],
                       base["detr.transformer.query_embed"])


def test_merge_temporal_weights_nests_a_single_frame_checkpoint(
        video_params):
    """A single-frame spatial checkpoint under a TransVOD++ model nests
    under ``detr.``; the temporal heads, ``temp_head_{i}`` included, come
    from the temporal checkpoint, as the reference's
    ``--transvod_temporal_weights`` loads them. Every other key equals
    JAX's ``merge_temporal_weights``, which keeps the heads at the base
    weights: no pattern of the JAX package names its (and the port's)
    head modules (ROADMAP.md Queue 3, known differences)."""
    spatial = flax_params(3)
    temporal = flax_params(4, **VIDEO)
    want = j_ckpt.merge_temporal_weights(video_params, temporal, spatial)
    got = ckpt.merge_temporal_weights(as_port(video_params),
                                      as_port(temporal), as_port(spatial))
    sp, tp = as_port(spatial), as_port(temporal)
    heads = sorted(k for k in got if k.startswith("temp_head"))
    assert len(heads) == 3 * 8 and all(
        k.startswith(("temp_head_0.", "temp_head_1.", "temp_head_2."))
        for k in heads)
    want = flat_params(jax.tree_util.tree_map(np.asarray, want))
    assert_same_state({k: v for k, v in got.items() if k not in heads},
                      {k: v for k, v in want.items() if k not in heads})
    for k in heads:
        assert torch.equal(got[k], tp[k]), k
        assert not torch.equal(got[k], torch.as_tensor(want[k])), k
    assert torch.equal(got["detr.transformer.query_embed"],
                       sp["transformer.query_embed"])
    assert torch.equal(got["temporal_decoder1.layers_0.norm1.weight"],
                       tp["temporal_decoder1.layers_0.norm1.weight"])
    base = as_port(video_params)
    for k, v in got.items():
        if not k.startswith("detr."):
            src = tp if ckpt.select_keys(
                {k: v}, *ckpt.TEMPORAL_KEY_PATTERNS) else base
            assert torch.equal(v, src[k]), k


# ------------------------------------------------------------ persistence
CFG = Config(model=ModelConfig(**dict(DIMS, dropout=0.1)),
             train=TrainConfig(lr=1e-4, weight_decay=2e-5, clip_max_norm=0.1,
                               epochs=3, seed=7))


def fresh_state(seed, train_seed=7):
    cfg = dataclasses.replace(CFG, train=dataclasses.replace(
        CFG.train, seed=train_seed))
    model, criterion, _ = build_model(cfg, device="cpu", seed=seed)
    return create_train_state(model, cfg, steps_per_epoch=2), criterion


def batch(seed):
    rng = np.random.default_rng(seed)
    imgs, sizes = make_frames(4, seed=seed)
    return {"images": imgs, "sizes": sizes,
            "labels": rng.integers(0, 2, (2, 6)).astype(np.int32),
            "boxes": np.concatenate([rng.uniform(0.2, 0.8, (2, 6, 2)),
                                     rng.uniform(0.05, 0.3, (2, 6, 2))],
                                    -1).astype(np.float32),
            "valid": np.arange(6)[None] < np.array([[3], [5]])}


def test_retention_keeps_the_newest_three_and_every_fifth(tmp_path):
    """Epochs 0-11 saved leave {0, 5, 9, 10, 11} (a one-layer state: the
    rule reads only the file names)."""
    model = torch.nn.Linear(2, 2)
    state = TrainState(model, torch.optim.AdamW(model.parameters()), {},
                       torch.Generator(), CFG, 1)
    for epoch in range(12):
        ckpt.save_checkpoint(str(tmp_path), state, epoch)
    assert ckpt.saved_epochs(str(tmp_path)) == [0, 5, 9, 10, 11]
    assert sorted(os.listdir(tmp_path)) == [
        f"checkpoint{e:04}.pth" for e in (0, 5, 9, 10, 11)]
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "none"), state)


def snapshot(state):
    """Parameters, buffers and optimizer moments, cloned."""
    return ({k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            {k: {n: t.clone() for n, t in s.items()} for k, s in
             enumerate(state.optimizer.state.values())})


def test_weights_only_resume_overlays_the_weights_and_keeps_a_fresh_optimizer(
        tmp_path):
    state, criterion = fresh_state(0)
    train_step(state, criterion, batch(0))
    path = ckpt.save_checkpoint(str(tmp_path), state, 3)
    saved = torch.load(path, weights_only=True)
    assert set(saved) == {"model", "optimizer", "step", "epoch",
                          "generator", "args"}
    assert saved["args"] == dataclasses.asdict(CFG)
    assert (saved["step"], saved["epoch"]) == (1, 3)
    weights = snapshot(state)[0]

    fresh, _ = fresh_state(5, train_seed=8)
    gen = fresh.generator.get_state()
    fresh2, epoch = ckpt.load_checkpoint(str(tmp_path), fresh)
    assert fresh2 is fresh and epoch == 3
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, weights[k]), k
    assert fresh.step == 0 and not fresh.optimizer.state
    assert torch.equal(fresh.generator.get_state(), gen)
    ckpt_dict, epoch = ckpt.load_checkpoint(str(tmp_path), epoch=3)
    assert epoch == 3 and ckpt_dict["epoch"] == 3


@pytest.fixture(scope="module")
def unbroken():
    """Two steps in a row; the losses and the state after them."""
    state, criterion = fresh_state(0)
    losses = [train_step(state, criterion, batch(i))["loss"]
              for i in range(2)]
    return losses, snapshot(state)


@pytest.mark.parametrize("restore_generator", [True, False],
                         ids=["full_state", "without_generator"])
def test_full_resume_equals_an_unbroken_run(tmp_path, unbroken,
                                            restore_generator):
    """Dropout 0.1: a resumed step is bitwise the unbroken run's second
    step. Without the generator's state it draws other masks, and the
    loss and weights differ."""
    losses, (weights, moments) = unbroken
    state, criterion = fresh_state(0)
    first = train_step(state, criterion, batch(0))["loss"]
    assert torch.equal(first, losses[0])
    ckpt.save_checkpoint(str(tmp_path), state, 0)

    fresh, criterion = fresh_state(5, train_seed=8)
    if restore_generator:
        ckpt.load_checkpoint(str(tmp_path), fresh, weights_only=False)
    else:
        gen = fresh.generator.get_state()
        ckpt.load_checkpoint(str(tmp_path), fresh, weights_only=False)
        fresh.generator.set_state(gen)
    assert fresh.step == 1
    loss = train_step(fresh, criterion, batch(1))["loss"]
    got_weights, got_moments = snapshot(fresh)
    same = (torch.equal(loss, losses[1])
            and all(torch.equal(got_weights[k], v)
                    for k, v in weights.items())
            and all(torch.equal(got_moments[i][n], t)
                    for i, s in moments.items() for n, t in s.items()))
    assert same == restore_generator
    if restore_generator:
        assert len(got_moments) == len(moments) > 0
        assert fresh.step == 2
