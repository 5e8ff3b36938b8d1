"""The port's TransVOD / TransVOD++ slice against the flax modules: each
temporal module, the whole ``TemporalDeformableDETR`` in both modes (with
and without TDAM), the weight bridge, and ``Server`` serving clips.

Small dims, inputs made with numpy from seeds, flax variables random in
every leaf (``torch_port_helpers.random_variables``) and carried into the
port by ``utils/convert.py``. Tolerances (f32 on the CPU): single modules
atol 1e-5 / rtol 1e-4; whole models atol 1e-4 / rtol 1e-3, the JAX
package's full-model torch-parity tolerance. 100 queries, so that every
top-k round really selects (k = 80N, 50N, 30N of N*Q).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.models import temporal as jtm
from dfvod_tpu.models.postprocess import postprocess as j_postprocess
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models import temporal as tm
from dfvod_tpu_torch.serve import Server
from dfvod_tpu_torch.train import create_train_state
from dfvod_tpu_torch.utils.config import Config, ModelConfig, check_supported
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import assert_close, random_variables

KEY = jax.random.PRNGKey(0)
D, HEADS = 32, 4
MODULE_TOL = dict(atol=1e-5, rtol=1e-4)
MODEL_TOL = dict(atol=1e-4, rtol=1e-3)


def port_module(module, variables):
    return load_jax_variables(module, variables).eval()


def run_both(jmod, pmod, inputs, seed=0, **jkw):
    """(port output, flax output) of one module on the same numpy inputs
    and random flax variables."""
    jin = [None if x is None else jnp.asarray(x) for x in inputs]
    v = random_variables(lambda: jmod.init(KEY, *jin, **jkw), seed=seed)
    ref = jmod.apply(v, *jin, **jkw)
    port = port_module(pmod, v)
    with torch.no_grad():
        got = port(*[None if x is None else torch.from_numpy(np.asarray(x))
                     for x in inputs])
    return got, ref


def randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --------------------------------------------------------------- modules
@pytest.mark.parametrize("with_pos", [False, True])
def test_temporal_query_encoder_layer(with_pos):
    rng = np.random.default_rng(0)
    query, ref_query = randn(rng, 2, 12, D), randn(rng, 2, 20, D)
    pos = [randn(rng, 2, 12, D), randn(rng, 2, 20, D)] if with_pos else []
    got, ref = run_both(jtm.TemporalQueryEncoderLayer(D, 64, 0.0, HEADS),
                        tm.TemporalQueryEncoderLayer(D, 64, 0.0, HEADS),
                        [query, ref_query, *pos])
    assert_close(got, ref, **MODULE_TOL)


@pytest.mark.parametrize("n_ref", [2, 5])
def test_tdam_layer(n_ref):
    """TDAM attends into N reference frames as N levels; N = 5 is beyond
    the four levels K1 took before this slice."""
    rng = np.random.default_rng(n_ref)
    H, W, B = 4, 5, 2
    shapes = ((H, W),) * n_ref
    vr = rng.uniform(0.6, 1.0, (B, 1, 2)).astype(np.float32)
    ref_points = np.array(jtm._grid_reference_points(
        shapes, jnp.broadcast_to(jnp.asarray(vr), (B, n_ref, 2))))
    inputs = [randn(rng, B, H * W, D), randn(rng, B, H * W, D), ref_points,
              randn(rng, B, n_ref * H * W, D)]
    jmod = jtm.TDAMLayer(D, 64, 0.0, n_ref, HEADS)
    pmod = tm.TDAMLayer(D, 64, 0.0, n_ref, HEADS)
    jin = [jnp.asarray(x) for x in inputs]
    v = random_variables(lambda: jmod.init(KEY, *jin, shapes), seed=1)
    ref = jmod.apply(v, *jin, shapes)
    port = port_module(pmod, v)
    with torch.no_grad():
        got = port(*[torch.from_numpy(x) for x in inputs], shapes)
    assert_close(got, ref, **MODULE_TOL)
    vr_t = torch.from_numpy(vr).expand(B, n_ref, 2)
    assert_close(tm._grid_reference_points(shapes, vr_t), ref_points,
                 atol=0, rtol=0)


def test_dynamic_conv():
    rng = np.random.default_rng(3)
    got, ref = run_both(jtm.DynamicConv(D), tm.DynamicConv(D),
                        [randn(rng, 3, 10, D), randn(rng, 3, 10, 49, D)])
    assert_close(got, ref, **MODULE_TOL)


def test_rcnn_head():
    rng = np.random.default_rng(4)
    got, ref = run_both(jtm.RCNNHead(D, 64, HEADS, 0.0),
                        tm.RCNNHead(D, 64, HEADS, 0.0),
                        [randn(rng, 3, 10, 7, 7, D), randn(rng, 3, 10, D)])
    assert_close(got, ref, **MODULE_TOL)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_temporal_decoder(ref_dim):
    rng = np.random.default_rng(5 + ref_dim)
    H, W, B, Q = 4, 6, 2, 12
    ref_points = rng.uniform(0.1, 0.9, (B, Q, ref_dim)).astype(np.float32)
    vr = rng.uniform(0.6, 1.0, (B, 1, 2)).astype(np.float32)
    inputs = [randn(rng, B, Q, D), ref_points, randn(rng, B, H * W, D)]
    jmod = jtm.TemporalDecoder(D, 64, 0.0, 2, HEADS, 4)
    jin = [jnp.asarray(x) for x in inputs]
    v = random_variables(
        lambda: jmod.init(KEY, *jin, ((H, W),), jnp.asarray(vr)), seed=6)
    ref_out, ref_refp = jmod.apply(v, *jin, ((H, W),), jnp.asarray(vr))
    port = port_module(tm.TemporalDecoder(D, 64, 0.0, 2, HEADS, 4), v)
    with torch.no_grad():
        out, refp = port(*[torch.from_numpy(x) for x in inputs], ((H, W),),
                         torch.from_numpy(vr))
    assert_close(out, ref_out, **MODULE_TOL)
    assert_close(refp, ref_refp, atol=0, rtol=0)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_apply_box_head(ref_dim):
    rng = np.random.default_rng(ref_dim)
    deltas = randn(rng, 2, 7, 4)
    reference = rng.uniform(0, 1, (2, 7, ref_dim)).astype(np.float32)
    ref = jtm._apply_box_head(jnp.asarray(deltas), jnp.asarray(reference))
    got = tm._apply_box_head(torch.from_numpy(deltas),
                             torch.from_numpy(reference))
    assert_close(got, ref, atol=1e-6, rtol=1e-6)


def test_topk_queries():
    rng = np.random.default_rng(9)
    ref_hs, scores = randn(rng, 2, 30, 8), randn(rng, 2, 30)
    ref = jtm._topk_queries(jnp.asarray(ref_hs), jnp.asarray(scores), 11)
    got = tm._topk_queries(torch.from_numpy(ref_hs),
                           torch.from_numpy(scores), 11)
    assert_close(got, ref, atol=0, rtol=0)


# ---------------------------------------------------------- whole models
DIMS = dict(num_classes=3, num_queries=100, hidden_dim=D, nheads=HEADS,
            enc_layers=1, dec_layers=2, dim_feedforward=64, dropout=0.0,
            num_feature_levels=1)
VARIANTS = {
    "transvod_pp": dict(temporal_mode="transvod_pp",
                        fusion_type="LateFusion", num_ref_frames=2),
    "transvod_tdam": dict(temporal_mode="transvod", use_tdam=True,
                          fusion_type="LateFusion", num_ref_frames=3),
    "transvod": dict(temporal_mode="transvod", fusion_type="Baseline",
                     num_ref_frames=2),
}
CLIPS = {"transvod_pp": 2, "transvod_tdam": 1, "transvod": 2}
# TDAM attends into the reference frames' padded tokens too (no mask), and
# a padded token's sine embedding is the sine of about -3e6, which XLA and
# PyTorch round differently (up to 6e-3, tests/test_torch_modules.py): the
# TDAM model is compared on frames without padding
PADDED = {"transvod_pp": True, "transvod_tdam": False, "transvod": True}
TRUNK_KEYS = ("hs_last", "last_reference", "last_deltas", "pos_flat",
              "memory", "valid_ratios")


def make_clips(channels, B, F, padded=True, seed=0, H=64, W=96):
    """uint8 frames of B clips of F frames; with ``padded`` the second
    frame of every clip keeps a 40 x 70 block, padded bottom/right."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B * F, H, W, channels), dtype=np.uint8)
    sizes = np.array([[H, W]] * (B * F))
    if padded:
        sizes[1::F] = [40, 70]
    for i, (h, w) in enumerate(sizes):
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    return imgs, sizes


@pytest.fixture(scope="module", params=list(VARIANTS))
def flax_run(request):
    """(name, model kwargs, frames, sizes, flax variables, flax outputs,
    flax trunk)."""
    name = request.param
    kw = dict(DIMS, **VARIANTS[name])
    model = j_build_model(JConfig(model=JModelConfig(**kw)))[0]
    F = 1 + kw["num_ref_frames"]
    imgs, sizes = make_clips(4 if kw["fusion_type"] == "LateFusion" else 3,
                             CLIPS[name], F, PADDED[name])
    x, mask = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    variables = random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=21)
    out = jax.jit(lambda v, i, m: model.apply(v, i, m, train=False))(
        variables, x, mask)
    trunk = jax.jit(lambda v, i, m: model.apply(
        v, i, m, method=lambda mod, i, m: mod.detr(i, m, train=False)))(
        variables, x, mask)["_trunk"]
    return name, kw, imgs, sizes, variables, out, trunk


def port_model(kw, variables):
    model, _, _ = build_model(Config(model=ModelConfig(**kw)), device="cpu")
    assert isinstance(model, tm.TemporalDeformableDETR)
    return load_jax_variables(model, variables)


def test_temporal_model_matches_flax(flax_run):
    name, kw, imgs, sizes, variables, ref, ref_trunk = flax_run
    model = port_model(kw, variables)
    x, mask = device_normalize(torch.from_numpy(imgs),
                               torch.from_numpy(sizes))
    with torch.no_grad():
        out = model(x, mask)
        trunk = model.detr(x, mask)["_trunk"]
    B, Q = CLIPS[name], kw["num_queries"]
    assert out["pred_logits"].shape == (B, Q, 3)
    for k in TRUNK_KEYS:
        got, want = trunk[k], np.asarray(ref_trunk[k])
        if k in ("pos_flat", "memory"):
            # padded tokens hold the sine of about -3e6 (PADDED above), and
            # the encoder's queries carry it into their memory
            valid = ~trunk["mask_flat"].numpy()
            got, want = got[torch.from_numpy(valid)], want[valid]
        assert_close(got, want, **MODEL_TOL, err_msg=f"{name} _trunk {k}")
    pairs = [("final", out, ref),
             ("single_frame", out["_single_frame"], ref["_single_frame"])]
    if name == "transvod_pp":
        assert len(out["aux_outputs"]) == len(ref["aux_outputs"]) == 2
        pairs += [(f"aux {i}", o, r) for i, (o, r) in
                  enumerate(zip(out["aux_outputs"], ref["aux_outputs"]))]
    else:
        assert "aux_outputs" not in out and "aux_outputs" not in ref
    for tag, o, r in pairs:
        for k in ("pred_logits", "pred_boxes"):
            assert_close(o[k], r[k], **MODEL_TOL, err_msg=f"{name} {tag} {k}")


def test_weight_bridge_covers_both_ways(flax_run):
    """Every flax leaf fills a port key and every port key is filled:
    ``load_jax_variables`` raises otherwise, so dropping one flax leaf must
    raise."""
    name, kw, _, _, variables, _, _ = flax_run
    model = port_model(kw, variables)
    n_flax = len(jax.tree_util.tree_leaves(variables))
    assert n_flax == len(model.state_dict())
    names = {"transvod_pp": ("qrf_dynamic_layer1", "temporal_decoder3",
                             "temp_head_2"),
             "transvod_tdam": ("temporal_encoder_layer", "temp_head"),
             "transvod": ("temporal_decoder", "temp_head")}[name]
    for n in names:
        assert n in variables["params"] and hasattr(model, n)
    params = dict(variables["params"])
    params.pop("temporal_query_layer3")
    with pytest.raises(ValueError, match="unfilled"):
        load_jax_variables(port_model(kw, variables),
                           {**variables, "params": params})


def test_clip_server(flax_run):
    """``Server`` in clip mode on the CPU: uint8 clips to key-frame
    detections against ``postprocess`` of the flax outputs with the key
    frames' sizes."""
    name, kw, imgs, sizes, variables, ref, _ = flax_run
    server = Server(Config(model=ModelConfig(**kw)), variables,
                    device="cpu", dtype=torch.float32)
    det = server(imgs, sizes)
    F = 1 + kw["num_ref_frames"]
    jdet = j_postprocess(ref["pred_logits"], ref["pred_boxes"],
                         jnp.asarray(sizes[::F]))
    B = CLIPS[name]
    assert det["scores"].shape == (B, 100) and det["boxes"].shape == (
        B, 100, 4)
    js = np.asarray(jdet["scores"])
    np.testing.assert_allclose(np.sort(det["scores"].numpy(), 1),
                               np.sort(js, 1), atol=1e-4, rtol=1e-3)
    gap = np.abs(np.diff(js, axis=1))
    clear = np.ones_like(js, bool)
    clear[:, 1:] &= gap > 1e-3
    clear[:, :-1] &= gap > 1e-3
    np.testing.assert_array_equal(det["labels"].numpy()[clear],
                                  np.asarray(jdet["labels"])[clear])
    np.testing.assert_allclose(det["boxes"].numpy()[clear],
                               np.asarray(jdet["boxes"])[clear], atol=1e-2,
                               rtol=1e-3)
    with pytest.raises(ValueError, match="whole clips"):
        server(imgs[:-1], sizes[:-1])


@pytest.mark.parametrize("mode", ["transvod", "transvod_pp"])
def test_temporal_modes_serve_and_train(mode):
    """Both temporal modes are accepted for training, and a train state
    over such a model holds the flat two-group optimizer of
    ``dfvod_tpu/train/optim.py`` (``tests/test_torch_temporal_train.py``
    drives the steps)."""
    cfg = Config(model=ModelConfig(**dict(DIMS, temporal_mode=mode)))
    check_supported(cfg.model)
    check_supported(cfg.model, training=True)
    state = create_train_state(build_model(cfg, device="cpu")[0], cfg)
    assert {g["label"] for g in state.optimizer.param_groups} == {
        "base", "linear_proj"}
    assert all(p.requires_grad for p in state.model.parameters())
