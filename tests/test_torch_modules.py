"""One test per ported module against its flax counterpart, with weights
carried by ``dfvod_tpu_torch/utils/convert.py`` (full key coverage both
ways) and inputs made with numpy from a seed.

Tolerances (f32 on the CPU): elementwise and embedding code atol 1e-5;
single layers atol 1e-4 / rtol 1e-3, the JAX package's own torch-parity
tolerance; the 50-layer ResNet atol 1e-4 of the output's scale / rtol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.models import layers as jl
from dfvod_tpu.models import transformer as jt
from dfvod_tpu.models.backbone_dformer import DFormerBackbone as JDFormer
from dfvod_tpu.models.backbone_resnet import ResNet50 as JResNet50
from dfvod_tpu.models.backbone_resnet import downsample_mask as j_dsmask
from dfvod_tpu.models.position_encoding import (
    sine_position_embedding as j_sine,
    sine_position_embedding_rect as j_sine_rect,
)
from dfvod_tpu.models.postprocess import postprocess as j_postprocess
from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import layers as pl
from dfvod_tpu_torch.models import transformer as pt
from dfvod_tpu_torch.models.backbone_dformer import DFormerBackbone
from dfvod_tpu_torch.models.backbone_resnet import ResNet50, downsample_mask
from dfvod_tpu_torch.models.position_encoding import (
    sine_position_embedding,
    sine_position_embedding_rect,
)
from dfvod_tpu_torch.models.postprocess import postprocess
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import assert_close, random_variables, t2n

KEY = jax.random.PRNGKey(0)
D_MODEL, HEADS = 64, 4


def rect_mask(B, H, W, valid):
    """(B, H, W) bool padding mask, True = pad; image i keeps the top-left
    valid[i] = (h, w) block."""
    mask = np.ones((B, H, W), bool)
    for i, (h, w) in enumerate(valid):
        mask[i, :h, :w] = False
    return mask


def port_module(module, variables):
    return load_jax_variables(module, variables).eval()


def tt(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ----------------------------------------------------------------- data
def test_device_normalize():
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (2, 12, 16, 4), dtype=np.uint8)
    sizes = np.array([[12, 16], [7, 10]])
    jx, jm = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    x, m = device_normalize(*tt(imgs, sizes))
    assert x.dtype == torch.float32 and m.dtype == torch.bool
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert_close(x, jx, atol=1e-6, rtol=0)
    assert np.all(x.numpy()[1, 7:] == 0) and np.all(x.numpy()[1, :, 10:] == 0)


@pytest.mark.parametrize("shape", [(8, 11), (6, 8), (16, 21)])
def test_downsample_mask(shape):
    mask = rect_mask(2, 61, 83, [(61, 83), (40, 57)])
    got = downsample_mask(torch.from_numpy(mask), shape)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_dsmask(jnp.asarray(mask),
                                                      shape)))


@pytest.mark.parametrize("rect", [False, True], ids=["general", "rect"])
def test_sine_position_embedding(rect):
    """Compared on valid pixels: padded pixels hold the sine of about -3e6,
    which XLA and PyTorch may round differently, and never reach the
    logits."""
    mask = rect_mask(2, 9, 13, [(9, 13), (5, 8)])
    jfn, pfn = ((j_sine_rect, sine_position_embedding_rect) if rect
                else (j_sine, sine_position_embedding))
    ref = np.asarray(jfn(jnp.asarray(~mask), 16))
    got = pfn(torch.from_numpy(~mask), 16).numpy()
    assert got.shape == ref.shape == (2, 9, 13, 32)
    valid = ~mask
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-5, rtol=0)
    if rect:
        general = sine_position_embedding(torch.from_numpy(~mask), 16)
        np.testing.assert_allclose(got[valid], general.numpy()[valid],
                                   atol=1e-5, rtol=0)


# ------------------------------------------------------------- backbones
def test_resnet50_dc5():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    jm = JResNet50(dilation=True, return_stages=(4,))
    v = random_variables(lambda: jm.init(KEY, jnp.asarray(x)), seed=1)
    ref = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))[4])
    model = port_module(ResNet50(dilation=True, return_stages=(4,)), v)
    with torch.no_grad():
        got = model(torch.from_numpy(x))[4]
    assert got.shape == ref.shape == (2, 4, 6, 2048)
    np.testing.assert_allclose(t2n(got), ref, rtol=1e-3,
                               atol=1e-4 * np.abs(ref).max())


def test_dformer_backbone():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 96, 1)).astype(np.float32)
    mask = rect_mask(2, 64, 96, [(64, 96), (40, 70)])
    jm = JDFormer()
    v = random_variables(lambda: jm.init(KEY, jnp.asarray(x),
                                         jnp.asarray(mask)), seed=2)
    assert set(v) == {"params", "batch_stats"}
    rf, rm = jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(mask))
    model = port_module(DFormerBackbone(), v)
    with torch.no_grad():
        gf, gm = model(*tt(x, mask))
    assert gf.shape == rf.shape == (2, 4, 6, 128)
    assert_close(gf, rf, atol=1e-4, rtol=1e-3)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(rm))


# ------------------------------------------------------------ attention
SHAPES2 = ((6, 8), (3, 4))


def msda_inputs(ref_dim, seed=3, Lq=10):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in SHAPES2)
    query = rng.standard_normal((2, Lq, D_MODEL)).astype(np.float32)
    src = rng.standard_normal((2, S, D_MODEL)).astype(np.float32)
    if ref_dim == 2:
        ref = rng.uniform(0, 1, (2, Lq, 2, 2))
    else:
        ref = np.concatenate([rng.uniform(0.2, 0.8, (2, Lq, 2, 2)),
                              rng.uniform(0.05, 0.4, (2, Lq, 2, 2))], -1)
    pad = np.zeros((2, S), bool)
    pad[1, 30:48] = True
    pad[1, 60:] = True
    return query, ref.astype(np.float32), src, pad


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_msdeformattn(ref_dim):
    query, ref, src, pad = msda_inputs(ref_dim)
    jm = jl.MSDeformAttn(D_MODEL, len(SHAPES2), HEADS, 3)
    args = [jnp.asarray(a) for a in (query, ref, src)]
    v = random_variables(lambda: jm.init(KEY, *args, SHAPES2,
                                         jnp.asarray(pad)), seed=ref_dim)
    out = jax.jit(lambda v, q, r, s, p: jm.apply(v, q, r, s, SHAPES2, p))(
        v, *args, jnp.asarray(pad))
    model = port_module(pl.MSDeformAttn(D_MODEL, len(SHAPES2), HEADS, 3), v)
    q, r, s, p = tt(query, ref, src, pad)
    with torch.no_grad():
        got = model(q, r, s, SHAPES2, p)
        # padding rows are zeroed before sampling: what lies there is moot
        s2 = s.masked_fill(p[..., None], 1e3)
        got2 = model(q, r, s2, SHAPES2, p)
    assert_close(got, out, atol=1e-4, rtol=1e-3)
    np.testing.assert_array_equal(got.numpy(), got2.numpy())


def test_convert_checks_coverage_both_ways():
    """A flax leaf that fills nothing, a port key left unfilled, or a shape
    mismatch raises instead of loading a half-converted model."""
    query, ref, src, pad = msda_inputs(2)
    jm = jl.MSDeformAttn(D_MODEL, len(SHAPES2), HEADS, 3)
    v = random_variables(lambda: jm.init(
        KEY, *[jnp.asarray(a) for a in (query, ref, src)], SHAPES2))
    fresh = lambda: pl.MSDeformAttn(D_MODEL, len(SHAPES2), HEADS, 3)  # noqa
    params = v["params"]
    missing = {"params": {k: p for k, p in params.items()
                          if k != "output_proj"}}
    extra = {"params": {**params, "stray": {"kernel": np.zeros((2, 2))}}}
    bad = {"params": {**params, "value_proj": {
        "kernel": np.zeros((D_MODEL, 8)), "bias": np.zeros(8)}}}
    for variables, what in (
            (missing, r"0 flax leaves unused \[\], 2 port keys unfilled "
                      r"\['output_proj.bias', 'output_proj.weight'\]"),
            (extra, r"1 flax leaves unused \['params/stray/kernel'\], 0 "),
            (bad, r"shape mismatches \['value_proj.weight")):
        with pytest.raises(ValueError, match=what):
            load_jax_variables(fresh(), variables)
    model = load_jax_variables(fresh(), v)
    np.testing.assert_array_equal(
        t2n(model.value_proj.weight),
        np.asarray(params["value_proj"]["kernel"]).T)


def test_msda_loc_promotes_to_f32(monkeypatch):
    """bf16 offsets over f32 reference points give f32 sampling
    locations, as JAX promotes them (``layers.py:138-147``)."""
    seen = {}
    real = pl.ms_deform_attn

    def spy(value, shapes, loc, attw, **kw):
        seen.update(value=value.dtype, loc=loc.dtype, attw=attw.dtype)
        return real(value, shapes, loc, attw, **kw)

    monkeypatch.setattr(pl, "ms_deform_attn", spy)
    query, ref, src, pad = msda_inputs(2)
    model = pl.MSDeformAttn(D_MODEL, len(SHAPES2), HEADS, 3).bfloat16()
    q, r, s, p = tt(query, ref, src, pad)
    with torch.no_grad():
        out = model(q.bfloat16(), r, s.bfloat16(), SHAPES2, p)
    assert out.dtype == torch.bfloat16
    assert seen == {"value": torch.bfloat16, "loc": torch.float32,
                    "attw": torch.bfloat16}
    # the JAX expression's own promotion: f32 ref + bf16 offsets / bf16 wh
    bf = jnp.ones((1,), jnp.bfloat16)
    assert (jnp.ones((1,), jnp.float32) + bf / bf).dtype == jnp.float32


def test_multihead_attention():
    rng = np.random.default_rng(5)
    q, k, v_in = (rng.standard_normal((2, n, D_MODEL)).astype(np.float32)
                  for n in (12, 9, 9))
    jm = jl.MultiHeadAttention(D_MODEL, HEADS)
    args = [jnp.asarray(a) for a in (q, k, v_in)]
    v = random_variables(lambda: jm.init(KEY, *args), seed=5)
    ref = jax.jit(jm.apply)(v, *args)
    model = port_module(pl.MultiHeadAttention(D_MODEL, HEADS), v)
    with torch.no_grad():
        got = model(*tt(q, k, v_in))
    assert_close(got, ref, atol=1e-4, rtol=1e-3)


def test_mlp():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 12, D_MODEL)).astype(np.float32)
    jm = jl.MLP(D_MODEL, 4, 3)
    v = random_variables(lambda: jm.init(KEY, jnp.asarray(x)), seed=10)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    model = port_module(pl.MLP(D_MODEL, D_MODEL, 4, 3), v)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert_close(got, ref, atol=1e-5, rtol=1e-4)


# ---------------------------------------------------- transformer layers
SHAPES1 = ((6, 8),)


def layer_inputs(seed, Lq):
    rng = np.random.default_rng(seed)
    S = 48
    x = rng.standard_normal((2, Lq, D_MODEL)).astype(np.float32)
    pos = rng.standard_normal((2, Lq, D_MODEL)).astype(np.float32)
    src = rng.standard_normal((2, S, D_MODEL)).astype(np.float32)
    ref = rng.uniform(0, 1, (2, Lq, 1, 2)).astype(np.float32)
    pad = np.zeros((2, S), bool)
    pad[1, 36:] = True
    return x, pos, ref, src, pad


def test_encoder_layer():
    src, pos, ref, _, pad = layer_inputs(6, 48)
    jm = jt.DeformableTransformerEncoderLayer(D_MODEL, 128, 0.0, "relu", 1,
                                              HEADS, 4)
    args = [jnp.asarray(a) for a in (src, pos, ref)]
    v = random_variables(lambda: jm.init(KEY, *args, SHAPES1,
                                         jnp.asarray(pad)), seed=6)
    ref_out = jax.jit(lambda v, a, b, c, p: jm.apply(v, a, b, c, SHAPES1,
                                                     p))(
        v, *args, jnp.asarray(pad))
    model = port_module(pt.DeformableTransformerEncoderLayer(
        D_MODEL, 128, "relu", 1, HEADS, 4), v)
    with torch.no_grad():
        got = model(*tt(src, pos, ref), SHAPES1, torch.from_numpy(pad))
    assert_close(got, ref_out, atol=1e-4, rtol=1e-3)


def test_decoder_layer():
    tgt, qpos, ref, src, pad = layer_inputs(7, 12)
    jm = jt.DeformableTransformerDecoderLayer(D_MODEL, 128, 0.0, "relu", 1,
                                              HEADS, 4)
    args = [jnp.asarray(a) for a in (tgt, qpos, ref, src)]
    v = random_variables(lambda: jm.init(KEY, *args, SHAPES1,
                                         jnp.asarray(pad)), seed=7)
    ref_out = jax.jit(lambda v, a, b, c, d, p: jm.apply(
        v, a, b, c, d, SHAPES1, p))(v, *args, jnp.asarray(pad))
    model = port_module(pt.DeformableTransformerDecoderLayer(
        D_MODEL, 128, "relu", 1, HEADS, 4), v)
    with torch.no_grad():
        got = model(*tt(tgt, qpos, ref, src), SHAPES1,
                    torch.from_numpy(pad))
    assert_close(got, ref_out, atol=1e-4, rtol=1e-3)


def test_depth_fusion_layer():
    tgt, qpos, ref, src, pad = layer_inputs(8, 48)
    jm = jt.DepthFusionLayer(D_MODEL, 0.0, 1, HEADS, 4)
    args = [jnp.asarray(a) for a in (tgt, qpos, ref, src)]
    v = random_variables(lambda: jm.init(KEY, *args, SHAPES1,
                                         jnp.asarray(pad)), seed=8)
    ref_out = jax.jit(lambda v, a, b, c, d, p: jm.apply(
        v, a, b, c, d, SHAPES1, p))(v, *args, jnp.asarray(pad))
    model = port_module(pt.DepthFusionLayer(D_MODEL, 1, HEADS, 4), v)
    with torch.no_grad():
        got = model(*tt(tgt, qpos, ref, src), SHAPES1,
                    torch.from_numpy(pad))
    assert_close(got, ref_out, atol=1e-4, rtol=1e-3)


def test_flatten_levels_casts_pos_to_token_dtype():
    """The f32 sine embedding is cast to the token dtype, so a bf16 model
    stays bf16 (``transformer.py:93-96``)."""
    src = torch.zeros(2, 3, 4, 8, dtype=torch.bfloat16)
    mask = torch.zeros(2, 3, 4, dtype=torch.bool)
    pos = torch.ones(2, 3, 4, 8)
    s, m, p, shapes = pt.flatten_levels([src], [mask], [pos],
                                        torch.ones(1, 8, dtype=torch.bfloat16))
    assert s.shape == (2, 12, 8) and m.shape == (2, 12)
    assert shapes == ((3, 4),)
    assert p.dtype == torch.bfloat16 and torch.all(p == 2)


# ------------------------------------------------------------ postprocess
@pytest.mark.parametrize("K,top_k", [(3, 10), (4, 100)],
                         ids=["no_object_excluded", "clamped_topk"])
def test_postprocess(K, top_k):
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 12, K)).astype(np.float32)
    boxes = rng.uniform(0.1, 0.9, (2, 12, 4)).astype(np.float32)
    sizes = np.array([[96, 128], [60, 84]])
    ref = j_postprocess(jnp.asarray(logits), jnp.asarray(boxes),
                        jnp.asarray(sizes), top_k=top_k)
    got = postprocess(*tt(logits, boxes, sizes), top_k=top_k)
    k = min(top_k, 12 * (K - 1 if K == 3 else K))
    assert got["scores"].shape == (2, k)
    # continuous random logits: no ties, so the top-k order is the same
    assert_close(got["scores"], ref["scores"], atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    assert_close(got["boxes"], ref["boxes"], atol=1e-4, rtol=0)
    if K == 3:
        assert int(got["labels"].max()) <= 1
