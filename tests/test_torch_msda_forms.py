"""The opt-in MSDA forms on the CPU: the port's plain versions of K5a-e
against the JAX package's Pallas kernels in interpret mode, and the
``impl`` / ``DFVOD_MSDA_IMPL`` dispatch against the JAX function each form
names.

- K5b/c: ``corner_indices_weights``, ``onehot_sample``,
  ``ms_deform_attn_onehot`` / ``_gather`` and the ``flat`` form against
  ``onehot_sample``, ``ms_deform_attn_pallas_onehot``,
  ``ms_deform_attn_pallas`` and ``ms_deform_attn_flat``;
- K5a: ``hat_sample_sparse`` through ``ms_deform_attn_hat(sparse=True)``
  against ``ms_deform_attn_pallas_hat(sparse=True)``, with S not a multiple
  of the 256-token chunk, Lq not a multiple of the 128-query block, points
  outside their level but within its support, 3 levels of P = 3 at D = 40
  (the shapes where the card kernel's slot layout matters), and a query
  block of NaN points; and the two known differences of the JAX kernel (ROADMAP Queue
  3), where the port equals ``ms_deform_attn_xla``;
- K5d/e: the tiled and separable entries against ``_hat_tiled`` and
  ``_hat_sep``;
- the flat family's autograd against ``jax.vjp(ms_deform_attn_flat)``, and
  a small LateFusion model under ``DFVOD_MSDA_IMPL=pallas_onehot`` against
  flax (its CPU default, ``xla``).

Inputs are made with numpy from seeds. Tolerance: f32 atol/rtol 1e-5 (the
same products, summed in another order); the model atol 1e-4 / rtol 1e-3,
the JAX package's full-model torch-parity tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.ops import msda as jm
from dfvod_tpu.ops import msda_pallas as jp
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models.layers import MSDeformAttn
from dfvod_tpu_torch.ops import corner_gather as cg
from dfvod_tpu_torch.ops import hat_sample as hs
from dfvod_tpu_torch.ops import msda
from dfvod_tpu_torch.ops import msda_forms as mf
from dfvod_tpu_torch.utils import trace
from dfvod_tpu_torch.utils.config import Config, ModelConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import assert_close, random_variables

# name: (spatial_shapes, B, Lq, M, D, P)
CASES = {
    "multilevel": (((6, 9), (3, 5)), 2, 37, 4, 16, 4),
    # S = 351, not a multiple of the 256-token chunk; Lq = 133, not a
    # multiple of the 128-query block
    "chunk_pad": (((13, 27),), 1, 133, 2, 8, 4),
    # where the layout of K5a's vector kernel matters: PL = 9, no power of
    # two (a query's slots hold idle ones), D = 40 (5 16-byte chunks in
    # bf16, 10 in f32) and Lq = 37, which no queries per warp divide
    "three_level_p3_d40": (((7, 9), (4, 5), (2, 3)), 1, 37, 2, 40, 3),
}


def make_inputs(case, seed=0):
    """value, loc U(-0.1, 1.1) and softmaxed attw as numpy f32: every point
    stays within its own level's support (the JAX hat kernels read another
    level only more than one row outside it)."""
    shapes, B, Lq, M, D, P = CASES[case]
    rng = np.random.default_rng(seed)
    S, L = sum(h * w for h, w in shapes), len(shapes)
    v = rng.standard_normal((B, S, M, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Lq, M, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, Lq, M, L * P))
    attw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return shapes, v, loc, attw.reshape(B, Lq, M, L, P).astype(np.float32)


def tt(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def jj(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_corner_indices_weights_match_jax():
    shapes, v, loc, attw = make_inputs("multilevel")
    ref_i, ref_w = jm.corner_indices_weights(shapes, *jj(loc, attw))
    idx, w = cg.corner_indices_weights(shapes, *tt(loc, attw))
    assert idx.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    assert_close(w, ref_w, atol=1e-5, rtol=1e-5)


def test_onehot_sample_matches_jax():
    """The generic weighted gather in the JAX package's (BM, S, D) layout,
    with indices outside [0, S) (they contribute 0); Lq = 133 pads the
    one-hot kernel's query block."""
    rng = np.random.default_rng(1)
    BM, S, D, Lq, K = 3, 50, 8, 133, 12
    v = rng.standard_normal((BM, S, D)).astype(np.float32)
    idx = rng.integers(-5, S + 5, (BM, Lq, K)).astype(np.int32)
    w = rng.standard_normal((BM, Lq, K)).astype(np.float32)
    ref = jp.onehot_sample(*jj(v, idx, w), interpret=True)
    before = trace.counter("corner_gather")
    got = cg.onehot_sample(*tt(v, idx, w))
    assert trace.counter("corner_gather") == before          # plain on the CPU
    assert got.shape == (BM, Lq, D)
    assert_close(got, ref, atol=1e-5, rtol=1e-5)
    inside = np.where((idx >= 0) & (idx < S), w, 0).astype(np.float32)
    assert_close(cg.onehot_sample(*tt(v, np.clip(idx, 0, S - 1), inside)),
                 ref, atol=1e-5, rtol=1e-5)


def jax_sparse(v, shapes, loc, attw):
    return jp.ms_deform_attn_pallas_hat(v, shapes, loc, attw, interpret=True,
                                        sparse=True)


# port entry -> the JAX function it is held against
FORMS = {
    "onehot": (mf.ms_deform_attn_onehot,
               lambda *a: jp.ms_deform_attn_pallas_onehot(*a, interpret=True)),
    "gather": (mf.ms_deform_attn_gather,
               lambda *a: jp.ms_deform_attn_pallas(*a, interpret=True)),
    "flat": (msda.ms_deform_attn_flat_plain, jm.ms_deform_attn_flat),
    "hat_sparse": (lambda *a: mf.ms_deform_attn_hat(*a, sparse=True),
                   jax_sparse),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("form", list(FORMS))
def test_form_matches_jax(form, case):
    port, ref_fn = FORMS[form]
    shapes, v, loc, attw = make_inputs(case)
    ref = ref_fn(jnp.asarray(v), shapes, *jj(loc, attw))
    got = port(*tt(v), shapes, *tt(loc, attw))
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert_close(got, ref, atol=1e-5, rtol=1e-5)


def own_level_edges(shapes, loc):
    """loc with a third of the points moved into (-1, 0) or (n-1, n) of
    their own level, or up to 1.5 pixels outside it: partial corners, or
    none, but never another level's rows."""
    loc = loc.copy()
    rng = np.random.default_rng(7)
    for lvl, (h, w) in enumerate(shapes):
        for c, n in ((0, w), (1, h)):
            px = rng.choice([-0.5, n - 0.3, -1.5, n + 0.5, -0.99],
                            loc[..., lvl, ::3, c].shape)
            loc[..., lvl, ::3, c] = (px + 0.5) / n
    return loc


def test_hat_sparse_at_the_edges_of_each_level():
    shapes, v, loc, attw = make_inputs("multilevel", seed=2)
    loc = own_level_edges(shapes, loc)
    ref = jax_sparse(jnp.asarray(v), shapes, *jj(loc, attw))
    got = mf.ms_deform_attn_hat(*tt(v), shapes, *tt(loc, attw), sparse=True)
    assert_close(got, ref, atol=1e-5, rtol=1e-5)
    assert_close(got, jm.ms_deform_attn_xla(jnp.asarray(v), shapes,
                                            *jj(loc, attw)),
                 atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("edges", [False, True],
                         ids=["inside", "own_level_edges"])
def test_hat_sparse_matches_jax_where_the_slot_layout_matters(edges):
    """K5a's plain version against ``ms_deform_attn_pallas_hat(sparse=
    True)`` at 3 levels, P = 3 and D = 40, with a third of the points at
    or past the edges of their own level or not; on the card the kernel is
    held against this plain version (``tests/test_torch_cuda.py``)."""
    shapes, v, loc, attw = make_inputs("three_level_p3_d40", seed=15)
    if edges:
        loc = own_level_edges(shapes, loc)
    ref = jax_sparse(jnp.asarray(v), shapes, *jj(loc, attw))
    got = mf.ms_deform_attn_hat(*tt(v), shapes, *tt(loc, attw), sparse=True)
    assert got.shape == ref.shape
    assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_hat_sparse_all_nan_query_block_gives_zero():
    """A 128-query block whose every point is NaN activates no chunk in
    the JAX kernel and gives 0; the port skips non-finite points and gives
    0 too. The other queries agree as usual."""
    shapes, v, loc, attw = make_inputs("chunk_pad", seed=3)
    loc[:, :128] = np.nan
    ref = np.asarray(jax_sparse(jnp.asarray(v), shapes, *jj(loc, attw)))
    got = mf.ms_deform_attn_hat(*tt(v), shapes, *tt(loc, attw), sparse=True)
    assert np.all(ref[:, :128] == 0)
    assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_known_difference_nan_point_in_an_active_block():
    """ROADMAP Queue 3: a NaN point in a query block that touches a chunk
    spreads NaN through the JAX kernel (``jnp.maximum(0, NaN)``); the port
    skips it and the query gets the sum of its finite points."""
    shapes, v, loc, attw = make_inputs("multilevel", seed=4)
    loc[0, 0, 0, 0, 0] = np.nan
    ref = np.asarray(jax_sparse(jnp.asarray(v), shapes, *jj(loc, attw)))
    got = mf.ms_deform_attn_hat(*tt(v), shapes, *tt(loc, attw),
                                sparse=True).numpy()
    assert np.isnan(ref[0, 0]).any()
    finite = attw.copy()
    finite[0, 0, 0, 0, 0] = 0.0
    clean = np.where(np.isnan(loc), 0.5, loc)
    want = mf.ms_deform_attn_hat(*tt(v), shapes, *tt(clean, finite),
                                 sparse=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_known_difference_level_crossing():
    """ROADMAP Queue 3: shapes ((8, 12), (4, 6)), one level-0 point at loc
    (0.5, 1.3), aw 1: py = 9.9 lies 2.9 rows below level 0, where the JAX
    hat kernels' stacked tent matrix reads level 1's first row (offset
    8 + 2). ``ms_deform_attn_xla``, K1 and the port's K5a give 0."""
    shapes = ((8, 12), (4, 6))
    rng = np.random.default_rng(5)
    v = rng.standard_normal((1, 8 * 12 + 4 * 6, 1, 4)).astype(np.float32)
    loc = np.full((1, 1, 1, 2, 1, 2), 0.5, np.float32)
    loc[0, 0, 0, 0, 0] = (0.5, 1.3)
    attw = np.zeros((1, 1, 1, 2, 1), np.float32)
    attw[0, 0, 0, 0, 0] = 1.0
    xla = np.asarray(jm.ms_deform_attn_xla(jnp.asarray(v), shapes,
                                           *jj(loc, attw)))
    jax_dense = np.asarray(jp.ms_deform_attn_pallas_hat(
        jnp.asarray(v), shapes, *jj(loc, attw), interpret=True))
    assert np.all(xla == 0)
    assert np.abs(np.asarray(jax_sparse(jnp.asarray(v), shapes,
                                        *jj(loc, attw)))).max() > 0.1
    assert np.abs(jax_dense).max() > 0.1
    for port in (mf.ms_deform_attn_hat(*tt(v), shapes, *tt(loc, attw),
                                       sparse=True),
                 mf.ms_deform_attn_hat(*tt(v), shapes, *tt(loc, attw)),
                 msda.ms_deform_attn_plain(*tt(v), shapes, *tt(loc, attw))):
        np.testing.assert_array_equal(port.numpy(), xla)


@pytest.mark.parametrize("form", ["tiled", "sep"])
def test_single_level_hat_forms_match_jax(form):
    """K5d/e's entries reach K1's function, held against ``_hat_tiled`` and
    ``_hat_sep``; both are single-level, as the JAX functions assert."""
    port, ref_fn = {
        "tiled": (mf.ms_deform_attn_hat_tiled,
                  jp.ms_deform_attn_pallas_hat_tiled),
        "sep": (mf.ms_deform_attn_hat_sep, jp.ms_deform_attn_pallas_hat_sep),
    }[form]
    shapes, v, loc, attw = make_inputs("chunk_pad", seed=6)
    ref = ref_fn(jnp.asarray(v), shapes, *jj(loc, attw), interpret=True)
    assert_close(port(*tt(v), shapes, *tt(loc, attw)), ref, atol=1e-5,
                 rtol=1e-5)
    shapes, v, loc, attw = make_inputs("multilevel")
    with pytest.raises(ValueError, match="single-level"):
        port(*tt(v), shapes, *tt(loc, attw))


# the JAX function each form names
JAX_FORMS = {
    "xla": jm.ms_deform_attn_xla,
    "flat": jm.ms_deform_attn_flat,
    "pallas": lambda *a: jp.ms_deform_attn_pallas(*a, interpret=True),
    "pallas_onehot": lambda *a: jp.ms_deform_attn_pallas_onehot(
        *a, interpret=True),
    "pallas_hat": lambda *a: jp.ms_deform_attn_pallas_hat(*a,
                                                          interpret=True),
}


@pytest.mark.parametrize("how", ["explicit", "env"])
@pytest.mark.parametrize("impl", list(JAX_FORMS))
def test_dispatch_matches_jax(monkeypatch, impl, how):
    """``ms_deform_attn(impl=...)`` and ``impl="auto"`` under
    ``DFVOD_MSDA_IMPL`` take the plain version of the form named, with no
    launch on the CPU."""
    shapes, v, loc, attw = make_inputs("multilevel", seed=8)
    ref = JAX_FORMS[impl](jnp.asarray(v), shapes, *jj(loc, attw))
    if how == "env":
        monkeypatch.setenv("DFVOD_MSDA_IMPL", impl)
    counts = (trace.counter("msda_fwd"), trace.counter("corner_gather"))
    got = msda.ms_deform_attn(*tt(v), shapes, *tt(loc, attw),
                              impl=impl if how == "explicit" else "auto")
    assert (trace.counter("msda_fwd"),
            trace.counter("corner_gather")) == counts
    assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_resolve_impl(monkeypatch):
    """Unset or unknown ``DFVOD_MSDA_IMPL`` is ``xla`` (the JAX package's
    choice off the TPU); an unknown explicit impl raises, in the module
    too."""
    monkeypatch.delenv("DFVOD_MSDA_IMPL", raising=False)
    assert msda.resolve_impl() == "xla"
    monkeypatch.setenv("DFVOD_MSDA_IMPL", "no_such_form")
    assert msda.resolve_impl("auto") == "xla"
    monkeypatch.setenv("DFVOD_MSDA_IMPL", "flat")
    assert msda.resolve_impl("auto") == "flat"
    assert msda.resolve_impl("pallas_hat") == "pallas_hat"
    shapes, v, loc, attw = make_inputs("multilevel")
    with pytest.raises(ValueError, match="unknown impl"):
        msda.ms_deform_attn(*tt(v), shapes, *tt(loc, attw), impl="cuda")
    attn = MSDeformAttn(64, 2, 4, 4, impl="bogus")
    with pytest.raises(ValueError, match="unknown impl"):
        attn(torch.zeros(1, 3, 64), torch.rand(1, 3, 2, 2),
             torch.zeros(1, 54 + 15, 64), shapes)


@pytest.mark.parametrize("impl", ["flat", "pallas", "pallas_onehot"])
def test_flat_family_autograd_matches_jax_vjp(impl):
    """On the CPU autograd differentiates the flat form's plain version:
    the VJP the JAX package takes for these forms (``jax.vjp`` of
    ``ms_deform_attn_flat``, ``_pallas_with_xla_grad``)."""
    shapes, v, loc, attw = make_inputs("multilevel", seed=9)
    go = np.random.default_rng(10).standard_normal(
        (v.shape[0], loc.shape[1], v.shape[2] * v.shape[3])).astype(
        np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jm.ms_deform_attn_flat(a, shapes, b, c),
                     *jj(v, loc, attw))
    refs = vjp(jnp.asarray(go))
    leaves = [t.requires_grad_() for t in tt(v, loc, attw)]
    msda.ms_deform_attn(leaves[0], shapes, *leaves[1:], impl=impl).backward(
        torch.from_numpy(go))
    for leaf, ref in zip(leaves, refs):
        assert_close(leaf.grad, ref, atol=1e-5, rtol=1e-5)


def test_gather_function_takes_k2_as_its_backward(monkeypatch):
    """``MSDeformAttnGatherFunction`` (K5b/c forward, K2 backward on the
    card), driven on CPU tensors with both kernel wrappers replaced by the
    plain versions: the forward gathers the folded corners, the backward
    asks K2 for the gradients ``needs_input_grad`` names, and both equal
    the flat form's autograd."""
    asked = []

    def bwd(value, shapes, loc, attw, go, needs):
        asked.append(tuple(needs))
        got = msda.ms_deform_attn_plain_bwd(value, shapes, loc, attw, go)
        return tuple(g if n else None for g, n in zip(got, needs))

    monkeypatch.setattr(msda, "corner_gather_cuda", cg.corner_gather_plain)
    monkeypatch.setattr(msda, "ms_deform_attn_bwd_cuda", bwd)
    shapes, v, loc, attw = make_inputs("multilevel", seed=11)
    go = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (v.shape[0], loc.shape[1], v.shape[2] * v.shape[3])).astype(
        np.float32))
    ref = [t.requires_grad_() for t in tt(v, loc, attw)]
    out_ref = msda.ms_deform_attn_flat_plain(ref[0], shapes, *ref[1:])
    out_ref.backward(go)
    leaves = [t.requires_grad_() for t in tt(v, loc, attw)]
    out = msda.MSDeformAttnGatherFunction.apply(leaves[0], shapes,
                                                *leaves[1:])
    torch.testing.assert_close(out, out_ref, atol=0, rtol=0)
    out.backward(go)
    assert asked == [(True, True, True)]
    for leaf, r in zip(leaves, ref):
        torch.testing.assert_close(leaf.grad, r.grad, atol=1e-5, rtol=1e-5)


def test_latefusion_under_pallas_onehot_matches_flax(monkeypatch):
    """A small LateFusion model with every MSDA layer in the one-hot form
    (``DFVOD_MSDA_IMPL=pallas_onehot``, set around the port's call only:
    JAX reads it at trace time) against flax with its CPU default
    (``xla``): logits and boxes of every decoder layer at atol 1e-4 / rtol
    1e-3; the port's 5 MSDA layers all take the flat form."""
    kw = dict(fusion_type="LateFusion", num_classes=3, num_queries=12,
              hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2,
              dim_feedforward=128, dropout=0.0, num_feature_levels=1)
    rng = np.random.default_rng(13)
    imgs = rng.integers(0, 256, (2, 96, 128, 4), dtype=np.uint8)
    sizes = np.array([[96, 128], [60, 84]])
    imgs[1, 60:] = 0
    imgs[1, :, 84:] = 0
    jmodel = j_build_model(JConfig(model=JModelConfig(**kw)))[0]
    x, mask = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), x, mask, train=False),
        seed=14)
    ref = jax.jit(lambda v, i, m: jmodel.apply(v, i, m, train=False))(
        variables, x, mask)
    model, _, _ = build_model(Config(model=ModelConfig(**kw)), device="cpu")
    load_jax_variables(model, variables)
    calls = []
    flat = msda.ms_deform_attn_flat_plain

    def spy(*a):
        calls.append(a[1])
        return flat(*a)

    monkeypatch.setattr(msda, "ms_deform_attn_flat_plain", spy)
    monkeypatch.setenv("DFVOD_MSDA_IMPL", "pallas_onehot")
    with torch.no_grad():
        out = model(*device_normalize(*tt(imgs, sizes)))
    monkeypatch.delenv("DFVOD_MSDA_IMPL")
    assert len(calls) == 1 + 2 + 2
    pairs = [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"]))
    for o, r in pairs:
        for k in ("pred_logits", "pred_boxes"):
            assert_close(o[k], r[k], atol=1e-4, rtol=1e-3, err_msg=k)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Checks that run before any launch: other devices; a gradient the
    kernels without a backward cannot give."""
    meta = torch.zeros((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        cg.corner_gather(meta, torch.zeros((1, 2, 1, 3), dtype=torch.int32,
                                           device="meta"),
                         torch.zeros((1, 2, 1, 3), device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        hs.hat_sample_sparse(torch.zeros((1, 4, 8), device="meta"),
                             ((2, 2),), *[torch.zeros((1, 3, 4),
                                                      device="meta")] * 3)
    v = torch.zeros((1, 4, 1, 8), requires_grad=True)
    idx = torch.zeros((1, 2, 1, 3), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        cg.corner_gather_cuda(v, idx, torch.zeros((1, 2, 1, 3)))
    pts = torch.zeros((1, 3, 4))
    with pytest.raises(RuntimeError, match="no backward kernel"):
        hs.hat_sample_sparse_cuda(v[:, :, 0], ((2, 2),), pts, pts, pts)
