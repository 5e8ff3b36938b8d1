"""K6's contract on the CPU: the port's plain fused bottleneck stage against
the JAX package's Pallas kernel ``_stage_pallas`` in interpret mode and its
``reference_stage``; ``Bottleneck.folded_weights`` against JAX's, in f32
and from the bf16-cast constants of serving; the stage's gradient against
``jax.grad`` of ``grad_stage``; and a small ``ResNet50(fused_stages=True)``
in bf16 eval against the port's f32 unfused ResNet.

Inputs and weights are made with numpy from seeds. Tolerances: the plain
stage bit-equal to both JAX forms (measured: the same f32 products and
bf16 rounding points give the same bits at these sizes); folding f32 rtol
2e-4 / atol 2e-3 (``tests/test_fused_bottleneck.py``'s own); gradients
atol/rtol 2e-2 (its own, bf16 throughout).
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.models.backbone_resnet import ResNetStage as JStage
from dfvod_tpu.ops import fused_bottleneck as jfb
from dfvod_tpu_torch.models import backbone_resnet as br
from dfvod_tpu_torch.ops import fused_bottleneck as fb
from dfvod_tpu_torch.utils import trace
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import assert_close, random_variables


def make_blocks(rng, cin, cm, nblocks=3):
    """Per block (w1, b1, w2, b2, w3, b3, wd, bd) as numpy f32, as
    ``tests/test_fused_bottleneck.py::make_blocks`` draws them."""
    blks = []
    for b in range(nblocks):
        c = cin if b == 0 else 4 * cm
        first = b == 0
        blks.append(tuple(None if a is None else np.asarray(a, np.float32)
                          for a in (
            rng.standard_normal((c, cm)) * .2, rng.standard_normal((cm,)),
            rng.standard_normal((3, 3, cm, cm)) * .2,
            rng.standard_normal((cm,)),
            rng.standard_normal((cm, 4 * cm)) * .2,
            rng.standard_normal((4 * cm,)),
            rng.standard_normal((c, 4 * cm)) * .2 if first else None,
            rng.standard_normal((4 * cm,)) if first else None)))
    return blks


def as_jax(blks):
    """Weights bf16, biases f32."""
    return tuple(tuple(None if a is None else jnp.asarray(
        a, jnp.bfloat16 if i % 2 == 0 else jnp.float32)
        for i, a in enumerate(b)) for b in blks)


def as_torch(blks):
    return [tuple(None if a is None else torch.from_numpy(a).to(
        torch.bfloat16 if i % 2 == 0 else torch.float32)
        for i, a in enumerate(b)) for b in blks]


# (x shape, Pallas row tile): the JAX test's shape, and H = 149 (prime: no
# tile divides it, so the Pallas kernel runs it as one strip)
STAGES = {"b2_16x24": ((2, 16, 24, 8), 8), "h149": ((1, 149, 10, 8), 149)}


@pytest.mark.parametrize("case", list(STAGES))
def test_plain_stage_matches_pallas_and_reference(case):
    """Border rows and columns included: conv zero padding must not pick up
    relu(b1). Through ``fused_bottleneck_stage`` on the CPU (no launch)."""
    shape, tr = STAGES[case]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    blks = make_blocks(rng, 8, 8)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jfb.reference_stage(xj, as_jax(blks)), np.float32)
    pallas = np.asarray(jfb._stage_pallas(xj, as_jax(blks), TR=tr,
                                          interpret=True), np.float32)
    before = trace.counter("fused_bottleneck")
    got = fb.fused_bottleneck_stage(torch.from_numpy(x).bfloat16(),
                                    as_torch(blks))
    assert trace.counter("fused_bottleneck") == before
    assert got.dtype == torch.bfloat16 and got.shape == shape[:3] + (32,)
    np.testing.assert_array_equal(got.float().numpy(), ref)
    np.testing.assert_array_equal(got.float().numpy(), pallas)
    plain = fb.fused_stage_plain(torch.from_numpy(x).bfloat16(),
                                 as_torch(blks))
    torch.testing.assert_close(plain, got, atol=0, rtol=0)


def stage_grads(x, blks, dtype):
    """Gradients of sum(stage(x)) in ``dtype`` ("f32" or "bf16") of x and
    every tensor of ``blks`` (weights in ``dtype``, biases f32): JAX's
    (``jax.grad`` of ``grad_stage``) and the port's (through
    ``fused_bottleneck_stage``), as lists of numpy f32, and the port's
    dtypes."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jw = tuple(tuple(None if a is None else a.astype(jdt) if a.ndim > 1
                     else a for a in b) for b in as_jax(blks))

    def loss(xx, ww):
        return jnp.sum(jfb.grad_stage(xx, ww).astype(jnp.float32))

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x, jdt), jw)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = [tuple(None if t is None else (t.to(tdt) if t.dim() > 1 else t
                                        ).requires_grad_() for t in b)
          for b in as_torch(blks)]
    fb.fused_bottleneck_stage(xt, wt).float().sum().backward()
    leaves = [xt] + [t for b in wt for t in b if t is not None]
    ref = [gx] + [g for b in gw for g in b if g is not None]
    assert all(t.grad.dtype == t.dtype for t in leaves)
    return ([np.asarray(g, np.float32) for g in ref],
            [t.grad.float().numpy() for t in leaves],
            [t.dtype for t in leaves])


def test_stage_gradient_matches_jax_grad_stage():
    """The ``autograd.Function``'s backward is autograd through the unfused
    ``grad_stage``, as the JAX package's ``custom_vjp``: the gradients of x
    and every weight against ``jax.grad`` of ``grad_stage``. In f32 atol /
    rtol 1e-4. In bf16, the serving dtype, the weights' and x's within 2e-2
    in relative L2 norm (the JAX test's number; measured equal). The f32
    biases' gradients are sums over every position of a bf16 cotangent,
    which XLA rounds at other points than PyTorch: each must lie as close
    to the f32 gradient as JAX's bf16 one does, or within 2e-2 of it
    (measured: JAX 2.0e-3-4.0e-2 from it, the port 2.0e-3-1.8e-2)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
    blks = make_blocks(rng, 8, 8, nblocks=2)
    ref32, got32, _ = stage_grads(x, blks, "f32")
    assert len(got32) == 1 + 8 + 6
    for g, r in zip(got32, ref32):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)
    ref16, got16, dtypes = stage_grads(x, blks, "bf16")

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for g, r, r32, dt in zip(got16, ref16, ref32, dtypes):
        if dt == torch.bfloat16:
            assert rel(g, r) <= 2e-2, (g.shape, rel(g, r))
        else:
            assert rel(g, r32) <= max(rel(r, r32), 2e-2), (
                g.shape, rel(g, r32), rel(r, r32))


def stage_pair(seed=3):
    """A JAX ``ResNetStage(64, 3, 1)`` (layer1's shape) with random
    variables, constants included, and the port's stage holding them."""
    x = np.zeros((1, 8, 8, 64), np.float32)
    js = JStage(64, 3, 1, allow_fused=False)
    v = random_variables(lambda: js.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x)), seed=seed)
    return js, v, load_jax_variables(br.ResNetStage(64, 3, 1), v).eval()


def jax_folds(js, v, dtype):
    """Every block's ``folded_weights(dtype)``, under ``jax.jit`` as the
    model folds them, or eagerly."""
    def folds(m):
        return [getattr(m, f"block_{i}").folded_weights(dtype)
                for i in range(3)]
    return jax.jit(nn.apply(folds, js))(v), nn.apply(folds, js)(v)


def test_folded_weights_match_jax_in_f32():
    js, v, stage = stage_pair()
    ref, _ = jax_folds(js, v, jnp.float32)
    for i in range(3):
        got = getattr(stage, f"block_{i}").folded_weights(torch.float32)
        for g, r in zip(got, ref[i]):
            assert (g is None) == (r is None)
            if g is not None:
                assert g.dtype == torch.float32 and g.is_contiguous()
                assert_close(g.detach(), r, atol=2e-3, rtol=2e-4)


def test_folded_weights_fold_the_bf16_serving_constants_as_jax():
    """In bf16 serving the JAX package casts every f32 variable, the
    FrozenBN constants included, to bf16 before folding (``bench.py``,
    ``cli/inference.py``), and ``Server`` casts every buffer alike. Folded
    from those constants in the stored dtype, the port equals JAX's
    expression evaluated op by op bit for bit; under ``jax.jit`` XLA keeps
    some intermediates in f32, which moves an entry by at most one bf16
    step (rtol 2^-7, atol 2^-9 where the bias cancels). Folding from the
    f32 constants gives other values."""
    js, v, stage = stage_pair()
    vb = jax.jit(lambda t: jax.tree_util.tree_map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
        t))(v)
    jitted, eager = jax_folds(js, vb, jnp.bfloat16)
    from_f32, _ = jax_folds(js, v, jnp.bfloat16)
    stage16 = stage.to(torch.bfloat16)
    far = 0.0
    for i in range(3):
        got = getattr(stage16, f"block_{i}").folded_weights(torch.bfloat16)
        for g, r, e, f in zip(got, jitted[i], eager[i], from_f32[i]):
            if g is None:
                continue
            g = g.detach().float().numpy()
            np.testing.assert_array_equal(g, np.asarray(e, np.float32))
            np.testing.assert_allclose(g, np.asarray(r, np.float32),
                                       rtol=2.0 ** -7, atol=2.0 ** -9)
            far = max(far, float(np.abs(g - np.asarray(f, np.float32)).max()))
    assert far > 0


def test_resnet50_fused_layer1_bf16_against_f32():
    """A small ``ResNet50(fused_stages=True)`` in bf16 eval: layer1 takes
    the fused stage (its NHWC view contiguous, as channels-last
    activations give it, so K6 needs no copy); the stage outputs against
    the port's f32 unfused ResNet within bf16's reach (relative L2 3e-2),
    and the fused stage is not taken in train mode or with
    ``fused_stages`` off."""
    torch.manual_seed(0)
    ref = br.ResNet50(return_stages=(1, 2)).eval()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, br.FrozenBatchNorm):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    model = br.ResNet50(return_stages=(1, 2), fused_stages=True).eval()
    model.load_state_dict(ref.state_dict())
    model = model.to(dtype=torch.bfloat16, memory_format=torch.channels_last)
    seen = []
    real = br.fused_bottleneck_stage

    def spy(x, weights):
        seen.append(x.is_contiguous())
        return real(x, weights)

    x = torch.randn(2, 64, 96, 3)
    br.fused_bottleneck_stage = spy
    try:
        with torch.no_grad():
            want = ref(x)
            got = model(x.bfloat16())
            assert seen == [True]
            model.fused_stages = False
            unfused = model(x.bfloat16())
            model.fused_stages = True
            model.train()
            model(x.bfloat16())
    finally:
        br.fused_bottleneck_stage = real
    assert seen == [True]
    for s in (1, 2):
        assert got[s].dtype == torch.bfloat16
        err = float((got[s].float() - want[s]).norm() / want[s].norm())
        assert err < 3e-2, (s, err)
        assert not torch.equal(got[s], unfused[s])
        err = float((unfused[s].float() - want[s]).norm() / want[s].norm())
        assert err < 3e-2, (s, err)


def test_stage_fold_is_reused_until_a_weight_changes(monkeypatch):
    """Serving folds the stage once: with autograd off, the stage's fold is
    reused while its weights and FrozenBN constants stay as they were, and
    folded again after an in-place write, ``load_state_dict`` or ``.to()``,
    equal to a fresh fold each time. With autograd on it folds every
    call."""
    calls = []
    real = br.Bottleneck.folded_weights

    def counting(self, dtype):
        calls.append(dtype)
        return real(self, dtype)

    monkeypatch.setattr(br.Bottleneck, "folded_weights", counting)
    _, _, stage = stage_pair()
    _, _, other = stage_pair(seed=4)
    stage = stage.to(torch.bfloat16)
    bf = torch.bfloat16

    def fresh(s):
        return [real(getattr(s, f"block_{i}"), bf) for i in range(3)]

    def same(a, b):
        return all((x is None and y is None) or torch.equal(x, y)
                   for blk_a, blk_b in zip(a, b) for x, y in zip(blk_a, blk_b))

    x = torch.randn(1, 64, 6, 5).bfloat16().contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        first = stage.folded_weights(bf)
        y = stage(x)
        assert stage.folded_weights(bf) is first and len(calls) == 3
        assert torch.equal(stage(x), y) and len(calls) == 3
        stage.block_1.bn2.running_var.mul_(2.0)
        second = stage.folded_weights(bf)
        assert second is not first and len(calls) == 6
        assert same(second, fresh(stage)) and not same(second, first)
        stage.load_state_dict(other.to(bf).state_dict())
        assert same(stage.folded_weights(bf), fresh(other)) and len(calls) == 9
        stage.to(torch.float32).to(bf)
        stage.folded_weights(bf)
        assert len(calls) == 12
    stage.folded_weights(bf)
    stage.folded_weights(bf)
    assert len(calls) == 18


def test_stage_fold_keeps_one_slot_across_dtypes(monkeypatch):
    """The stage keeps one fold: asked in another dtype it folds again in
    that dtype, and asked back in the first it folds again, each equal to
    a fresh fold."""
    calls = []
    real = br.Bottleneck.folded_weights

    def counting(self, dtype):
        calls.append(dtype)
        return real(self, dtype)

    monkeypatch.setattr(br.Bottleneck, "folded_weights", counting)
    _, _, stage = stage_pair()
    bf = torch.bfloat16
    with torch.no_grad():
        for dtype, n in ((bf, 3), (bf, 3), (torch.float32, 6), (bf, 9)):
            got = stage.folded_weights(dtype)
            assert len(calls) == n and got[0][0].dtype == dtype
            for blk, i in zip(got, range(3)):
                want = real(getattr(stage, f"block_{i}"), dtype)
                assert all((a is None and b is None) or torch.equal(a, b)
                           for a, b in zip(blk, want))


def test_kernel_wrapper_refuses_what_k6_does_not_take():
    """Checks that run before any launch: a non-contiguous NHWC view (K6
    reads no strides), an f32 input, channels not in multiples of 16, a
    weight not in bf16."""
    rng = np.random.default_rng(4)
    blks = as_torch(make_blocks(rng, 16, 16, nblocks=1))
    x = torch.zeros((1, 6, 5, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fb.fused_stage_cuda(x.transpose(1, 2), blks)
    with pytest.raises(TypeError, match="bf16"):
        fb.fused_stage_cuda(x.float(), blks)
    odd = as_torch(make_blocks(rng, 8, 8, nblocks=1))
    with pytest.raises(ValueError, match="multiples of 16"):
        fb.fused_stage_cuda(torch.zeros((1, 6, 5, 8), dtype=torch.bfloat16),
                            odd)
    w1, *rest = blks[0]
    with pytest.raises(ValueError, match="block tensor 0"):
        fb.fused_stage_cuda(x, [(w1.float(), *rest)])
    with pytest.raises(ValueError, match="cpu or cuda"):
        fb.fused_bottleneck_stage(x.to("meta"), blks)
