"""The one-pass FrozenBN epilogue (``dfvod_tpu_torch/ops/frozen_bn_act.py``)
on the CPU: its plain version against the unfused chain it replaces, its
rounding, its hand-written backward against autograd and ``gradcheck``,
the ResNet blocks that call it against the JAX package's, the fold kept
between calls, and how often a ResNet-50 forward makes the pass.

Forms: the residual ``none``, ``identity`` (``+ r``) or ``affine`` (``+ r
* sr + br``, the downsample's FrozenBN'd conv), each with and without
ReLU. Tolerances: the f32 chain atol 1e-6 (measured bitwise: the same
products and sums in the same order); bf16 against the f64 result rounded
once, exactly, on inputs whose f32 sums are exact; the backward against
autograd through the plain version exactly (the same f32 products);
blocks against flax atol 1e-4 / rtol 1e-3, ``tests/test_torch_modules.py``'s
single-layer tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.models import backbone_resnet as j_resnet
from dfvod_tpu_torch.models import backbone_resnet as br
from dfvod_tpu_torch.ops import frozen_bn_act as fba
from dfvod_tpu_torch.ops import quant
from dfvod_tpu_torch.utils import trace
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import assert_close, t2n

FORMS = ("none", "identity", "affine")
LAYOUTS = ("nchw", "nhwc")


def case(form, dtype=torch.float32, layout="nchw", shape=(2, 16, 5, 6),
         seed=0):
    """(x, scale, bias, residual, res_scale, res_bias) of ``form``: x and
    the residual in ``dtype`` and ``layout``, the constants f32 (f64 for
    f64)."""
    gen = torch.Generator().manual_seed(seed)
    C = shape[1]
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    fmt = (torch.channels_last if layout == "nhwc"
           else torch.contiguous_format)

    def act():
        return torch.randn(shape, generator=gen).to(dtype).contiguous(
            memory_format=fmt)

    def const(lo, hi):
        return (torch.rand(C, generator=gen) * (hi - lo) + lo).to(acc)

    x, s, b = act(), const(0.5, 1.5), const(-0.5, 0.5)
    r = sr = rb = None
    if form != "none":
        r = act()
    if form == "affine":
        sr, rb = const(0.5, 1.5), const(-0.5, 0.5)
    return x, s, b, r, sr, rb


def unfused_chain(x, s, b, r, sr, rb, relu):
    """The passes the epilogue replaces, as ``FrozenBatchNorm.forward``,
    ``Bottleneck.forward`` and the stem ran them: each in x's dtype."""
    def bn(t, scale, bias):
        return (t * scale.to(t.dtype)[None, :, None, None]
                + bias.to(t.dtype)[None, :, None, None])
    y = bn(x, s, b)
    if r is not None:
        y = y + (r if sr is None else bn(r, sr, rb))
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("form", FORMS)
def test_plain_matches_the_unfused_chain_f32(form, relu, layout):
    x, s, b, r, sr, rb = case(form, layout=layout)
    got = fba.frozen_bn_act(x, s, b, r, sr, rb, relu=relu)
    want = unfused_chain(x, s, b, r, sr, rb, relu)
    assert got.dtype == torch.float32 and got.stride() == x.stride()
    assert_close(got, want, atol=1e-6, rtol=0)
    if relu:
        assert bool((got == 0).any()) and bool((got >= 0).all())


def grid_case(form, seed):
    """Inputs on grids whose f32 products and sums are exact: x, r = k/16
    (|k| < 128), the scales j/128 in [0.5, 2), the biases m/64 (|m| <
    128), each a bf16 value; every sum is a multiple of 2^-11 below 2^6."""
    gen = torch.Generator().manual_seed(seed)
    shape, C = (2, 24, 7, 5), 24

    def ints(lo, hi, n):
        return torch.randint(lo, hi, n, generator=gen).double()
    x = ints(-127, 128, shape) / 16
    s, b = ints(64, 256, (C,)) / 128, ints(-127, 128, (C,)) / 64
    r = sr = rb = None
    if form != "none":
        r = ints(-127, 128, shape) / 16
    if form == "affine":
        sr, rb = ints(64, 256, (C,)) / 128, ints(-127, 128, (C,)) / 64
    return x, s, b, r, sr, rb


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("form", FORMS)
def test_bf16_result_is_the_f64_result_rounded_once(form, relu):
    """The bf16 pass equals the f64 pass rounded to bf16 once, where the
    unfused bf16 chain (rounding after each multiply and add) does not."""
    x, s, b, r, sr, rb = grid_case(form, seed=3)
    bf = torch.bfloat16

    def f32(t):
        return None if t is None else t.float()

    def as_bf16(t):
        return None if t is None else t.to(bf)
    got = fba.frozen_bn_act(x.to(bf), f32(s), f32(b), as_bf16(r), f32(sr),
                            f32(rb), relu=relu)
    exact = fba.frozen_bn_act(x, s, b, r, sr, rb, relu=relu)
    assert got.dtype == bf and exact.dtype == torch.float64
    assert torch.equal(got, exact.to(bf))
    chain = unfused_chain(x.to(bf), s.to(bf), b.to(bf), as_bf16(r),
                          as_bf16(sr), as_bf16(rb), relu)
    assert not torch.equal(chain, got)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("form", FORMS)
def test_gradcheck_f64(form, relu):
    x, s, b, r, sr, rb = case(form, torch.float64, shape=(2, 3, 4, 5))
    x.requires_grad_()
    inputs = [x]
    if r is not None:
        r.requires_grad_()
        inputs.append(r)

    def fn(*ts):
        return fba.frozen_bn_act(ts[0], s, b, ts[1] if len(ts) > 1 else None,
                                 sr, rb, relu=relu)
    assert torch.autograd.gradcheck(fn, inputs, eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("form", FORMS)
def test_backward_equals_autograd_of_the_plain_version(form, relu, dtype):
    """The hand-written backward (``frozen_bn_act_bwd_plain``, the kernel's
    arithmetic) against autograd through ``frozen_bn_act_plain``,
    exactly, in f32 and bf16; the counter ``frozen_bn_act_bwd`` counts
    one pass per backward."""
    dt = getattr(torch, dtype)
    x, s, b, r, sr, rb = case(form, dt, layout="nhwc", seed=5)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)
                    ).to(dt)
    leaves = [t.detach().requires_grad_() for t in (x, r) if t is not None]

    def grads(fn):
        ls = [t.detach().clone().requires_grad_() for t in leaves]
        y = fn(ls[0], s, b, ls[1] if len(ls) > 1 else None, sr, rb,
               relu=relu)
        return torch.autograd.grad(y, ls, g)

    before = trace.counter("frozen_bn_act_bwd")
    got = grads(fba.frozen_bn_act)
    assert trace.counter("frozen_bn_act_bwd") == before + 1
    want = grads(fba.frozen_bn_act_plain)
    for a, w in zip(got, want):
        assert a.dtype == dt
        assert torch.equal(a, w)


def test_the_function_records_only_where_autograd_does():
    """Under ``no_grad`` or on inputs that need no gradient the pass makes
    no graph node; with ReLU the node saves the output, without it saves
    none."""
    x, s, b, r, _, _ = case("identity")
    with torch.no_grad():
        assert fba.frozen_bn_act(x.requires_grad_(), s, b, r).grad_fn is None
    assert fba.frozen_bn_act(x.detach(), s, b, r).grad_fn is None
    y = fba.frozen_bn_act(x, s, b, r, relu=True)
    assert type(y.grad_fn).__name__ == "FrozenBNActFunctionBackward"
    assert y.grad_fn.saved_tensors[0] is not None
    assert torch.equal(y.grad_fn.saved_tensors[0], y)
    y = fba.frozen_bn_act(x, s, b, r, relu=False)
    assert y.grad_fn.saved_tensors[0] is None


def test_refusals():
    x, s, b, r, sr, rb = case("affine")
    with pytest.raises(ValueError, match="come together"):
        fba.frozen_bn_act(x, s, b, None, sr, rb)
    with pytest.raises(ValueError, match="come together"):
        fba.frozen_bn_act(x, s, b, r, sr, None)
    with pytest.raises(TypeError, match="one dtype"):
        fba.frozen_bn_act(x, s, b, r.double())
    with pytest.raises(ValueError, match="no gradient"):
        fba.frozen_bn_act(x, s.clone().requires_grad_(), b)


def test_memory_orders_the_kernel_takes():
    """``_inner``: 1 for NHWC memory, H * W for NCHW; a transposed view
    raises, as the CUDA wrapper does before any launch."""
    x = torch.zeros(2, 8, 3, 5)
    assert fba._inner(x) == 15
    assert fba._inner(x.contiguous(memory_format=torch.channels_last)) == 1
    assert fba._inner(torch.zeros(2, 8, 1, 1)) == 1
    with pytest.raises(ValueError, match="memory"):
        fba._inner(x.transpose(2, 3))
    with pytest.raises(ValueError, match="4-d"):
        fba._inner(torch.zeros(8, 15))


# ------------------------------------------------------------ the blocks
def bottleneck_pair(x, stride, downsample, seed):
    """(flax Bottleneck, its variables with random FrozenBN constants, the
    port's Bottleneck with the same weights)."""
    rng = np.random.default_rng(seed)
    blk = j_resnet.Bottleneck(64, 16, stride=stride, downsample=downsample)
    v = jax.jit(lambda k: blk.init(k, x))(jax.random.PRNGKey(seed))
    v = jax.tree_util.tree_map(np.asarray, v)
    v["constants"] = jax.tree_util.tree_map(
        lambda t: rng.uniform(0.5, 1.5, t.shape).astype(np.float32),
        v["constants"])
    port = load_jax_variables(
        br.Bottleneck(64, 16, stride=stride, downsample=downsample), v)
    return blk, v, port.eval()


@pytest.mark.parametrize("stride,downsample", [(1, False), (2, True)])
def test_bottleneck_matches_jax(stride, downsample):
    """Forward and the input's gradient (a random cotangent) against
    flax's ``Bottleneck``: the three passes (bn1 + ReLU, bn2 + ReLU, bn3 +
    identity or the downsample's FrozenBN + ReLU) and their backward."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 9, 10, 64)) * 0.5).astype(np.float32)
    blk, v, port = bottleneck_pair(jnp.asarray(x), stride, downsample, 12)
    jy, vjp = jax.vjp(lambda t: blk.apply(v, t), jnp.asarray(x))
    gy = rng.standard_normal(jy.shape).astype(np.float32)
    (jgx,) = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    before = trace.counters()
    y = port(xt)
    (gx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy).permute(0, 3, 1,
                                                                    2))
    after = trace.counters()
    assert after["frozen_bn_act"] - before.get("frozen_bn_act", 0) == 3
    assert (after["frozen_bn_act_bwd"]
            - before.get("frozen_bn_act_bwd", 0)) == 3
    assert_close(y.permute(0, 2, 3, 1), jy, atol=1e-4, rtol=1e-3)
    assert_close(gx.permute(0, 2, 3, 1), jgx, atol=1e-4, rtol=1e-3)


def test_block_paths_equal_the_unfused_chain():
    """A ``Bottleneck`` (with downsample and without) and the ResNet-18's
    ``BasicBlock`` give the unfused chain's f32 outputs bitwise, the
    residual added as the unfused code added it."""
    from dfvod_tpu_torch.models.research import BasicBlock
    torch.manual_seed(13)
    x = torch.randn(2, 64, 9, 10)
    for blk in (br.Bottleneck(64, 16), br.Bottleneck(64, 32, 2, 1, True),
                BasicBlock(64, 64), BasicBlock(64, 128, 2, True)):
        for m in blk.modules():
            if isinstance(m, br.FrozenBatchNorm):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)

        def bn(name, t):
            return unfused_chain(t, *getattr(blk, name).fold(), None, None,
                                 None, False)
        with torch.no_grad():
            out = torch.relu(bn("bn1", blk.conv1(x)))
            if isinstance(blk, br.Bottleneck):
                out = torch.relu(bn("bn2", blk.conv2(out)))
                out = bn("bn3", blk.conv3(out))
            else:
                out = bn("bn2", blk.conv2(out))
            idn = (bn("downsample_bn", blk.downsample_conv(x))
                   if blk.downsample else x)
            want = torch.relu(out + idn)
            assert torch.equal(blk(x), want)


# ------------------------------------------------- the fold and the count
def test_fold_is_kept_until_a_buffer_changes():
    """``FrozenBatchNorm.folded`` folds once per buffer state and dtype,
    with autograd on too, and again after an in-place write,
    ``load_state_dict`` or ``.to()``; each equals a fresh fold cast to the
    dtype."""
    bn = br.FrozenBatchNorm(8)
    with torch.no_grad():
        bn.running_var.uniform_(0.5, 1.5)
        bn.weight.uniform_(0.5, 1.5)

    def fresh(dtype):
        return tuple(t.to(dtype).float() for t in bn.fold())

    first = bn.folded(torch.float32)
    assert bn.folded(torch.float32) is first
    assert all(torch.equal(a, w) for a, w in zip(first, fresh(torch.float32)))
    half = bn.folded(torch.bfloat16)
    assert half is not first and half[0].dtype == torch.float32
    assert all(torch.equal(a, w) for a, w in zip(half,
                                                 fresh(torch.bfloat16)))
    assert bn.folded(torch.bfloat16) is half
    with torch.no_grad():
        bn.running_mean.add_(1.0)
    again = bn.folded(torch.bfloat16)
    assert again is not half
    assert all(torch.equal(a, w) for a, w in zip(again,
                                                 fresh(torch.bfloat16)))
    other = br.FrozenBatchNorm(8)
    bn.load_state_dict(other.state_dict())
    assert bn.folded(torch.bfloat16) is not again
    bn.to(torch.float64)
    s, _ = bn.folded(torch.float64)
    assert s.dtype == torch.float64


def test_a_fold_made_in_inference_mode_is_not_saved_for_backward():
    """A block served under ``inference_mode`` and then trained refolds:
    autograd cannot save the inference tensors of the first fold."""
    torch.manual_seed(15)
    blk = br.Bottleneck(64, 16, 1, 1, True)
    x = torch.randn(1, 64, 6, 5)
    with torch.inference_mode():
        served = blk(x)
        assert blk.bn3.folded(torch.float32)[0].is_inference()
    y = blk(x)
    y.sum().backward()
    assert torch.equal(y.detach(), served)
    assert blk.conv1.weight.grad is not None


def resnet(**kw):
    torch.manual_seed(14)
    return br.ResNet50(dilation=True, return_stages=(4,), **kw).eval()


def passes(fn):
    before = trace.counter("frozen_bn_act")
    fn()
    return trace.counter("frozen_bn_act") - before


def test_passes_per_resnet50_forward():
    """49 passes a ResNet-50 forward (the stem and 3 per bottleneck), with
    autograd on and off; 40 with ``fused_stages`` in bf16 eval (layer1 on
    the fused stage); 1 in int8 mode (the stem: every bottleneck takes its
    int8 path); and 49 backward passes a training step's backward."""
    x = torch.randn(1, 32, 32, 3)
    net = resnet()
    with torch.no_grad():
        assert passes(lambda: net(x)) == 49
        with quant.int8_mode():
            assert passes(lambda: net(x)) == 1
    out = {}
    assert passes(lambda: out.update(net(x))) == 49
    before = trace.counter("frozen_bn_act_bwd")
    out[4].sum().backward()
    assert trace.counter("frozen_bn_act_bwd") - before == 49
    fused = resnet(fused_stages=True).to(torch.bfloat16)
    with torch.no_grad():
        assert passes(lambda: fused(x.bfloat16())) == 40
