"""The port's MSDA backward against the JAX package.

``ms_deform_attn_plain_bwd`` (autograd through the plain version) is the
CPU counterpart of the CUDA kernel ``csrc/msda_bwd.cu``. It is held to
``jax.vjp`` of ``ms_deform_attn_xla`` and of ``ms_deform_attn_flat``, and to
the TPU kernel ``ms_deform_attn_pallas_hat_bwd`` run in interpret mode with
both derivative variants, at f32 atol 1e-4 / rtol 1e-4 (sums in another
order; the Pallas kernel contracts through f32 dots). A bf16 value is held
at rtol 2e-2 / atol 3e-2, the JAX package's own gate for its bf16 backward
(``msda_pallas.py:1363-1368``): grad_loc scales with the level size, so
bf16 rounding is relative. Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.ops.msda import ms_deform_attn_flat, ms_deform_attn_xla
from dfvod_tpu.ops.msda_pallas import ms_deform_attn_pallas_hat_bwd
from dfvod_tpu_torch.ops import msda

# (spatial_shapes, B, Lq, M, D, P): multi-level with D=24 (not a multiple
# of a warp), a single level with Lq=300 (padded to the Pallas query
# block), three levels with D above one warp
CASES = {
    "multi_d24": (((7, 9), (4, 5)), 2, 37, 3, 24, 2),
    "padded_lq300": (((6, 8),), 1, 300, 2, 8, 4),
    "three_level_d40": (((5, 6), (3, 3), (2, 2)), 1, 29, 2, 40, 3),
}
# power-of-two levels, so that loc * W - 0.5 lands exactly on integers
INTEGER_SHAPES = ((8, 16), (4, 4))


def make_inputs(shapes, B, Lq, M, D, P, seed=0):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, S, M, D)).astype(np.float32)
    loc = rng.uniform(-0.1, 1.1, (B, Lq, M, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, Lq, M, L * P))
    attw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    go = rng.standard_normal((B, Lq, M * D)).astype(np.float32)
    return value, loc, attw.reshape(B, Lq, M, L, P).astype(np.float32), go


def integer_pixel_loc(shapes, B, Lq, M, P, seed=0):
    """Every sample on an integer pixel, one pixel beyond each edge
    included: px = k exactly for k in -1..W."""
    rng = np.random.default_rng(seed)
    loc = np.empty((B, Lq, M, len(shapes), P, 2), np.float32)
    for lvl, (h, w) in enumerate(shapes):
        for c, n in ((0, w), (1, h)):
            k = rng.integers(-1, n + 1, (B, Lq, M, P))
            loc[:, :, :, lvl, :, c] = (k + 0.5) / n
    return loc


def port_bwd(value, shapes, loc, attw, go):
    value, loc, attw, go = (torch.from_numpy(a) for a in
                            (value, loc, attw, go))
    grads = msda.ms_deform_attn_bwd(value, shapes, loc, attw, go)
    return [g.float().numpy() for g in grads]


def jax_vjp(fn, value, shapes, loc, attw, go):
    _, vjp = jax.vjp(lambda v, lc, a: fn(v, shapes, lc, a),
                     jnp.asarray(value), jnp.asarray(loc),
                     jnp.asarray(attw))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(go))]


def assert_grads(got, ref, atol, rtol, what):
    for g, r, name in zip(got, ref, ("value", "loc", "attw")):
        assert g.shape == r.shape, (what, name)
        np.testing.assert_allclose(g, r, atol=atol, rtol=rtol,
                                   err_msg=f"{what} grad_{name}")


@pytest.mark.parametrize("fn", [ms_deform_attn_xla, ms_deform_attn_flat],
                         ids=["xla", "flat"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_bwd_matches_jax_vjp(case, fn):
    shapes, *dims = CASES[case]
    value, loc, attw, go = make_inputs(shapes, *dims)
    assert_grads(port_bwd(value, shapes, loc, attw, go),
                 jax_vjp(fn, value, shapes, loc, attw, go), 1e-4, 1e-4,
                 f"{case} vs {fn.__name__}")


@pytest.mark.parametrize("deriv", ["vpu", "mxu"])
@pytest.mark.parametrize("case", ["multi_d24", "padded_lq300"])
def test_plain_bwd_matches_pallas_hat_bwd_interpret(case, deriv):
    shapes, *dims = CASES[case]
    value, loc, attw, go = make_inputs(shapes, *dims, seed=1)
    ref = ms_deform_attn_pallas_hat_bwd(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attw),
        jnp.asarray(go), interpret=True, deriv=deriv)
    assert_grads(port_bwd(value, shapes, loc, attw, go),
                 [np.asarray(g) for g in ref], 1e-4, 1e-4,
                 f"{case} vs pallas {deriv}")


@pytest.mark.parametrize("deriv", ["vpu", "mxu"])
def test_integer_pixels_take_the_one_sided_difference(deriv):
    """At an exactly integer px the derivative is [floor+1] - [floor]: the
    plain backward agrees with the Pallas kernel, which takes that
    difference by construction, and with the XLA gather's VJP; and with
    grad_loc computed by hand from the corner rows."""
    shapes = INTEGER_SHAPES
    B, Lq, M, D, P = 1, 24, 2, 8, 2
    value, _, attw, go = make_inputs(shapes, B, Lq, M, D, P, seed=2)
    loc = integer_pixel_loc(shapes, B, Lq, M, P, seed=3)
    got = port_bwd(value, shapes, loc, attw, go)
    ref = ms_deform_attn_pallas_hat_bwd(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attw),
        jnp.asarray(go), interpret=True, deriv=deriv)
    assert_grads(got, [np.asarray(g) for g in ref], 1e-4, 1e-4,
                 f"integer px vs pallas {deriv}")
    assert_grads(got, jax_vjp(ms_deform_attn_xla, value, shapes, loc, attw,
                              go), 1e-4, 1e-4, "integer px vs xla")

    # by hand, level 0, x direction: fx = fy = 0, so the derivative is
    # aw * W * go . (v[y, x+1] - v[y, x]) with zeros outside the map
    h, w = shapes[0]
    v0 = value[:, :h * w].reshape(B, h, w, M, D)
    want = np.zeros((B, Lq, M, P), np.float32)
    for b, q, m, p in np.ndindex(B, Lq, M, P):
        x = int(round(loc[b, q, m, 0, p, 0] * w - 0.5))
        y = int(round(loc[b, q, m, 0, p, 1] * h - 0.5))

        def at(yy, xx):
            inside = 0 <= yy < h and 0 <= xx < w
            return v0[b, yy, xx, m] if inside else np.zeros(D, np.float32)
        diff = at(y, x + 1) - at(y, x)
        g = go[b, q, m * D:(m + 1) * D]
        want[b, q, m, p] = attw[b, q, m, 0, p] * w * float(g @ diff)
    np.testing.assert_allclose(got[1][:, :, :, 0, :, 0], want, atol=1e-4,
                               rtol=1e-4)


def test_bf16_value_relative_tolerance():
    """A bf16 value (and go) with f32 loc/attw, the mix bf16 autocast
    feeds: gradients in each input's dtype, equal to the f32 VJP on the
    bf16-rounded inputs within rtol 2e-2 / atol 3e-2."""
    shapes, *dims = CASES["multi_d24"]
    value, loc, attw, go = make_inputs(shapes, *dims, seed=4)
    v16 = torch.from_numpy(value).bfloat16()
    go16 = torch.from_numpy(go).bfloat16()
    grads = msda.ms_deform_attn_bwd(v16, shapes, torch.from_numpy(loc),
                                    torch.from_numpy(attw), go16)
    assert [g.dtype for g in grads] == [torch.bfloat16, torch.float32,
                                        torch.float32]
    ref = jax_vjp(ms_deform_attn_xla, v16.float().numpy(), shapes, loc,
                  attw, go16.float().numpy())
    assert_grads([g.float().numpy() for g in grads], ref, 3e-2, 2e-2,
                 "bf16 value")


def test_out_of_bounds_samples_get_exact_zero_grads():
    shapes, *dims = CASES["multi_d24"]
    value, loc, attw, go = make_inputs(shapes, *dims, seed=5)
    # every sample at least one pixel outside each level
    loc = np.where(np.arange(loc.size).reshape(loc.shape) % 2 == 0,
                   -0.6, 1.6).astype(np.float32)
    for g in port_bwd(value, shapes, loc, attw, go):
        assert np.all(g == 0.0)
    gv, gl, ga = ms_deform_attn_pallas_hat_bwd(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attw),
        jnp.asarray(go), interpret=True)
    for g in (gv, gl, ga):
        np.testing.assert_allclose(np.asarray(g), 0.0, atol=1e-6)


def test_gradcheck_plain_f64():
    """Finite differences in f64 on the plain version, with every sample
    strictly inside a pixel cell (fractional parts in [0.1, 0.9]) so that
    no finite-difference step crosses a pixel boundary."""
    shapes = ((5, 6), (3, 4))
    B, Lq, M, D, P = 1, 5, 2, 3, 2
    rng = np.random.default_rng(6)
    S = sum(h * w for h, w in shapes)
    value = torch.tensor(rng.standard_normal((B, S, M, D)),
                         dtype=torch.float64, requires_grad=True)
    loc = np.empty((B, Lq, M, len(shapes), P, 2))
    for lvl, (h, w) in enumerate(shapes):
        for c, n in ((0, w), (1, h)):
            px = (rng.integers(-1, n, (B, Lq, M, P))
                  + rng.uniform(0.1, 0.9, (B, Lq, M, P)))
            loc[:, :, :, lvl, :, c] = (px + 0.5) / n
    loc = torch.tensor(loc, requires_grad=True)
    attw = torch.tensor(rng.uniform(0.1, 1.0, (B, Lq, M, len(shapes), P)),
                        requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda v, lc, a: msda.ms_deform_attn_plain(v, shapes, lc, a),
        (value, loc, attw), eps=1e-6, atol=1e-6, rtol=1e-5)


def test_cpu_route_is_plain_and_counts_no_launch(monkeypatch):
    """On CPU tensors ms_deform_attn is the plain version, autograd
    differentiates it, and neither kernel is reached or counted."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a CUDA kernel")

    monkeypatch.setattr(msda, "ms_deform_attn_cuda", no_kernel)
    monkeypatch.setattr(msda, "ms_deform_attn_bwd_cuda", no_kernel)
    fwd, bwd = msda.ms_deform_attn.launches, msda.ms_deform_attn_bwd.launches
    shapes, *dims = CASES["multi_d24"]
    value, loc, attw, go = make_inputs(shapes, *dims, seed=7)
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (value, loc, attw)]
    out = msda.ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2])
    out.backward(torch.from_numpy(go))
    want = port_bwd(value, shapes, loc, attw, go)
    for leaf, w in zip(leaves, want):
        np.testing.assert_array_equal(leaf.grad.numpy(), w)
    assert msda.ms_deform_attn.launches == fwd
    assert msda.ms_deform_attn_bwd.launches == bwd


def test_bwd_kernel_arg_checks():
    """What the backward wrapper refuses, checked before any build: these
    raise on the CPU too."""
    shapes = ((6, 8),)
    value, loc, attw, go = (torch.from_numpy(a) for a in
                            make_inputs(shapes, 1, 8, 2, 8, 4))
    with pytest.raises(ValueError, match="grad_out"):
        msda.ms_deform_attn_bwd_cuda(value, shapes, loc, attw,
                                     go.bfloat16())
    with pytest.raises(ValueError, match="grad_out"):
        msda.ms_deform_attn_bwd_cuda(value, shapes, loc, attw, go[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        strided = go.transpose(1, 2).contiguous().transpose(1, 2)
        msda.ms_deform_attn_bwd_cuda(value, shapes, loc, attw, strided)
    with pytest.raises(TypeError):
        msda.ms_deform_attn_bwd_cuda(value.half(), shapes, loc, attw, go)
