"""The port's MSDA (``dfvod_tpu_torch/ops/msda.py``) against the JAX package.

The plain PyTorch version is held to ``ms_deform_attn_xla`` at f32 atol
1e-5 (same gather formulation, sums in another order), and to the TPU
kernel ``ms_deform_attn_pallas_hat`` run in interpret mode at atol 1e-4 /
rtol 1e-3 (its f32 path is a hi/lo bf16 split, ``msda_pallas.py:1305``).
On the CPU the wrapper takes the plain version and launches nothing; the
CUDA kernel itself is checked on the card (``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.ops.msda import ms_deform_attn_xla
from dfvod_tpu.ops.msda_pallas import ms_deform_attn_pallas_hat
from dfvod_tpu_torch.ops import msda
from dfvod_tpu_torch.utils import trace

# (spatial_shapes, B, Lq, M, D, P): single level, multi-level with
# Lq not a multiple of 128 and odd D, D above one warp's 32 lanes
CASES = [
    (((6, 8),), 2, 48, 2, 8, 4),
    (((7, 9), (4, 5)), 2, 37, 3, 5, 2),
    (((5, 6), (3, 3), (2, 2)), 1, 131, 2, 40, 3),
]


def make_inputs(shapes, B, Lq, M, D, P, seed=0, lo=-0.1, hi=1.1):
    rng = np.random.default_rng(seed)
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, S, M, D)).astype(np.float32)
    loc = rng.uniform(lo, hi, (B, Lq, M, L, P, 2)).astype(np.float32)
    logits = rng.standard_normal((B, Lq, M, L * P))
    attw = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return value, loc, attw.reshape(B, Lq, M, L, P).astype(np.float32)


def port(value, shapes, loc, attw):
    return msda.ms_deform_attn(torch.from_numpy(value), shapes,
                               torch.from_numpy(loc),
                               torch.from_numpy(attw)).numpy()


@pytest.mark.parametrize("case", CASES, ids=["single", "multi_odd_d",
                                             "three_level_d40"])
def test_plain_matches_xla(case):
    shapes, *dims = case
    value, loc, attw = make_inputs(shapes, *dims)
    ref = np.asarray(ms_deform_attn_xla(jnp.asarray(value), shapes,
                                        jnp.asarray(loc), jnp.asarray(attw)))
    got = port(value, shapes, loc, attw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", CASES[:2], ids=["single", "multi_odd_d"])
def test_plain_matches_hat_kernel_interpret(case):
    shapes, *dims = case
    value, loc, attw = make_inputs(shapes, *dims, seed=1)
    ref = np.asarray(ms_deform_attn_pallas_hat(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attw),
        interpret=True))
    np.testing.assert_allclose(port(value, shapes, loc, attw), ref,
                               atol=1e-4, rtol=1e-3)


def test_all_out_of_bounds_is_exact_zero():
    shapes = ((7, 9), (4, 5))
    value, loc, attw = make_inputs(shapes, 2, 21, 2, 6, 3)
    # every sample at least one pixel outside each level
    loc = np.where(np.arange(loc.size).reshape(loc.shape) % 2 == 0,
                   -0.5, 1.5).astype(np.float32)
    got = port(value, shapes, loc, attw)
    assert np.all(got == 0.0)
    ref = np.asarray(ms_deform_attn_xla(jnp.asarray(value), shapes,
                                        jnp.asarray(loc), jnp.asarray(attw)))
    assert np.all(ref == 0.0)


def test_bf16_value_f32_coords():
    """The serving mix (bf16 value, f32 loc, bf16 attw): output in bf16,
    equal to the f32 computation on the bf16-rounded inputs within bf16's
    output rounding."""
    shapes = ((6, 8),)
    value, loc, attw = make_inputs(shapes, 2, 30, 2, 8, 4, seed=2)
    v16 = torch.from_numpy(value).bfloat16()
    a16 = torch.from_numpy(attw).bfloat16()
    got = msda.ms_deform_attn(v16, shapes, torch.from_numpy(loc), a16)
    assert got.dtype == torch.bfloat16
    ref = msda.ms_deform_attn_plain(v16.float(), shapes,
                                    torch.from_numpy(loc), a16.float())
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                               atol=2e-2, rtol=1e-2)


def test_cpu_takes_plain_path_and_counts_no_launch(monkeypatch):
    def no_kernel(*args):
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    monkeypatch.setattr(msda, "ms_deform_attn_cuda", no_kernel)
    before = trace.counter("msda_fwd")
    shapes = ((6, 8),)
    value, loc, attw = make_inputs(shapes, 1, 8, 2, 8, 4)
    port(value, shapes, loc, attw)
    assert trace.counter("msda_fwd") == before


def test_kernel_arg_checks():
    """What the kernel wrapper refuses, checked before any build: these
    raise on the CPU too."""
    shapes = ((6, 8),)
    value, loc, attw = (torch.from_numpy(a) for a in
                        make_inputs(shapes, 1, 8, 2, 8, 4))
    with pytest.raises(TypeError):
        msda._check_kernel_args(value.double(), shapes, loc, attw)
    with pytest.raises(TypeError):   # bf16 loc with f32 value
        msda._check_kernel_args(value, shapes, loc.bfloat16(), attw)
    with pytest.raises(ValueError):
        msda._check_kernel_args(value, ((6, 7),), loc, attw)
    with pytest.raises(ValueError):
        msda._check_kernel_args(value, shapes, loc.transpose(1, 2), attw)
    with pytest.raises(ValueError):
        msda._check_kernel_args(value[:, :, :1], shapes, loc, attw)
    msda._check_kernel_args(value.bfloat16(), shapes, loc, attw.bfloat16())
