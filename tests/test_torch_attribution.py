"""The port's integrated gradients (``dfvod_tpu_torch/utils/attribution.py``)
against the JAX package's (``dfvod_tpu/utils/attribution.py``): the three
cases of ``tests/test_attribution.py`` (a linear model exactly,
completeness on a nonlinear function, a tiny RGB-D detector) and the
detector's attribution against JAX's on the same seeded weights and
input.

Tolerances: the linear case rtol 1e-5 and |delta| < 1e-4 (JAX's own);
completeness 2e-3 (JAX's own); the detector's attribution against JAX's
within atol 1e-4 * max|JAX| and rtol 1e-3, its delta within 1e-4 of
JAX's (f32 throughout, only summation orders differ); the 2x2 figure
decoded equal to the JAX function's, pixel for pixel (the same code on
the same matplotlib).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.utils import attribution as j_attr
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.utils.attribution import (
    integrated_gradients,
    visualize_integrated_gradients,
)
from dfvod_tpu_torch.utils.config import Config, ModelConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import random_variables, t2n

TINY = dict(num_classes=3, num_queries=8, hidden_dim=32, nheads=4,
            enc_layers=1, dec_layers=1, dim_feedforward=64, dropout=0.0,
            num_feature_levels=1, fusion_type="LateFusion", use_depth=True,
            aux_loss=False)


def test_linear_model_is_exact():
    """For f(x) = w.x, IG = w * x exactly (any step count), delta = 0."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    attr, delta = integrated_gradients(lambda z: torch.sum(w * z), x,
                                       n_steps=4)
    np.testing.assert_allclose(attr.numpy(), (w * x).numpy(), rtol=1e-5)
    assert abs(float(delta)) < 1e-4
    assert attr.dtype == torch.float32 and delta.dtype == torch.float32


def test_completeness_on_nonlinear():
    """Attributions sum to f(x) - f(baseline) as n_steps grows; equal to
    JAX's within 1e-5."""
    rng = np.random.default_rng(1)
    xn = rng.standard_normal((8,)).astype(np.float32)
    x = torch.from_numpy(xn)

    def f(z):
        return torch.sum(torch.tanh(z) ** 2) + torch.sum(z[:2] * z[2:4])

    attr, delta = integrated_gradients(f, x, n_steps=256)
    assert abs(float(delta)) < 1e-3 * max(1.0, abs(float(f(x))))
    np.testing.assert_allclose(float(attr.sum()), float(f(x) - f(0 * x)),
                               atol=2e-3)
    jattr, jdelta = j_attr.integrated_gradients(
        lambda z: jnp.sum(jnp.tanh(z) ** 2) + jnp.sum(z[:2] * z[2:4]),
        jnp.asarray(xn), n_steps=256)
    np.testing.assert_allclose(attr.numpy(), np.asarray(jattr), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(delta) - float(jdelta)) < 1e-5


@pytest.fixture(scope="module")
def detector():
    """(port model, input (48, 48, 4), mask, JAX attribution, JAX delta):
    ``tests/test_attribution.py``'s tiny detector with seeded random
    weights, IG at n_steps=4 in JAX."""
    model = j_build_model(JConfig(model=JModelConfig(**TINY)))[0]
    rng = np.random.default_rng(2)
    img = rng.standard_normal((48, 48, 4)).astype(np.float32)
    mask = np.zeros((1, 48, 48), bool)
    v = random_variables(lambda: model.init(
        jax.random.PRNGKey(0), jnp.asarray(img)[None], jnp.asarray(mask),
        train=False), seed=2)

    def hand_score(z):
        out = model.apply(v, z[None], jnp.asarray(mask), train=False)
        return jnp.sum(jax.nn.sigmoid(out["pred_logits"])[..., 1])

    jattr, jdelta = j_attr.integrated_gradients(hand_score, jnp.asarray(img),
                                                n_steps=4)
    port = build_model(Config(model=ModelConfig(**TINY)), device="cpu")[0]
    load_jax_variables(port, v).eval()
    return (port, torch.from_numpy(img), torch.from_numpy(mask),
            np.asarray(jattr), float(jdelta))


def test_detector_score_attribution_matches_jax(detector, tmp_path):
    """IG through the model on a tiny RGB-D input: the attribution has
    the input's shape, is finite and equals JAX's; the reference-style 2x2
    figure (``inference.py:972-1026``) is written, equal to JAX's."""
    model, img, mask, jattr, jdelta = detector

    def hand_score(z):
        out = model(z[None], mask)
        return torch.sigmoid(out["pred_logits"])[..., 1].sum()

    attr, delta = integrated_gradients(hand_score, img, n_steps=4)
    assert attr.shape == img.shape
    assert np.isfinite(t2n(attr)).all() and np.isfinite(float(delta))
    np.testing.assert_allclose(t2n(attr), jattr,
                               atol=1e-4 * np.abs(jattr).max(), rtol=1e-3)
    assert abs(float(delta) - jdelta) < 1e-4
    # autograd recorded nothing into the model's parameters
    assert all(p.grad is None for p in model.parameters())

    pytest.importorskip("matplotlib")
    from PIL import Image
    out = visualize_integrated_gradients(img.numpy(), t2n(attr),
                                         str(tmp_path / "ig.png"))
    assert os.path.exists(out)
    ref = j_attr.visualize_integrated_gradients(
        img.numpy(), t2n(attr), str(tmp_path / "ig_jax.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(out)),
                                  np.asarray(Image.open(ref)))
