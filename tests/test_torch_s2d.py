"""The s2d route (``--pack_s2d``) against the JAX package: the host 2x2
space-to-depth packing (``pack_s2d``, channels ``[R00 G00 B00 R01 ... B11
| D00 D01 D10 D11]``), the device normalization of packed frames
(``device_normalize_s2d``, padding zeroed per block), the 12/16-channel
dispatch, ``Loader(pack_s2d=True)`` and the model on packed frames.

The JAX stems convolve the packed frames directly (``StemConvS2D``,
``Conv3x3S2D``); the port unpacks them on the device and runs its plain
stems. Tolerances: the packing bitwise; the normalization within 1e-6 of
JAX's; the port's model on packed frames within atol 1e-5 of the same model
on the unpacked frames and within atol 1e-4 / rtol 1e-3 of flax on the
packed frames (small dims: hidden 64, 4 heads, 2+2 layers, 12 queries, on
96x128 uint8 frames with real padding).
"""
import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data import dataset as j_dataset
from dfvod_tpu.data import device_pipeline as j_dp
from dfvod_tpu.data import loader as j_loader
from dfvod_tpu.data import transforms as j_tf
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu_torch.data import dataset
from dfvod_tpu_torch.data import transforms as tf
from dfvod_tpu_torch.data.device_pipeline import (
    device_normalize,
    device_normalize_s2d,
    normalize_frames,
    pack_s2d,
    unpack_s2d,
)
from dfvod_tpu_torch.data.loader import Loader
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.train.engine import create_train_state, train_step
from dfvod_tpu_torch.utils.config import Config, ModelConfig, TrainConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import (
    assert_close,
    make_frames,
    private_jax_native,
    random_variables,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

COCO_DIR = os.path.join(chip_smoke.SYNTH_RGBD, "coco")
TRAIN_JSON = os.path.join(COCO_DIR, "annotations", "train.json")
MAX_DIFF_SHARE = 5e-4           # the resize gate of test_torch_data.py
DIMS = dict(num_classes=3, num_queries=12, hidden_dim=64, nheads=4,
            enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0,
            num_feature_levels=1)


@pytest.fixture(scope="module", autouse=True)
def jax_native_library(tmp_path_factory):
    restore = private_jax_native(tmp_path_factory.mktemp("jax_native"))
    yield
    restore()


@pytest.mark.parametrize("channels", [3, 4])
def test_pack_s2d_is_jax_bitwise_and_unpacks(channels):
    imgs, _ = make_frames(channels, B=3, H=10, W=14)
    packed = pack_s2d(imgs)
    np.testing.assert_array_equal(packed, j_dp.pack_s2d(imgs))
    assert packed.shape == (3, 5, 7, 4 * channels)
    np.testing.assert_array_equal(
        unpack_s2d(torch.from_numpy(packed)).numpy(), imgs)
    for bad in (imgs[:, :9], imgs[:, :, :13], imgs[..., :2]):
        with pytest.raises(ValueError, match="s2d packing"):
            pack_s2d(bad)


@pytest.mark.parametrize("channels", [3, 4])
def test_device_normalize_s2d_equals_jax(channels):
    """Odd content sizes, so blocks straddle the padding edge: JAX's
    image within 1e-6, its full-resolution mask equal; unpacked, the image
    is ``device_normalize``'s bitwise."""
    imgs, sizes = make_frames(channels, B=3)
    sizes = np.array([[96, 128], [61, 85], [37, 1]])
    packed = pack_s2d(imgs)
    got, mask = device_normalize_s2d(torch.from_numpy(packed),
                                     torch.from_numpy(sizes))
    ref, ref_mask = j_dp.device_normalize_s2d(jnp.asarray(packed),
                                              jnp.asarray(sizes))
    assert_close(got, ref, 1e-6, 0)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    plain, plain_mask = device_normalize(torch.from_numpy(imgs),
                                         torch.from_numpy(sizes))
    assert torch.equal(unpack_s2d(got), plain)
    assert torch.equal(mask, plain_mask)
    # the dispatch: 12/16 channels are packed, 3/4 are not
    for x in (packed, imgs):
        a, m = normalize_frames(torch.from_numpy(x), torch.from_numpy(sizes))
        b = (got, mask) if x is packed else (plain, plain_mask)
        assert torch.equal(a, b[0]) and torch.equal(m, b[1])


@pytest.mark.parametrize("fusion", ["LateFusion", "Baseline"])
def test_model_on_packed_frames_equals_unpacked_and_flax(fusion):
    channels = 3 if fusion == "Baseline" else 4
    kw = dict(DIMS, fusion_type=fusion)
    imgs, sizes = make_frames(channels)
    packed = pack_s2d(imgs)
    jmodel = j_build_model(JConfig(model=JModelConfig(**kw)))[0]
    jx, jmask = j_dp.device_normalize_s2d(jnp.asarray(packed),
                                          jnp.asarray(sizes))
    variables = random_variables(
        lambda: jmodel.init(jax.random.PRNGKey(0), jx, jmask, train=False),
        seed=11)
    ref = jax.jit(lambda v, x, m: jmodel.apply(v, x, m, train=False))(
        variables, jx, jmask)
    model = load_jax_variables(
        build_model(Config(model=ModelConfig(**kw)), device="cpu")[0],
        variables).eval()
    out = model(*normalize_frames(torch.from_numpy(packed),
                                  torch.from_numpy(sizes)))
    plain = model(*normalize_frames(torch.from_numpy(imgs),
                                    torch.from_numpy(sizes)))
    for k in ("pred_logits", "pred_boxes"):
        assert_close(out[k], plain[k].detach().numpy(), 1e-5, 0, err_msg=k)
        assert_close(out[k], ref[k], 1e-4, 1e-3, err_msg=k)


def test_backbone_cross_fusion_refuses_packed_frames():
    model = build_model(Config(model=ModelConfig(
        **dict(DIMS, fusion_type="Backbone_CrossFusion"))), device="cpu")[0]
    imgs, sizes = make_frames(4)
    with pytest.raises(ValueError, match="s2d stems"):
        model(*normalize_frames(torch.from_numpy(pack_s2d(imgs)),
                                torch.from_numpy(sizes)))


def loaders(pack):
    common = dict(batch_size=4, use_depth=True, shuffle=True,
                  drop_last=True, seed=42, pack_s2d=pack)
    short = dict(short_sides=(224, 256, 288), max_size=512)
    port = Loader(dataset.CocoDetectionDataset(
        os.path.join(COCO_DIR, "images"), TRAIN_JSON, use_depth=True),
        tf.TrainTransform(**short), **common)
    jax_ = j_loader.Loader(j_dataset.CocoDetectionDataset(
        os.path.join(COCO_DIR, "images"), TRAIN_JSON, use_depth=True),
        j_tf.TrainTransform(**short), device_preprocess=True, **common)
    return port, jax_


def first(loader, n):
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    return out


def test_loader_pack_s2d_equals_jax_and_packs_the_plain_batch(monkeypatch):
    monkeypatch.setenv("DFVOD_CV2", "0")
    port, jax_ = loaders(True)
    plain, _ = loaders(False)
    for got, ref, unpacked in zip(first(port, 3), first(jax_, 3),
                                  first(plain, 3)):
        assert got.keys() == ref.keys()
        assert got["image"].shape[-1] == 16
        np.testing.assert_array_equal(got["image"],
                                      pack_s2d(unpacked["image"]))
        for k in ref:
            if k == "image":
                d = np.abs(got[k].astype(np.int16) - ref[k])
                assert d.max() <= 1 and (d > 0).mean() <= MAX_DIFF_SHARE
            else:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_train_step_on_packed_batch_equals_unpacked():
    """One step of the same model on a batch and on its packed form: the
    same loss, components and grad_norm (atol 1e-5)."""
    cfg = Config(model=ModelConfig(**dict(DIMS, fusion_type="LateFusion")),
                 train=TrainConfig(lr=1e-5, epochs=2))
    model, criterion, _ = build_model(cfg, device="cpu", seed=3)
    imgs, sizes = make_frames(4, seed=2)
    rng = np.random.default_rng(5)
    targets = {"labels": rng.integers(0, 2, (2, 8)).astype(np.int32),
               "boxes": np.concatenate([rng.uniform(0.2, 0.8, (2, 8, 2)),
                                        rng.uniform(0.05, 0.3, (2, 8, 2))],
                                       -1).astype(np.float32),
               "valid": np.arange(8)[None] < np.array([[3], [5]])}
    metrics = []
    for images in (imgs, pack_s2d(imgs)):
        state = create_train_state(copy.deepcopy(model), cfg,
                                   steps_per_epoch=1)
        metrics.append({k: float(v) for k, v in train_step(
            state, criterion, {"images": images, "sizes": sizes,
                               **targets}).items()})
    assert metrics[0].keys() == metrics[1].keys()
    for k in metrics[0]:
        np.testing.assert_allclose(metrics[1][k], metrics[0][k], atol=1e-5,
                                   rtol=0, err_msg=k)
