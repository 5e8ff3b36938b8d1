"""The port's whole single-frame slice against the flax model: the
``DeformableDETR`` forward for LateFusion and Baseline, and ``Server`` from
uint8 frames to detections.

Small dims (hidden 64, 4 heads, 2+2 layers, 12 queries) and 96x128 uint8
inputs with real padding, made with numpy from a seed. The flax variables
are random (every leaf, ``torch_port_helpers.random_variables``) and carried
into the port by ``utils/convert.py``. Tolerance: atol 1e-4 / rtol 1e-3 on
logits and boxes of every decoder layer, the JAX package's own full-model
torch-parity tolerance.
"""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.models.postprocess import postprocess as j_postprocess
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.serve import Server
from dfvod_tpu_torch.utils.config import Config, ModelConfig, check_supported
from dfvod_tpu_torch.utils.convert import load_jax_variables
from torch_port_helpers import assert_close, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(num_classes=3, num_queries=12, hidden_dim=64, nheads=4,
            enc_layers=2, dec_layers=2, dim_feedforward=128, dropout=0.0,
            num_feature_levels=1)
VARIANTS = {"LateFusion": dict(fusion_type="LateFusion"),
            "Baseline": dict(fusion_type="Baseline", with_box_refine=False)}


def make_frames(channels, seed=0, B=2, H=96, W=128):
    """uint8 frames padded bottom/right: image 1 keeps a 60 x 84 block."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, H, W, channels), dtype=np.uint8)
    sizes = np.array([[H, W], [60, 84]][:B])
    for i, (h, w) in enumerate(sizes):
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    return imgs, sizes


@pytest.fixture(scope="module", params=list(VARIANTS))
def flax_run(request):
    """(name, model kwargs, frames, sizes, flax variables, flax outputs)."""
    kw = dict(DIMS, **VARIANTS[request.param])
    model = j_build_model(JConfig(model=JModelConfig(**kw)))[0]
    imgs, sizes = make_frames(4 if request.param == "LateFusion" else 3)
    x, mask = j_normalize(jnp.asarray(imgs), jnp.asarray(sizes))
    variables = random_variables(
        lambda: model.init(jax.random.PRNGKey(0), x, mask, train=False),
        seed=11)
    out = jax.jit(lambda v, i, m: model.apply(v, i, m, train=False))(
        variables, x, mask)
    return request.param, kw, imgs, sizes, variables, out


def port_model(kw, variables):
    model, _, _ = build_model(Config(model=ModelConfig(**kw)), device="cpu")
    return load_jax_variables(model, variables)


def test_deformable_detr_matches_flax(flax_run):
    name, kw, imgs, sizes, variables, ref = flax_run
    model = port_model(kw, variables)
    x, mask = device_normalize(torch.from_numpy(imgs),
                               torch.from_numpy(sizes))
    with torch.no_grad():
        out = model(x, mask)
    assert out["pred_logits"].shape == (2, 12, 3)
    pairs = [(out, ref)] + list(zip(out["aux_outputs"], ref["aux_outputs"]))
    assert len(pairs) == kw["dec_layers"]
    for i, (o, r) in enumerate(pairs):
        for k in ("pred_logits", "pred_boxes"):
            assert_close(o[k], r[k], atol=1e-4, rtol=1e-3,
                         err_msg=f"{name} layer {i} {k}")
    # query_embed splits as (query_pos, tgt)
    assert_close(out["_trunk"]["query_pos"], ref["_trunk"]["query_pos"],
                 atol=0, rtol=0)
    assert_close(out["_trunk"]["valid_ratios"],
                 ref["_trunk"]["valid_ratios"], atol=1e-7, rtol=0)


def test_server_uint8_to_detections(flax_run):
    name, kw, imgs, sizes, variables, ref = flax_run
    server = Server(Config(model=ModelConfig(**kw)), variables,
                    device="cpu", dtype=torch.float32)
    det = server(imgs, sizes)
    jdet = j_postprocess(ref["pred_logits"], ref["pred_boxes"],
                         jnp.asarray(sizes))
    # top-100 clamped to Q * 2 foreground classes
    assert det["scores"].shape == (2, 24) and det["boxes"].shape == (2, 24, 4)
    # top-k after sorting: lax.top_k and torch.topk may order ties apart
    s = det["scores"].numpy()
    js = np.asarray(jdet["scores"])
    np.testing.assert_allclose(np.sort(s, 1), np.sort(js, 1), atol=1e-4,
                               rtol=1e-3)
    # boxes and labels where the score has no near-tie
    gap = np.abs(np.diff(js, axis=1))
    clear = np.ones_like(js, bool)
    clear[:, 1:] &= gap > 1e-3
    clear[:, :-1] &= gap > 1e-3
    np.testing.assert_array_equal(det["labels"].numpy()[clear],
                                  np.asarray(jdet["labels"])[clear])
    np.testing.assert_allclose(det["boxes"].numpy()[clear],
                               np.asarray(jdet["boxes"])[clear], atol=1e-2,
                               rtol=1e-3)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(model=ModelConfig(**DIMS))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(cfg)


# ids as pytest named these cases while the list began with remat, which
# is supported now (``test_remat_serves_and_trains``)
# a slice name of None: refused until its slice was ported, and now
# supported; the case asserts that it is (two-stage proposals, the
# segmentation branch and the ResNet-18 research depth trunk, held against
# flax in tests/test_torch_two_stage.py, tests/test_torch_segmentation.py
# and tests/test_torch_research.py)
UNSUPPORTED = [
    pytest.param(dict(two_stage=True), None, id="kw1-two-stage"),
    pytest.param(dict(masks=True), None, id="kw2-segmentation"),
    # stages 2-4 give 3 levels: 2 is refused, as the JAX model fails there
    pytest.param(dict(num_feature_levels=2), "multi-level",
                 id="kw3-multi-level"),
    pytest.param(dict(fusion_type="LateFusion",
                      depth_backbone_type="resnet18"), None,
                 id="kw4-research"),
]


@pytest.mark.parametrize("training", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("fusion", ["Encoder_CrossFusion",
                                    "Backbone_CrossFusion"])
def test_other_fusion_modes_are_supported(fusion, training):
    """The paper's other two fusion modes serve and train
    (``tests/test_torch_fusion_modes.py`` and
    ``tests/test_torch_fusion_train.py`` hold them against flax)."""
    check_supported(ModelConfig(fusion_type=fusion), training=training)


@pytest.mark.parametrize("training", [False, True], ids=["serve", "train"])
def test_remat_serves_and_trains(training):
    """Encoder remat recomputes training activations
    (``tests/test_torch_remat.py``) and is a no-op in eval."""
    check_supported(ModelConfig(temporal_mode="transvod_pp", remat=True),
                    training=training)


@pytest.mark.parametrize("kw,slice_name", UNSUPPORTED)
def test_unsupported_config_names_its_slice(kw, slice_name):
    # refused for serving, as ``Server`` and ``build_model`` check it
    if slice_name is None:
        check_supported(ModelConfig(**kw))
        return
    with pytest.raises(NotImplementedError, match=slice_name):
        check_supported(ModelConfig(**kw))


@pytest.mark.parametrize("kw,slice_name", UNSUPPORTED)
def test_unsupported_config_refused_for_training(kw, slice_name):
    # every refusal holds for training too (the temporal modes serve and
    # train), and what serves now trains
    if slice_name is None:
        check_supported(ModelConfig(**kw), training=True)
        return
    with pytest.raises(NotImplementedError, match=slice_name):
        check_supported(ModelConfig(**kw), training=True)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import neither JAX,
    flax nor the JAX package: checked in a fresh interpreter (the tools,
    the plots and the int8 mode among the modules walked, matplotlib and
    transformers left unloaded, as the card machine has neither), and on
    chip_smoke.py's source."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dfvod_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'dfvod_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dfvod_tpu')]\n"
        "assert not bad, bad\n"
        "for n in ('parallel.dist', 'ops.quant', 'utils.attribution',\n"
        "          'utils.visualization', 'tools.calculate_mean_std',\n"
        "          'tools.yolo_to_coco', 'tools.yolo_eval', 'tools.rgb2d'):\n"
        "    assert 'dfvod_tpu_torch.' + n in sys.modules, n\n"
        "lazy = [m for m in sys.modules if m.split('.')[0] in "
        "('matplotlib', 'transformers')]\n"
        "assert not lazy, lazy\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('dfvod_tpu_torch.')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                           "dfvod_tpu"), n
