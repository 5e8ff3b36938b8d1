"""The port's training CLI (``dfvod_tpu_torch/cli``) against the JAX
package's (``dfvod_tpu/cli``):

- the parser: every flag's ``dest`` and default equal; for the argument
  list of each ``configs/training/*.sh`` (bash's own expansion,
  ``chip_smoke.recipe_argv``), the two ``config_from_args`` give equal
  configurations;
- on ``tests/test_cli_e2e.py``'s tiny tree (8 frames of 48x64; with
  ``--max_size 64`` and short side 48 no frame is resized, so both CLIs
  see bitwise-equal images), the same reference ``.pth`` (from
  ``tests/torch_ref.py``'s LateFusion replica, hidden 32, 1 + 2 layers)
  loaded into both with ``--resume``: ``--eval`` gives equal stats, as
  ``tests/test_torch_evaluate.py`` holds ``evaluate``'s; one epoch (one
  step of 8 frames) at dropout 0 gives ``log.txt`` train losses within atol 1e-4 / rtol 1e-3 of
  JAX's and parameters within ``tests/test_torch_train.py``'s update gate
  (at its optimizer, ``LateFusion_bf16.sh``'s: lr 1e-5);
- the NaN exit code, ``--auto_resume`` with the best watermark, a
  ``main_multi`` run from ``--spatial_weights`` under
  ``--fixed_pretrained_model`` that moves only temporal parameters,
  ``--profile_dir``, and every refusal naming its slice.
"""
import argparse
import copy
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dfvod_tpu.cli import flags as j_flags
from dfvod_tpu.cli import main as j_main
from dfvod_tpu.utils import checkpoint as j_ckpt
from dfvod_tpu_torch.cli import flags
from dfvod_tpu_torch.cli import main as cli
from dfvod_tpu_torch.data.dataset import build_dataset, make_transform
from dfvod_tpu_torch.data.loader import Loader, to_train_batch
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.train import create_train_state
from dfvod_tpu_torch.train.engine import forward
from dfvod_tpu_torch.train.optim import label_params
from dfvod_tpu_torch.utils.checkpoint import load_checkpoint
from torch_port_helpers import flat_params
from torch_ref import TorchDeformableDETR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

RECIPES = sorted(os.listdir(os.path.join(REPO, "configs", "training")))
LOSS_KEYS = ("train_loss", "train_grad_norm", "train_loss_ce",
             "train_loss_bbox", "train_loss_giou")


# ------------------------------------------------------------------ parser
def defaults(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type)
            for a in parser._actions}


@pytest.mark.parametrize("video", [False, True], ids=["main", "main_multi"])
def test_every_flag_has_jax_dest_and_default(video):
    assert defaults(flags.get_args_parser(video)) == \
        defaults(j_flags.get_args_parser(video))


def recipe_configs(recipe, env):
    """(port Config, JAX Config) of a recipe's argument list."""
    module, argv = chip_smoke.recipe_argv(recipe, **env)
    if argv[-1] == "--resume":   # RESUME_PATH unset: an empty path
        argv = [*argv, ""]
    video = module.endswith("main_multi")
    port = flags.config_from_args(
        flags.get_args_parser(video).parse_args(argv), video=video)
    ref = j_flags.config_from_args(
        j_flags.get_args_parser(video).parse_args(argv), video=video)
    return port, ref


CASES = [(r, {}) for r in RECIPES] + [
    ("SynthHard_Temporal.sh", {"STAGE": "video"}),
    ("SynthHard_Temporal.sh", {"STAGE": "video", "FREEZE": "off"})]


@pytest.mark.parametrize("recipe,env", CASES,
                         ids=[r + ("-" + "-".join(e.values()) if e else "")
                              for r, e in CASES])
def test_recipe_configs_equal_jax(recipe, env):
    port, ref = recipe_configs(recipe, env)
    for part in ("model", "loss", "train", "data"):
        assert dataclasses.asdict(getattr(port, part)) == \
            dataclasses.asdict(getattr(ref, part)), part
    assert port.output_dir == ref.output_dir


# -------------------------------------------------------------- tiny runs
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``tests/test_cli_e2e.py``'s tree: a white 16x16 box on black per
    frame, depth its red channel; train.json = val.json."""
    root = tmp_path_factory.mktemp("data")
    dirs = [root / "coco" / d for d in ("images", "depth_pred",
                                        "annotations")]
    for d in dirs:
        d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    images, anns = [], []
    h, w = 48, 64
    for i in range(1, 9):
        rgb = np.zeros((h, w, 3), np.uint8)
        x, y = int(rng.integers(8, 40)), int(rng.integers(8, 24))
        rgb[y:y + 16, x:x + 16] = 255
        Image.fromarray(rgb).save(dirs[0] / f"im{i}.jpg")
        Image.fromarray(rgb[..., 0]).save(dirs[1] / f"im{i}.jpg")
        images.append({"id": i, "file_name": f"im{i}.jpg", "width": w,
                       "height": h, "video_id": 1, "frame_id": i - 1})
        anns.append({"id": i, "image_id": i, "category_id": 1,
                     "bbox": [x, y, 16, 16], "area": 256, "iscrowd": 0})
    ds = {"images": images, "annotations": anns,
          "videos": [{"id": 1, "name": "v"}],
          "categories": [{"id": 1, "name": "Hand"}]}
    for split in ("train", "val"):
        (dirs[2] / f"{split}.json").write_text(json.dumps(ds))
    return root


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    """A reference checkpoint of the LateFusion replica (random weights,
    ``randomize``d)."""
    torch.manual_seed(0)
    tm = TorchDeformableDETR(
        num_classes=3, num_queries=12, d_model=32, nhead=4, enc_layers=1,
        dec_layers=2, dim_feedforward=64, with_box_refine=True,
        two_stage=False, depth_type="DepthDeform_latefusion_dformer",
        dilation=True)
    tm.randomize()
    path = tmp_path_factory.mktemp("pth") / "checkpoint.pth"
    torch.save({"model": tm.state_dict(), "args": argparse.Namespace()},
               path)
    return str(path)


def tiny_argv(tree, out, *extra):
    return ["--coco_path", str(tree), "--output_dir", str(out),
            "--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1",
            "--dec_layers", "2", "--dim_feedforward", "64",
            "--num_queries", "12", "--dropout", "0", "--dilation",
            "--num_feature_levels", "1",
            "--with_box_refine", "--fusion_type", "LateFusion",
            "--dformer_backbone", "--batch_size", "8", "--epochs", "1",
            "--train_short_sides", "48", "--eval_short_side", "48",
            "--max_size", "64", "--max_boxes", "8", "--device_preprocess",
            "--num_devices", "1", "--lr", "1e-5", *extra]


def log_lines(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(x) for x in f]


@pytest.fixture(scope="module")
def runs(tree, reference_pth, tmp_path_factory):
    """Both CLIs from the same .pth: --eval, then one epoch (one step of
    the 8 frames)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DFVOD_CV2", "0")
    mp.setenv("DFVOD_JAX_CACHE", str(tmp_path_factory.mktemp("jax_cache")))
    try:
        out = {}
        for name, run in (("jax", lambda a: j_main.main(a)),
                          ("port", lambda a: cli.main(a, device="cpu"))):
            d = tmp_path_factory.mktemp(name)
            stats = run(tiny_argv(tree, d / "eval", "--eval", "--resume",
                                  reference_pth))
            final = run(tiny_argv(tree, d / "train", "--resume",
                                  reference_pth))
            out[name] = {"eval": stats, "final": final,
                         "dir": str(d / "train"),
                         "log": log_lines(d / "train")}
    finally:
        mp.undo()
    return out


def test_eval_from_the_same_pth_equals_jax(runs):
    stats, ref = runs["port"]["eval"], runs["jax"]["eval"]
    assert list(stats) == list(ref)
    assert stats == ref


def test_one_epoch_losses_equal_jax(runs):
    got, ref = runs["port"]["log"], runs["jax"]["log"]
    assert [ln.get("epoch") for ln in got] == [ln.get("epoch") for ln in
                                                ref] == [0, None]
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[0][k], ref[0][k], atol=1e-4,
                                   rtol=1e-3, err_msg=k)
    assert got[1]["eval"].keys() == ref[1]["eval"].keys()


def first_step_gradients(tree, pth):
    """The port's first-step gradients of the run (the .pth's weights, the
    first train batch of epoch 0) and their global norm."""
    args = flags.get_args_parser().parse_args(tiny_argv(tree, "",
                                                        "--resume", pth))
    cfg = flags.config_from_args(args)
    model, criterion, _ = build_model(cfg, "cpu", seed=cfg.train.seed)
    cli.apply_weights(model, cfg, resume=pth, del_class_weights=False,
                      temporal_weights="", spatial_weights="")
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    loader = Loader(build_dataset("train", cfg), make_transform(True, cfg),
                    batch_size=8, max_boxes=8, use_depth=True, seed=42,
                    drop_last=True)
    state = create_train_state(model, cfg, steps_per_epoch=1)
    loss, _ = criterion(*forward(state, to_train_batch(loader.first_batch())))
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()
             if p.grad is not None}
    norm = float(torch.cat([g.reshape(-1) for g in grads.values()]).norm())
    return init, grads, norm, cfg


def test_one_epoch_parameters_within_the_update_gate(runs, tree,
                                                     reference_pth):
    """After the epoch's step: every parameter within atol 1e-7 / rtol
    1e-6 of JAX's wherever the clipped gradient exceeds 1e-6
    (``test_torch_train.py``'s gate: Adam's first steps are about lr *
    sign(g), so an entry whose gradient is rounding noise may step either
    way); the frozen ResNet-50 bitwise the .pth's."""
    init, grads, norm, cfg = first_step_gradients(tree, reference_pth)
    clip = min(1.0, cfg.train.clip_max_norm / norm)
    got = load_checkpoint(runs["port"]["dir"])[0]["model"]
    restored, _ = j_ckpt.load_checkpoint(runs["jax"]["dir"])
    ref = flat_params(restored["params"])
    kept, total = 0, 0
    for k, p0 in init.items():
        if k not in grads:
            assert k.startswith("backbone.")
            assert torch.equal(got[k], p0), k
            np.testing.assert_array_equal(ref[k], p0.numpy(), err_msg=k)
            continue
        keep = (grads[k].abs() * clip > 1e-6).numpy()
        kept += int(keep.sum())
        total += keep.size
        np.testing.assert_allclose(got[k].numpy()[keep], ref[k][keep],
                                   atol=1e-7, rtol=1e-6, err_msg=k)
    assert kept > 0.5 * total


# ---------------------------------------------------- port-only behaviour
def test_nan_loss_exits_42(runs, tree, tmp_path):
    """A checkpoint whose class bias is NaN: the first step's loss is NaN
    and the CLI exits with ``NAN_EXIT_CODE``."""
    ckpt = load_checkpoint(runs["port"]["dir"])[0]
    bad = tmp_path / "bad"
    bad.mkdir()
    ckpt["model"] = {k: (torch.full_like(v, float("nan"))
                         if "class_embed" in k else v)
                     for k, v in ckpt["model"].items()}
    torch.save(ckpt, bad / "checkpoint0000.pth")
    with pytest.raises(SystemExit) as e:
        cli.main(tiny_argv(tree, tmp_path / "run", "--resume", str(bad)),
                 device="cpu")
    assert e.value.code == cli.NAN_EXIT_CODE == 42


def test_auto_resume_keeps_the_best_watermark(tree, tmp_path):
    """One epoch with ``--eval_every 1`` (and ``--profile_dir``: a trace
    of its steps), then a watermark above any mAP and ``--auto_resume
    --epochs 2``: epoch 1 runs once, from the restored optimizer step, and
    ``best/`` keeps epoch 0."""
    out, prof = tmp_path / "run", tmp_path / "prof"
    cli.main(tiny_argv(tree, out, "--eval_every", "1", "--profile_dir",
                       str(prof)), device="cpu")
    assert (prof / "trace.json").exists()
    assert (out / "best" / "checkpoint0000.pth").exists()
    assert json.loads((out / "best_meta.json").read_text())["epoch"] == 0
    (out / "best_meta.json").write_text(json.dumps({"best_map50": 2.0,
                                                    "epoch": 0}))
    cli.main(tiny_argv(tree, out, "--eval_every", "1", "--epochs", "2",
                       "--auto_resume"), device="cpu")
    epochs = [ln["epoch"] for ln in log_lines(out) if "epoch" in ln]
    assert epochs == [0, 1]
    assert sorted(os.listdir(out / "best")) == ["checkpoint0000.pth"]
    assert load_checkpoint(str(out))[0]["step"] == 2


def test_main_multi_fixed_pretrained_moves_only_temporal_parameters(
        runs, tree, tmp_path):
    """TransVOD++ from the single-frame run's checkpoint
    (``--spatial_weights``) under ``--fixed_pretrained_model``: every
    frozen parameter bitwise the spatial checkpoint's, temporal ones
    moved from their seeded init."""
    out = tmp_path / "video"
    argv = tiny_argv(tree, out, "--dataset_file", "vid_multi_plusplus",
                     "--num_ref_frames", "1", "--spatial_weights",
                     runs["port"]["dir"], "--fixed_pretrained_model")
    stats = cli.main(argv, video=True, device="cpu")
    assert set(stats) >= {"mAP", "mAP_50"}
    cfg = flags.config_from_args(
        flags.get_args_parser(video=True).parse_args(argv), video=True)
    model = build_model(cfg, "cpu", seed=cfg.train.seed)[0]
    init = copy.deepcopy(model.state_dict())
    got = load_checkpoint(str(out))[0]["model"]
    spatial = load_checkpoint(runs["port"]["dir"])[0]["model"]
    moved, temporal = 0, 0
    for k, label in label_params(model, "LateFusion", True,
                                 temporal=True).items():
        if label == "frozen":
            assert torch.equal(got[k], spatial[k[len("detr."):]]), k
        else:
            temporal += 1
            moved += int(not torch.equal(got[k], init[k]))
    assert temporal > 0 and moved > 0.5 * temporal


# ----------------------------------------------------------------- refusals
REFUSALS = {
    "frozen_weights": (["--frozen_weights", "x"], {}, "segmentation slice"),
    "num_devices": (["--num_devices", "2"], {}, "item 14"),
    "coordinator": ([], {"COORDINATOR_ADDRESS": "h:1"}, "item 14"),
    "multihost": ([], {"DFVOD_MULTIHOST": "1"}, "item 14"),
    "pack_s2d": (["--pack_s2d"], {}, "s2d slice"),
    "strong_aug": (["--strong_aug"], {}, "photometric slice"),
    "masks": (["--masks"], {}, "segmentation slice"),
    "coco_panoptic": (["--dataset_file", "coco_panoptic"], {},
                      "segmentation slice"),
    "two_stage": (["--two_stage"], {}, "two-stage proposals slice"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refused_flags_name_their_slice(name, tree, tmp_path, monkeypatch):
    extra, env, match = REFUSALS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = tiny_argv(tree, tmp_path / "run", *extra)
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv, device="cpu")


def test_cli_runs_on_the_card_unless_asked(tree, tmp_path):
    """Without ``device``, the CLI needs CUDA: here it raises before any
    work (no output directory written)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(tiny_argv(tree, tmp_path / "run"))
    assert not (tmp_path / "run").exists()
