"""The port's inference and benchmark CLIs (``dfvod_tpu_torch/cli/
inference.py``, ``cli/benchmark.py``) against the JAX package's.

- ``run_inference`` over a folder of frames with a paired depth folder, and
  over a COCO json, against the JAX ``run_inference`` with the same
  weights: a reference ``.pth`` of ``tests/torch_ref.py``'s LateFusion
  replica (hidden 32, 1 + 2 layers, 12 queries) loaded into both by
  ``--resume``. The frames are 48x64 JPEGs with depth maps; with short
  side 48 and ``max_size`` 64 no frame is resized, so both CLIs see the
  same pixels (the port's decoder gives PIL's bits). The same file names
  come out, and every YOLO line's numbers agree within atol 1e-4 / rtol
  1e-3 (the forward's tolerance). The threshold: both runs keep every
  query (``keep_prob`` -1); then the port runs at a ``keep_prob`` with no
  probability within 1e-4 of it and must keep exactly JAX's lines above
  it.
- The overlay's rectangles against PIL's ``ImageDraw.rectangle(width=3)``
  pixel for pixel (the probability labels are the port's own bitmap
  glyphs, a known difference), and the overlay PNG read back by PIL.
- The ResNet-18 two-stage model the bare CLI builds, through
  ``cli.inference.main`` on random weights; more than one device refused.
- ``cli.benchmark.main`` for 2 iterations on the CPU. The JAX package's
  benchmark CLI cannot be run beside it: its parser adds
  ``--profile_dir`` a second time and argparse refuses it.
"""
import argparse
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from dfvod_tpu.cli import flags as j_flags
from dfvod_tpu.cli import inference as j_inference
from dfvod_tpu_torch.cli import benchmark
from dfvod_tpu_torch.cli import flags
from dfvod_tpu_torch.cli import inference
from torch_ref import TorchDeformableDETR

TOL = dict(atol=1e-4, rtol=1e-3)
H, W = 48, 64
MODEL_ARGS = ["--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1",
              "--dec_layers", "2", "--dim_feedforward", "64",
              "--num_queries", "12", "--dropout", "0", "--dilation",
              "--num_feature_levels", "1", "--with_box_refine",
              "--fusion_type", "LateFusion", "--eval_short_side", "48",
              "--max_size", "64"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Six 48x64 JPEG frames (a bright 16x16 box on noise) in ``images/``,
    their depth maps under the same names in ``depth/``, and a COCO json
    of them."""
    root = tmp_path_factory.mktemp("frames")
    (root / "images").mkdir()
    (root / "depth").mkdir()
    rng = np.random.default_rng(0)
    images = []
    for i in range(1, 7):
        rgb = rng.integers(0, 60, (H, W, 3), dtype=np.uint8)
        x, y = int(rng.integers(4, 44)), int(rng.integers(4, 28))
        rgb[y:y + 16, x:x + 16] = 230
        Image.fromarray(rgb).save(root / "images" / f"f{i}.jpg")
        Image.fromarray(rgb[..., 0]).save(root / "depth" / f"f{i}.jpg")
        images.append({"id": i, "file_name": f"f{i}.jpg", "width": W,
                       "height": H})
    (root / "frames.json").write_text(json.dumps(
        {"images": images, "annotations": [],
         "categories": [{"id": 1, "name": "Hand"}]}))
    return root


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
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


def configs(*extra):
    argv = [*MODEL_ARGS, "--dformer_backbone", *extra]
    return (flags.config_from_args(
                inference.get_parser().parse_args(argv)),
            j_flags.config_from_args(j_flags.get_args_parser(
                video=True).parse_args(argv)))


def read_lines(out):
    """{file stem: (n, 5) array of the lines' numbers}; every line starts
    with the class name."""
    got = {}
    for f in sorted(os.listdir(out)):
        if f.endswith(".txt"):
            rows = [ln.split() for ln in open(os.path.join(out, f))]
            assert all(r[0] == "Hand" and len(r) == 6 for r in rows)
            got[f[:-4]] = np.array([[float(v) for v in r[1:]]
                                    for r in rows]).reshape(-1, 5)
    return got


@pytest.fixture(scope="module")
def runs(tree, reference_pth, tmp_path_factory):
    """Both CLIs' ``run_inference`` over the folder and the COCO json,
    every query kept."""
    mp = pytest.MonkeyPatch()
    mp.setenv("DFVOD_CV2", "0")
    mp.setenv("DFVOD_JAX_CACHE", str(tmp_path_factory.mktemp("jax_cache")))
    inputs = {"folder": dict(img_folder=str(tree / "images"),
                             depth_folder=str(tree / "depth")),
              "coco": dict(inference_coco_path=str(tree / "frames.json"),
                           coco_img_folder=str(tree / "images"),
                           depth_folder=str(tree / "depth"))}
    port_cfg, jax_cfg = configs()
    out = {}
    try:
        for mode, kw in inputs.items():
            for name, run, cfg in (
                    ("jax", j_inference.run_inference, jax_cfg),
                    ("port", lambda **a: inference.run_inference(
                        device="cpu", **a), port_cfg)):
                d = tmp_path_factory.mktemp(f"{name}_{mode}")
                run(cfg=cfg, resume=reference_pth, output_dir=str(d),
                    keep_prob=-1.0, **kw)
                out[name, mode] = d
    finally:
        mp.undo()
    return out, inputs, port_cfg


@pytest.mark.parametrize("mode", ["folder", "coco"])
def test_yolo_lines_equal_jax(runs, mode, reference_pth, tmp_path):
    out, inputs, port_cfg = runs
    jdir, pdir = out["jax", mode], out["port", mode]
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    names = sorted(f[:-4] for f in os.listdir(pdir) if f.endswith(".txt"))
    assert names == ([f"f{i}" for i in range(1, 7)] if mode == "folder"
                     else [f"img_{i}" for i in range(1, 7)])
    jl, pl = read_lines(jdir), read_lines(pdir)
    for k in jl:
        assert jl[k].shape == pl[k].shape == (12, 5)
        np.testing.assert_allclose(pl[k], jl[k], **TOL, err_msg=k)

    # a threshold with no probability within 1e-4 of it, near the median
    probs = np.sort(np.concatenate([v[:, 4] for v in jl.values()]))
    gaps = np.diff(probs)
    mid = len(probs) // 2
    i = mid - 8 + int(np.argmax(gaps[mid - 8:mid + 8]))
    assert gaps[i] > 2e-4
    keep = float(probs[i] + probs[i + 1]) / 2
    kept = tmp_path / "kept"
    inference.run_inference(cfg=port_cfg, resume=reference_pth,
                            output_dir=str(kept), keep_prob=keep,
                            device="cpu", **inputs[mode])
    got = read_lines(kept)
    for k in jl:
        want = jl[k][jl[k][:, 4] > keep]
        assert got[k].shape == want.shape
        np.testing.assert_allclose(got[k], want, **TOL, err_msg=k)


def test_overlay_rectangles_equal_pil(tmp_path):
    """``draw_rectangle`` gives PIL's outline at width 3 (and 1, 2) for
    boxes inside, across and outside the frame and thinner than the
    width; ``save_overlay`` writes a PNG of the frame's size that PIL
    reads, red where a box is."""
    rng = np.random.default_rng(1)
    for _ in range(500):
        x0, y0 = rng.uniform(-10, 70, 2)
        xy = [x0, y0, x0 + abs(rng.normal(0, 15)),
              y0 + abs(rng.normal(0, 15))]
        width = int(rng.integers(1, 4))
        im = Image.new("RGB", (W, H))
        ImageDraw.Draw(im).rectangle(xy, outline=(255, 0, 0), width=width)
        got = np.zeros((H, W, 3), np.uint8)
        inference.draw_rectangle(got, xy, (255, 0, 0), width=width)
        np.testing.assert_array_equal(got, np.asarray(im), err_msg=str(xy))
    rgb = np.zeros((H, W, 3), np.uint8)
    dets = {"boxes_cxcywh": np.array([[0.5, 0.5, 0.5, 0.5]], np.float32),
            "probs": np.array([0.87], np.float32), "orig_size": (H, W)}
    path = tmp_path / "o.png"
    inference.save_overlay(dets, rgb, str(path))
    back = np.asarray(Image.open(path))
    assert back.shape == (H, W, 3)
    assert (back[12, 16:49] == (255, 0, 0)).all()
    assert back[0:7].any()            # the label above the box


def test_bare_cli_runs_resnet18_two_stage_and_refuses_devices(tree,
                                                              tmp_path):
    """``--fusion_type LateFusion --two_stage`` without
    ``--dformer_backbone``: the ResNet-18 two-stage model on random weights
    writes one txt and one PNG per frame; ``--num_devices 2`` raises the
    JAX sharding's divisibility error, a single frame per forward over 2
    processes (before any process starts)."""
    argv = [*MODEL_ARGS, "--two_stage", "--img_folder",
            str(tree / "images"), "--depth_folder", str(tree / "depth"),
            "--output_dir", str(tmp_path / "out"), "--keep_prob", "0.2"]
    cfg = flags.config_from_args(inference.get_parser().parse_args(argv))
    assert (cfg.model.depth_backbone_type, cfg.model.two_stage) == (
        "resnet18", True)
    results = inference.main(argv, device="cpu")
    assert len(results) == 6
    files = sorted(os.listdir(tmp_path / "out"))
    assert files == sorted([f"f{i}.{e}" for i in range(1, 7)
                            for e in ("png", "txt")])
    for r in results:
        assert (r["probs"] > 0.2).all() and r["boxes_cxcywh"].shape[1] == 4
    with pytest.raises(ValueError, match="should be divisible by 2, but "
                                         "it is equal to 1"):
        inference.main([*argv, "--num_devices", "2"], device="cpu")


def test_benchmark_cli_on_the_cpu(capsys, tmp_path):
    """Two iterations after one warm-up at 64x96; the line names the
    device; ``--profile_dir`` writes a trace."""
    argv = [*MODEL_ARGS, "--dformer_backbone", "--height", "64", "--width",
            "96", "--num_iters", "2", "--warm_iters", "1", "--profile_dir",
            str(tmp_path / "prof")]
    t = benchmark.main(argv, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert t > 0 and line.startswith("Average inference time: ")
    assert line.endswith("device cpu cpu)")
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
