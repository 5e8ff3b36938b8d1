"""The port's offline tools (``dfvod_tpu_torch/tools``) and plots
(``utils/visualization.py``) against the JAX package's, on the same files
and inputs:

- ``calculate_mean_std`` over a tree of JPEGs (``datasets/synth_rgbd``,
  which the port decodes bitwise like PIL) and PNGs of every kind the
  port reads, RGB and ``--grayscale``: equal within 1e-12 (measured
  bitwise);
- ``yolo_to_coco``, flat and nested: the JSON equal;
- ``yolo_eval`` on ``tests/test_tools.py``'s perfect, FP-and-miss and
  duplicate cases and on seeded random ones: the dicts equal;
- ``rgb2d`` with the same stub pipe: the tree mirrored, each output PNG
  decoded equal to JAX's written PNG (for a ``.jpg`` name, where JAX
  writes a lossy JPEG, to the array JAX encodes), a constant depth map
  zero; without a pipe, the pipeline built on the device asked for (the
  card by default);
- the eight plots of ``utils/visualization.py`` (matplotlib Agg): each
  port figure decoded equal to JAX's, pixel for pixel.
"""
import io
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from dfvod_tpu.tools import calculate_mean_std as j_mean_std
from dfvod_tpu.tools import rgb2d as j_rgb2d
from dfvod_tpu.tools import yolo_eval as j_yolo_eval
from dfvod_tpu.tools import yolo_to_coco as j_yolo_to_coco
from dfvod_tpu_torch.data import image_io
from dfvod_tpu_torch.tools import calculate_mean_std, rgb2d, yolo_eval
from dfvod_tpu_torch.tools import yolo_to_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

SYNTH = Path(REPO) / "datasets" / "synth_rgbd" / "coco"


def write_tree(root: Path, seed=0):
    """JPEGs of synth_rgbd (RGB frames and grey depth maps) and PNGs of
    every kind: Pillow's grey, RGB, palette, grey + alpha, RGBA and 16-bit
    grey, and ``chip_smoke.png_bytes``' Adam7 RGB, 1/2/4-bit grey, 4-bit
    palette and 16-bit RGB, in nested folders."""
    rng = np.random.default_rng(seed)
    for sub, src in (("rgb", "images"), ("depth", "depth_pred")):
        (root / sub).mkdir(parents=True)
        for f in sorted((SYNTH / src).glob("*.jpg"))[:6]:
            shutil.copy(f, root / sub / f.name)
    png = root / "png" / "deeper"
    png.mkdir(parents=True)
    for mode, ch in (("L", 1), ("RGB", 3), ("LA", 2), ("RGBA", 4)):
        arr = rng.integers(0, 256, (19, 23, ch), dtype=np.uint8)
        Image.fromarray(arr[..., 0] if ch == 1 else arr, mode).save(
            png / f"{mode}.png")
    p = Image.fromarray(rng.integers(0, 37, (19, 23), dtype=np.uint8), "P")
    p.putpalette(rng.integers(0, 256, 111, dtype=np.uint8).tobytes())
    p.save(png / "P.png")
    Image.fromarray(rng.integers(0, 65536, (19, 23), dtype=np.uint16)).save(
        png / "I16.PNG")
    files = {
        "adam7.png": chip_smoke.png_bytes(
            rng.integers(0, 256, (21, 17, 3), dtype=np.uint8),
            interlace=True),
        "grey1.png": chip_smoke.png_bytes(
            rng.integers(0, 2, (13, 29), dtype=np.uint8), depth=1),
        "grey2.png": chip_smoke.png_bytes(
            rng.integers(0, 4, (13, 29), dtype=np.uint8), depth=2,
            interlace=True),
        "grey4.png": chip_smoke.png_bytes(
            rng.integers(0, 16, (13, 29), dtype=np.uint8), depth=4),
        "pal4.png": chip_smoke.png_bytes(
            rng.integers(0, 16, (13, 29), dtype=np.uint8), depth=4,
            palette=rng.integers(0, 256, (16, 3), dtype=np.uint8)),
        "rgb16.png": chip_smoke.png_bytes(
            rng.integers(0, 65536, (11, 9, 3), dtype=np.uint16)),
    }
    for name, data in files.items():
        (root / "png" / name).write_bytes(data)
    (root / "notes.txt").write_text("not an image")


def test_calculate_mean_std_matches_jax(tmp_path):
    write_tree(tmp_path)
    for gray in (False, True):
        mean, std = calculate_mean_std.compute_mean_std(str(tmp_path), gray)
        jmean, jstd = j_mean_std.compute_mean_std(str(tmp_path), gray)
        assert mean.shape == jmean.shape == ((1,) if gray else (3,))
        np.testing.assert_allclose(mean, jmean, rtol=0, atol=1e-12)
        np.testing.assert_allclose(std, jstd, rtol=0, atol=1e-12)
    # a constant image (``tests/test_tools.py::TestMeanStd``)
    const = tmp_path / "const"
    const.mkdir()
    Image.fromarray(np.full((8, 8, 3), 128, np.uint8)).save(const / "x.png")
    mean, std = calculate_mean_std.compute_mean_std(str(const))
    np.testing.assert_allclose(mean, 128 / 255, atol=1e-6)
    np.testing.assert_allclose(std, 0, atol=1e-6)


def test_calculate_mean_std_cli_prints_like_jax(tmp_path, capsys):
    write_tree(tmp_path, seed=1)
    for argv in ([str(tmp_path)], [str(tmp_path), "--grayscale"]):
        calculate_mean_std.main(argv)
        got = capsys.readouterr().out
        j_mean_std.main(argv)
        assert got == capsys.readouterr().out


def yolo_tree(root: Path, nested: bool, seed=0):
    """Images (JPEG and PNG, various sizes, a progressive JPEG the port's
    decoder refuses but whose header it reads) and YOLO labels, one folder
    per video when ``nested``."""
    rng = np.random.default_rng(seed)
    folders = ["v1", "v2"] if nested else [""]
    for v in folders:
        (root / "images" / v).mkdir(parents=True, exist_ok=True)
        (root / "labels" / v).mkdir(parents=True, exist_ok=True)
        for i in range(4):
            h, w = (int(s) for s in rng.integers(8, 64, 2))
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            name = f"f{i}.{('jpg', 'png', 'jpeg', 'JPG')[i]}"
            Image.fromarray(arr).save(root / "images" / v / name,
                                      format="PNG" if i == 1 else "JPEG",
                                      **({"progressive": True} if i == 3
                                         else {}))
            if i == 2:
                continue              # an image without labels
            lines = [f"{int(rng.integers(0, 2))} " + " ".join(
                f"{x:.6f}" for x in rng.random(4)) for _ in range(i + 1)]
            if i == 0:
                lines.append("0 0.5")  # a short line is skipped
            (root / "labels" / v / f"f{i}.txt").write_text(
                "\n".join(lines) + "\n")


@pytest.mark.parametrize("nested", [False, True])
def test_yolo_to_coco_matches_jax(tmp_path, nested):
    yolo_tree(tmp_path, nested, seed=int(nested))
    args = (str(tmp_path / "images"), str(tmp_path / "labels"))
    got = yolo_to_coco.yolo_folder_to_coco(*args, nested=nested)
    ref = j_yolo_to_coco.yolo_folder_to_coco(*args, nested=nested)
    assert json.dumps(got) == json.dumps(ref)
    assert len(got["images"]) == (8 if nested else 4)
    cats = tmp_path / "cats.txt"
    cats.write_text("hand\nface\n")
    for mod in (yolo_to_coco, j_yolo_to_coco):
        mod.main(["--images_dir", args[0], "--labels_dir", args[1],
                  "--output", str(tmp_path / f"{mod.__name__}.json"),
                  "--categories_file", str(cats)]
                 + (["--nested"] if nested else []))
    files = [tmp_path / f"{m.__name__}.json"
             for m in (yolo_to_coco, j_yolo_to_coco)]
    assert files[0].read_text() == files[1].read_text()


def test_image_size_reads_headers_like_pil(tmp_path):
    """JPEG (baseline, progressive, grey) and PNG sizes from their headers,
    as PIL's ``size``; a file of neither kind raises."""
    rng = np.random.default_rng(3)
    for i, (fmt, kw) in enumerate((("JPEG", {}), ("JPEG",
                                                  {"progressive": True}),
                                   ("PNG", {}))):
        arr = rng.integers(0, 256, (17 + i, 31 - i), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt, **kw)
        w, h = Image.open(io.BytesIO(buf.getvalue())).size
        assert image_io.image_size(buf.getvalue()) == (h, w)
    with pytest.raises(ValueError, match="not a JPEG or PNG"):
        image_io.image_size(b"GIF89a" + bytes(20))


def write_yolo(d: Path, name, lines):
    d.mkdir(exist_ok=True)
    (d / name).write_text("\n".join(lines) + "\n")


YOLO_CASES = {
    "perfect": (["Hand 0.5 0.5 0.2 0.2"], ["Hand 0.5 0.5 0.2 0.2 0.9"]),
    "fp_and_miss": (["Hand 0.5 0.5 0.2 0.2", "Hand 0.2 0.2 0.1 0.1"],
                    ["Hand 0.5 0.5 0.2 0.2 0.9", "Hand 0.8 0.8 0.1 0.1 0.3"]),
    "duplicate": (["Hand 0.5 0.5 0.2 0.2"],
                  ["Hand 0.5 0.5 0.2 0.2 0.9", "Hand 0.5 0.5 0.2 0.2 0.8"]),
}


@pytest.mark.parametrize("case", list(YOLO_CASES) + ["random"])
def test_yolo_eval_matches_jax(tmp_path, case):
    gt, pr = tmp_path / "gt", tmp_path / "pred"
    if case == "random":
        rng = np.random.default_rng(4)
        for i in range(12):
            boxes = rng.random((int(rng.integers(0, 5)), 4)) * 0.5 + 0.1
            write_yolo(gt, f"{i}.txt", [
                f"{('Hand', 'Face')[j % 2]} " + " ".join(map(str, b))
                for j, b in enumerate(boxes)])
            if i % 5 == 4:
                continue              # no prediction file
            preds = [f"{('Hand', 'Face')[j % 2]} " + " ".join(
                map(str, b + rng.normal(0, 0.03, 4))) + f" {rng.random()}"
                for j, b in enumerate(boxes)]
            preds += [f"Hand {' '.join(map(str, rng.random(4)))} "
                      f"{rng.random()}" for _ in range(int(rng.integers(3)))]
            write_yolo(pr, f"{i}.txt", preds)
    else:
        write_yolo(gt, "a.txt", YOLO_CASES[case][0])
        write_yolo(pr, "a.txt", YOLO_CASES[case][1])
    got = yolo_eval.evaluate_yolo_dirs(str(gt), str(pr))
    ref = j_yolo_eval.evaluate_yolo_dirs(str(gt), str(pr))
    assert got == ref
    if case == "perfect":
        assert got["ap50"] == 1.0 and got["f1"] == 1.0
    if case == "duplicate":
        assert got["recall"] == 1.0 and got["f1"] == 1.0


class StubPipe:
    """A depth "model": a seeded map per file name (the port's pipe gets a
    path, the JAX package's a PIL image opened from it); ``const.*`` gives
    a constant map. Records what it was given."""

    def __init__(self):
        self.given = []

    def __call__(self, image):
        self.given.append(image)
        name = Path(getattr(image, "filename", image)).name
        if name.startswith("const"):
            return {"depth": np.full((6, 10), 3.5)}
        rng = np.random.default_rng(sum(name.encode()))
        return {"depth": rng.random((12, 16)) * 10}


def test_rgb2d_matches_jax(tmp_path):
    inp = tmp_path / "in"
    (inp / "sub" / "deeper").mkdir(parents=True)
    rng = np.random.default_rng(5)
    for name in ("a.jpg", "sub/b.png", "sub/deeper/c.jpeg", "const.png",
                 "sub/d.JPG"):
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
                        ).save(inp / name,
                               format="PNG" if name.endswith("png")
                               else "JPEG")
    (inp / "skip.txt").write_text("x")
    pipe, jpipe = StubPipe(), StubPipe()
    n = rgb2d.convert_images_to_depth(str(inp), str(tmp_path / "out"),
                                      pipe=pipe)
    jn = j_rgb2d.convert_images_to_depth(str(inp), str(tmp_path / "jout"),
                                         pipe=jpipe)
    assert n == jn == 5
    assert all(isinstance(p, str) for p in pipe.given)
    rel = sorted(str(p.relative_to(tmp_path / "out"))
                 for p in (tmp_path / "out").rglob("*") if p.is_file())
    jrel = sorted(str(p.relative_to(tmp_path / "jout"))
                  for p in (tmp_path / "jout").rglob("*") if p.is_file())
    assert rel == jrel
    for r in rel:
        got = image_io.read_image(tmp_path / "out" / r)
        assert got.dtype == np.uint8 and got.ndim == 2
        np.testing.assert_array_equal(
            got, j_rgb2d.normalize_depth_to_uint8(
                StubPipe()(str(inp / r))["depth"]), err_msg=r)
        if r.endswith(".png"):
            np.testing.assert_array_equal(
                got, np.asarray(Image.open(tmp_path / "jout" / r)),
                err_msg=r)
    assert not image_io.read_image(tmp_path / "out" / "const.png").any()
    assert image_io.read_image(tmp_path / "out" / "a.jpg").max() == 255
    # the normalization itself (``tests/test_tools.py::TestRgb2d``)
    d = np.array([[1.0, 3.0], [5.0, 1.0]])
    np.testing.assert_array_equal(rgb2d.normalize_depth_to_uint8(d),
                                  j_rgb2d.normalize_depth_to_uint8(d))
    n = rgb2d.convert_images_to_depth(str(inp), str(tmp_path / "two"), 2,
                                      pipe=StubPipe())
    assert n == 2


def test_rgb2d_builds_its_pipeline_on_the_device(tmp_path, monkeypatch):
    """With no ``pipe``, ``rgb2d`` builds the HuggingFace pipeline (a stub
    ``transformers`` module here) on the device asked for, ``--device``
    included; with none given, on the card, raising where CUDA is
    absent."""
    import types

    import torch
    built = []

    def pipeline(**kw):
        built.append(kw)
        return StubPipe()
    monkeypatch.setitem(sys.modules, "transformers",
                        types.SimpleNamespace(pipeline=pipeline))
    inp = tmp_path / "in"
    inp.mkdir()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(inp / "a.png")
    rgb2d.main([str(inp), "--output_dir", str(tmp_path / "out"),
                "--model", "local/depth", "--device", "cpu"])
    assert built == [{"task": "depth-estimation", "model": "local/depth",
                      "device": torch.device("cpu")}]
    assert (tmp_path / "out" / "a.png").exists()
    if torch.cuda.is_available():
        rgb2d.convert_images_to_depth(str(inp), str(tmp_path / "card"))
        assert built[-1]["device"] == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rgb2d.convert_images_to_depth(str(inp), str(tmp_path / "card"))
        assert len(built) == 1


def plots(viz, out: Path):
    """Every plot of ``viz`` (the port's or the JAX module) on seeded
    inputs (``tests/test_tools.py``'s smoke test's), written under
    ``out``; returns the files."""
    rng = np.random.default_rng(6)
    out.mkdir()
    img = rng.integers(0, 255, (32, 48, 3)).astype(np.uint8)
    viz.visualize_feature_map(
        rng.standard_normal((8, 12, 6)).astype(np.float32),
        str(out / "f.png"))
    viz.visualize_reference_points(rng.random((40, 2)), (32, 48),
                                   str(out / "r.png"))
    viz.visualize_attention_map(img, rng.random((8, 12)).astype(np.float32),
                                str(out / "a.png"))
    viz.visualize_sampling_locations(
        img, rng.random((2, 4, 1, 4, 2)).astype(np.float32),
        rng.random((2, 4, 1, 4)).astype(np.float32), str(out / "s.png"))
    logs = out / "logs"
    logs.mkdir()
    (logs / "log.txt").write_text("\n".join(json.dumps(r) for r in (
        {"epoch": 0, "train_loss": 1.0}, {"epoch": 1, "train_loss": 0.5},
        {"note": "no epoch"})) + "\n")
    viz.plot_logs([str(logs)], path=str(out / "curves.png"))
    viz.visualize_queries(rng.standard_normal(64), str(out / "q1.png"))
    viz.visualize_queries(rng.standard_normal((10, 64)), str(out / "q2.png"))
    viz.visualize_position_embeddings(
        rng.standard_normal((8, 12, 32)), str(out / "pe.png"),
        num_channels=8)
    viz.visualize_attention_points(
        rng.random((8, 12)), rng.random((2, 4, 1, 4, 2)),
        rng.random((2, 4, 1, 4)), str(out / "ap.png"))
    return sorted(p.name for p in out.glob("*.png"))


def test_visualization_figures_equal_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from dfvod_tpu.utils import visualization as j_viz
    from dfvod_tpu_torch.utils import visualization as viz
    files = plots(viz, tmp_path / "port")
    assert files == plots(j_viz, tmp_path / "jax")
    assert len(files) == 9             # 8 functions, queries 1-D and 2-D
    for f in files:
        got = np.asarray(Image.open(tmp_path / "port" / f))
        ref = np.asarray(Image.open(tmp_path / "jax" / f))
        assert got.shape == ref.shape and got.size > 0, f
        np.testing.assert_array_equal(got, ref, err_msg=f)
