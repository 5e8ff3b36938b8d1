"""The port's JPEG decoder (``dfvod_tpu_torch/data/image_io.py`` over
``csrc/jpeg_decode.cpp``) against PIL and cv2, which the JAX package reads
frames with (``dfvod_tpu/data/dataset.py:27-44``, ``:162-174``):

- every JPEG of ``datasets/synth_rgbd`` bitwise equal to
  ``np.asarray(PIL.Image.open(f).convert("RGB"))`` and to ``cv2.imread(f,
  IMREAD_UNCHANGED)``; the digest of those frames is ``chip_smoke.py``'s
  ``SYNTH_RGBD_DECODE_SHA256``, which the card run reproduces;
- files that Pillow encodes: 4:4:4, 4:2:2, 4:2:0 and grayscale at 1x1,
  9x17 and 37x53, quality 5 and 100, optimized tables, restart markers,
  each bitwise equal to PIL and cv2;
- refusals: progressive, CMYK, truncated, PNG, not a JPEG, a colour file
  read as gray;
- ``load_depth`` bitwise equal to the JAX package's;
- no module of the port imports PIL or cv2.
"""
import io
import itertools
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from dfvod_tpu.data import dataset as j_dataset
from dfvod_tpu_torch.data import dataset, image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

IMAGES, DEPTHS = chip_smoke.synth_jpegs()


def pil_rgb(src):
    return np.asarray(Image.open(src if isinstance(src, str)
                                 else io.BytesIO(src)).convert("RGB"))


def cv2_unchanged(src):
    if isinstance(src, str):
        return cv2.imread(src, cv2.IMREAD_UNCHANGED)
    return cv2.imdecode(np.frombuffer(src, np.uint8), cv2.IMREAD_UNCHANGED)


def test_synth_rgbd_has_the_frames_the_digest_covers():
    assert len(IMAGES) == len(DEPTHS) == 300


@pytest.mark.parametrize("kind", ["images", "depth_pred"])
def test_synth_rgbd_decodes_bitwise_as_pil_and_cv2(kind):
    """Every file: ``read_rgb`` equals PIL's RGB and ``read_image`` cv2's
    unchanged read (colour in RGB order, gray as (H, W))."""
    files = IMAGES if kind == "images" else DEPTHS
    for f in files:
        np.testing.assert_array_equal(image_io.read_rgb(f), pil_rgb(f),
                                      err_msg=f)
        ref = cv2_unchanged(f)
        got = image_io.read_image(f)
        if ref.ndim == 3:
            ref = ref[..., ::-1]
        else:
            np.testing.assert_array_equal(image_io.read_gray(f), ref,
                                          err_msg=f)
        np.testing.assert_array_equal(got, ref, err_msg=f)


def test_decode_digest_is_chip_smokes_constant():
    """The digest of PIL's RGB frames and cv2's depth frames is the constant
    that ``chip_smoke.py`` holds the card machine's decode to, and the
    port's decode gives it."""
    ref = chip_smoke.decode_digest(
        pil_rgb, lambda f: cv2.imread(f, cv2.IMREAD_UNCHANGED))
    assert ref == chip_smoke.SYNTH_RGBD_DECODE_SHA256
    assert chip_smoke.decode_digest(image_io.read_rgb,
                                    image_io.read_gray) == ref


def encode(img, **kw):
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def frames_to_encode(h, w, seed=0):
    """A noisy and a smooth frame: noise drives every coefficient, the
    gradient the upsampling filters."""
    rng = np.random.default_rng(seed)
    noisy = rng.integers(0, 256, (h, w, 3), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    smooth = np.stack([(xx * 7 + yy * 3) % 256, (xx * 2) % 256,
                       (yy * 5) % 256], -1).astype(np.uint8)
    return noisy, smooth


# subsampling: Pillow's 0 = 4:4:4, 1 = 4:2:2, 2 = 4:2:0; None = grayscale
SAMPLINGS = {"444": 0, "422": 1, "420": 2, "gray": None}


@pytest.mark.parametrize("size", [(1, 1), (9, 17), (37, 53)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_pillow_encodings_decode_bitwise(sampling, size):
    """Quality 5 and 100, default and optimized Huffman tables, with and
    without restart markers every 2 blocks: bitwise PIL and cv2."""
    sub = SAMPLINGS[sampling]
    for arr in frames_to_encode(*size):
        img = Image.fromarray(arr if sub is not None else arr[..., 0])
        for quality, optimize, restart in itertools.product(
                (5, 100), (False, True), (0, 2)):
            kw = dict(quality=quality, optimize=optimize)
            if sub is not None:
                kw["subsampling"] = sub
            if restart:
                kw["restart_marker_blocks"] = restart
            data = encode(img, **kw)
            msg = f"{sampling} {size} {kw}"
            np.testing.assert_array_equal(image_io.read_rgb(data),
                                          pil_rgb(data), err_msg=msg)
            ref = cv2_unchanged(data)
            np.testing.assert_array_equal(
                image_io.read_image(data),
                ref[..., ::-1] if ref.ndim == 3 else ref, err_msg=msg)


def test_path_bytes_and_memoryview_decode_alike():
    f = IMAGES[0]
    with open(f, "rb") as fh:
        data = fh.read()
    ref = image_io.read_rgb(f)
    np.testing.assert_array_equal(image_io.read_rgb(data), ref)
    np.testing.assert_array_equal(image_io.read_rgb(memoryview(data)), ref)


def refused(name):
    arr = frames_to_encode(37, 53)[0]
    full = encode(Image.fromarray(arr))
    if name == "progressive":
        return encode(Image.fromarray(arr), progressive=True)
    if name == "cmyk":
        return encode(Image.fromarray(arr).convert("CMYK"))
    if name == "png":
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()
    if name == "not_jpeg":
        return b"GIF89a" + full[6:]
    cut = {"truncated_half": len(full) // 2, "truncated_scan_end":
           len(full) - 40, "truncated_no_eoi": len(full) - 2,
           "truncated_header": 100}[name]
    return full[:cut]


REFUSALS = {"progressive": "progressive", "cmyk": "CMYK", "png": "PNG",
            "not_jpeg": "not a JPEG", "truncated_half": "truncated",
            "truncated_scan_end": "truncated",
            "truncated_no_eoi": "truncated",
            "truncated_header": "truncated"}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_unsupported_and_truncated_files_raise_naming_them(name):
    data = refused(name)
    with pytest.raises(ValueError, match=REFUSALS[name]):
        image_io.read_rgb(data)
    if name.startswith("truncated"):
        # PIL refuses them too
        with pytest.raises(OSError):
            pil_rgb(data)


def test_colour_file_read_as_gray_raises():
    with pytest.raises(ValueError, match="3 channels"):
        image_io.read_gray(IMAGES[0])


def test_load_depth_equals_jax():
    """Every depth frame of synth_rgbd through both ``load_depth``s:
    bitwise."""
    for f in DEPTHS:
        np.testing.assert_array_equal(dataset.load_depth(f),
                                      j_dataset.load_depth(f), err_msg=f)


def test_load_depth_of_flat_and_colour_frames_as_jax(tmp_path):
    flat = tmp_path / "flat.jpg"
    Image.fromarray(np.full((16, 24), 77, np.uint8)).save(flat)
    np.testing.assert_array_equal(dataset.load_depth(str(flat)),
                                  j_dataset.load_depth(str(flat)))
    assert not dataset.load_depth(str(flat)).any()
    colour = tmp_path / "colour.jpg"
    Image.fromarray(frames_to_encode(16, 24)[0]).save(colour)
    for load in (dataset.load_depth, j_dataset.load_depth):
        with pytest.raises(ValueError, match="3 channels"):
            load(str(colour))


def test_port_imports_no_pil_or_cv2():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter: neither PIL nor cv2 is loaded (the card machine has
    neither)."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import dfvod_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'dfvod_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('PIL', 'cv2')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('dfvod_tpu_torch.')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20
