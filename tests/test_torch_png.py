"""The port's PNG reader (``dfvod_tpu_torch/data/image_io.py`` over
``csrc/png_unfilter.cpp``) against PIL and cv2, which the JAX package reads
frames with (``PIL.Image.open(f).convert("RGB")`` for RGB,
``cv2.imread(f, IMREAD_UNCHANGED)`` for depth,
``dfvod_tpu/data/dataset.py:27-44``):

- seeded files that PIL and cv2 write (grey, RGB, palette with and without
  ``tRNS``, grey + alpha, RGBA, 16-bit grey) at 1x1, 9x17 and 37x53:
  ``read_rgb`` bitwise PIL's, ``read_image`` bitwise cv2's (in RGB order);
- files written by ``chip_smoke.png_bytes`` with each of the five row
  filters alone and all five in turn, the IDAT stream split over chunks:
  bitwise the array encoded, PIL and cv2;
- the kinds Pillow does not write, by ``chip_smoke.png_bytes``: 1/2/4-bit
  grey and palette samples and 16-bit RGB, RGBA and grey + alpha, each
  non-interlaced and Adam7-interlaced, at 1x1, 9x17 and 37x53: bitwise
  PIL, cv2 and (``read_luma``) PIL's ``convert("L")``;
- 16-bit depth maps through ``load_depth`` bitwise the JAX package's;
- the cases once refused (Adam7, 1-bit grey, 16-bit RGB) read like PIL and
  cv2, and the refusals, each a ``ValueError`` naming what is wrong: a
  bad CRC, a truncated file, a bad filter byte.
"""
import io
import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from dfvod_tpu.data import dataset as j_dataset
from dfvod_tpu_torch.data import dataset, image_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

SIZES = [(1, 1), (9, 17), (37, 53)]
MODES = ["L", "RGB", "P", "P_tRNS", "LA", "RGBA", "I;16"]


def seeded(mode, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if mode == "I;16":
        return Image.fromarray(rng.integers(0, 65536, (h, w),
                                            dtype=np.uint16))
    if mode in ("P", "P_tRNS"):
        # 37 palette entries: Pillow writes 8-bit indices
        img = Image.fromarray(rng.integers(0, 37, (h, w), dtype=np.uint8),
                              "P")
        img.putpalette(rng.integers(0, 256, 37 * 3, dtype=np.uint8)
                       .tobytes())
        if mode == "P_tRNS":
            img.info["transparency"] = bytes(rng.integers(
                0, 256, 20, dtype=np.uint8))
        return img
    channels = {"L": 1, "RGB": 3, "LA": 2, "RGBA": 4}[mode]
    arr = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    return Image.fromarray(arr[..., 0] if channels == 1 else arr, mode)


def pil_png(img):
    buf = io.BytesIO()
    img.save(buf, format="PNG", **({"transparency": img.info["transparency"]}
                                   if "transparency" in img.info else {}))
    return buf.getvalue()


def cv2_rgb_order(ref):
    return ref[..., [2, 1, 0, 3][:ref.shape[-1]]] if ref.ndim == 3 else ref


def assert_reads_like_pil_and_cv2(data, msg=""):
    np.testing.assert_array_equal(
        image_io.read_rgb(data),
        np.asarray(Image.open(io.BytesIO(data)).convert("RGB")),
        err_msg=msg)
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    got = image_io.read_image(data)
    assert got.dtype == ref.dtype, msg
    np.testing.assert_array_equal(got, cv2_rgb_order(ref), err_msg=msg)


@pytest.mark.parametrize("mode", MODES)
def test_pil_written_png_reads_like_pil_and_cv2(mode):
    for h, w in SIZES:
        img = seeded(mode, h, w, seed=h * w)
        data = pil_png(img)
        assert_reads_like_pil_and_cv2(data, f"{mode} {h}x{w}")
        if mode == "P_tRNS":
            assert image_io.read_image(data).shape == (h, w, 4)


@pytest.mark.parametrize("kind", ["grey", "grey16", "bgr", "bgra"])
def test_cv2_written_png_reads_like_pil_and_cv2(kind, tmp_path):
    rng = np.random.default_rng(3)
    shape = {"grey": (37, 53), "grey16": (37, 53), "bgr": (37, 53, 3),
             "bgra": (37, 53, 4)}[kind]
    dtype = np.uint16 if kind == "grey16" else np.uint8
    arr = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    f = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(f, arr)
    assert_reads_like_pil_and_cv2(open(f, "rb").read(), kind)
    np.testing.assert_array_equal(image_io.read_image(f),
                                  cv2_rgb_order(arr))


FILTERS = {"none": (0,), "sub": (1,), "up": (2,), "average": (3,),
           "paeth": (4,), "all": chip_smoke.PNG_FILTERS}


@pytest.mark.parametrize("filters", list(FILTERS))
def test_every_row_filter_decodes_the_encoded_array(filters):
    rng = np.random.default_rng(len(filters))
    for shape, dtype in (((37, 53), np.uint8), ((37, 53), np.uint16),
                         ((9, 17, 3), np.uint8), ((9, 17, 2), np.uint8),
                         ((37, 53, 4), np.uint8), ((1, 1, 3), np.uint8)):
        arr = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
        data = chip_smoke.png_bytes(arr, FILTERS[filters], chunk=97)
        got = image_io.read_image(data)
        want = arr[..., [0, 0, 0, 1]] if arr.ndim == 3 and \
            arr.shape[2] == 2 else arr
        np.testing.assert_array_equal(got, want, err_msg=str(shape))
        assert_reads_like_pil_and_cv2(data, f"{filters} {shape}")


# (kind, depth, channels or None for palette indices)
WRITTEN = {"grey1": (1, 1), "grey2": (2, 1), "grey4": (4, 1),
           "palette1": (1, None), "palette2": (2, None),
           "palette4": (4, None), "rgb16": (16, 3), "rgba16": (16, 4),
           "grey_alpha16": (16, 2)}


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("kind", list(WRITTEN))
def test_low_bit_and_sixteen_bit_png_read_like_pil_and_cv2(kind, interlace):
    depth, channels = WRITTEN[kind]
    for h, w in SIZES:
        rng = np.random.default_rng(h * w + depth)
        if depth == 16:
            arr = rng.integers(0, 65536, (h, w, channels), dtype=np.uint16)
            data = chip_smoke.png_bytes(arr, interlace=interlace)
        else:
            arr = rng.integers(0, 1 << depth, (h, w), dtype=np.uint8)
            palette = (None if channels else rng.integers(
                0, 256, (1 << depth, 3), dtype=np.uint8))
            data = chip_smoke.png_bytes(arr, depth=depth, palette=palette,
                                        interlace=interlace)
        msg = f"{kind} {h}x{w} interlace={interlace}"
        assert_reads_like_pil_and_cv2(data, msg)
        np.testing.assert_array_equal(
            image_io.read_luma(data),
            np.asarray(Image.open(io.BytesIO(data)).convert("L")),
            err_msg=msg)
        got = image_io.read_image(data)
        if depth == 16:
            want = arr[..., [0, 0, 0, 1]] if channels == 2 else arr
        elif channels:
            want = arr * (255 // ((1 << depth) - 1))
        else:
            want = palette[arr]
        np.testing.assert_array_equal(got, want, err_msg=msg)


def test_sixteen_bit_depth_load_depth_equals_jax(tmp_path):
    """Depth maps as the reference stores them, 16-bit grey PNG: the
    min-max to uint8 bitwise the JAX package's (cv2) on seeded maps, a
    constant map and one with a narrow range."""
    rng = np.random.default_rng(7)
    maps = [rng.integers(0, 65536, (37, 53), dtype=np.uint16),
            (rng.integers(0, 3000, (64, 48)) + 500).astype(np.uint16),
            np.full((5, 7), 1234, np.uint16),
            rng.integers(0, 256, (9, 17), dtype=np.uint8)]
    for k, m in enumerate(maps):
        f = str(tmp_path / f"d{k}.png")
        assert cv2.imwrite(f, m)
        got = dataset.load_depth(f)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, j_dataset.load_depth(f),
                                      err_msg=str(k))
    f = str(tmp_path / "rgb.png")
    cv2.imwrite(f, rng.integers(0, 256, (5, 7, 3), dtype=np.uint8))
    with pytest.raises(ValueError, match="3 channels"):
        dataset.load_depth(f)


def patched_ihdr(data, **fields):
    """``data`` with IHDR fields replaced and its CRC recomputed."""
    names = ("width", "height", "depth", "ctype", "comp", "filter",
             "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    body = b"IHDR" + struct.pack(">IIBBBBB", *(vals[n] for n in names))
    return (data[:12] + body + struct.pack(">I", zlib.crc32(body))
            + data[33:])


def refused(name):
    arr = np.random.default_rng(1).integers(0, 256, (9, 17, 3),
                                            dtype=np.uint8)
    good = chip_smoke.png_bytes(arr)
    if name == "adam7":
        # Pillow writes no interlaced PNG
        return chip_smoke.png_bytes(arr, interlace=True)
    if name == "grey1":
        return pil_png(Image.fromarray(arr[..., 0]).convert("1"))
    if name == "rgb16":
        return chip_smoke.png_bytes(arr.astype(np.uint16) * 257 + 3)
    if name == "crc":
        return good[:-5] + bytes([good[-5] ^ 1]) + good[-4:]
    if name == "truncated":
        return good[:len(good) // 2]
    if name == "filter":
        raw = bytearray(zlib.decompress(good[41:good.index(b"IEND") - 8]))
        raw[0] = 7
        comp = zlib.compress(bytes(raw))
        idat = (struct.pack(">I", len(comp)) + b"IDAT" + comp
                + struct.pack(">I", zlib.crc32(b"IDAT" + comp)))
        return good[:33] + idat + good[good.index(b"IEND") - 4:]
    raise KeyError(name)


# what each case raises; None: read like PIL and cv2 (the first three were
# refused until the reader took Adam7, 1/2/4-bit and 16-bit colour PNGs)
REFUSALS = {"adam7": None, "grey1": None, "rgb16": None,
            "crc": "fails its CRC", "truncated": "truncated PNG",
            "filter": "unknown filter"}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_unsupported_and_corrupt_png_raise_naming_them(name):
    data = refused(name)
    if REFUSALS[name] is None:
        assert_reads_like_pil_and_cv2(data, name)
        return
    for read in (image_io.read_rgb, image_io.read_image):
        with pytest.raises(ValueError, match=REFUSALS[name]):
            read(data)
