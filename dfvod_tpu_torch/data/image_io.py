"""Reading frames from disk: a baseline JPEG decoder in host C++
(``csrc/jpeg_decode.cpp``) and a PNG reader (the chunks and the inflate in
Python, the row unfiltering in host C++, ``csrc/png_unfilter.cpp``), bound
with ctypes.

Counterpart of the JAX package's ``PIL.Image.open(...).convert("RGB")``
(``dfvod_tpu/data/dataset.py:162-174``) and ``cv2.imread(...,
IMREAD_UNCHANGED)`` (``:29``): the decoder follows libjpeg-turbo's
routines, so it gives their bits. Neither PIL nor cv2 is used here (the
card machine has neither). The library is built at first use
(``ops/build.py::load_host``); a failed build raises.

Each reader takes a path or the file's ``bytes``. Unsupported JPEGs
(progressive, arithmetic-coded, 12-bit, lossless, CMYK) and truncated or
corrupt files raise ``ValueError`` naming what they are.

PNG: every colour type at every bit depth the format allows (grey at 1, 2,
4, 8 and 16 bits, palette at 1, 2, 4 and 8, RGB, grey + alpha and RGBA at
8 and 16), non-interlaced or Adam7-interlaced (each of the seven passes
unfiltered on its own, then scattered into the image). ``read_image``
gives the samples as ``cv2.imread(IMREAD_UNCHANGED)`` does, in RGB(A)
order: 1/2/4-bit grey scaled to 8 bits (x255, x85, x17), 16-bit samples
kept as uint16, grey + alpha as grey, grey, grey, alpha, and a palette
expanded (to RGBA when it has a ``tRNS`` chunk). ``read_rgb`` follows
PIL's ``convert("RGB")``: grey is repeated, alpha dropped, a palette
expanded, 16-bit grey clipped to 255, and other 16-bit samples cut to
their high byte. The IDAT stream is inflated with the standard library's
``zlib``. ``image_size`` reads a JPEG's or PNG's size from its header
alone, as ``PIL.Image.open(...).size`` does.

``encode_png`` writes an 8-bit grey, RGB or RGBA array as a PNG (every row
unfiltered, deflated by ``zlib``): the inference CLI's overlays and the
depth maps of ``tools/rgb2d.py``.
"""
from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib
from typing import Union

import numpy as np

from dfvod_tpu_torch.ops import build

Source = Union[str, os.PathLike, bytes]
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load_host("jpeg_decode")
    lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_int)]
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
                                ctypes.c_int, ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_strerror.argtypes = [ctypes.c_int]
    lib.jpeg_strerror.restype = ctypes.c_char_p
    return lib


def _read(src: Source):
    """(bytes, a name for messages)."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        return bytes(src), "<bytes>"
    with open(src, "rb") as f:
        return f.read(), os.fspath(src)


@functools.lru_cache(maxsize=1)
def _png_lib() -> ctypes.CDLL:
    lib = build.load_host("png_unfilter")
    lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_uint8)]
    lib.png_unfilter.restype = ctypes.c_int64
    return lib


# PNG colour type -> (name, samples per pixel, the bit depths allowed)
_PNG_TYPES = {0: ("grey", 1, (1, 2, 4, 8, 16)), 2: ("RGB", 3, (8, 16)),
              3: ("palette", 1, (1, 2, 4, 8)),
              4: ("grey + alpha", 2, (8, 16)), 6: ("RGBA", 4, (8, 16))}
# Adam7's passes: (first row, first column, row step, column step)
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _png_chunks(data: bytes, name: str):
    """The chunks after the signature as (type, payload), CRCs checked, up
    to IEND."""
    pos = len(_PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated PNG ({kind!r} chunk)")
        payload = data[pos + 8:end]
        crc, = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{name}: PNG chunk {kind!r} fails its CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos = end + 4


def _png_passes(h: int, w: int, interlace: int):
    """(first row, first column, row step, column step, rows, columns) of
    each non-empty pass: the whole image, or Adam7's seven."""
    passes = ((0, 0, 1, 1),) if not interlace else _ADAM7
    out = []
    for r0, c0, rs, cs in passes:
        ph, pw = -(-(h - r0) // rs), -(-(w - c0) // cs)
        if ph > 0 and pw > 0:
            out.append((r0, c0, rs, cs, ph, pw))
    return out


def _png_unfilter(raw: bytes, ph: int, pw: int, channels: int, depth: int,
                  name: str, first_row: int):
    """One pass's filtered rows -> (ph, pw, channels) samples, uint8 (1/2/4
    bits unpacked, most significant first; not yet scaled) or uint16.
    ``first_row``: the rows of the passes before it, for messages."""
    row = (pw * channels * depth + 7) // 8
    out = np.empty((ph, row), np.uint8)
    code = _png_lib().png_unfilter(
        raw, len(raw), ph, row, max(1, channels * depth // 8),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if code:
        raise ValueError(f"{name}: PNG row {first_row + code - 2} has an "
                         "unknown filter type")
    if depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        out = ((out[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            ph, -1)[:, :pw]
    elif depth == 16:
        out = out.view(">u2").astype(np.uint16)
    return out.reshape(ph, pw, channels)


def _read_png(data: bytes, name: str):
    """(samples (H, W, C) uint8 or uint16, colour type, bit depth, palette
    (N, 3) or None, palette alpha (N,) or None)."""
    chunks = list(_png_chunks(data, name))
    if not chunks or chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", chunks[0][1])
    if ctype not in _PNG_TYPES or comp or filt or interlace > 1:
        raise ValueError(f"{name}: PNG with colour type {ctype}, "
                         f"compression {comp}, filter method {filt}, "
                         f"interlace method {interlace}")
    kind, channels, depths = _PNG_TYPES[ctype]
    if depth not in depths:
        raise ValueError(f"{name}: {depth}-bit {kind} PNG (the format "
                         f"allows {', '.join(map(str, depths))} bits)")
    if not (0 < h < 1 << 16 and 0 < w < 1 << 16):
        raise ValueError(f"{name}: PNG of {w}x{h} pixels")
    palette = alpha = None
    idat = []
    for kind_, payload in chunks[1:]:
        if kind_ == b"IDAT":
            idat.append(payload)
        elif kind_ == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind_ == b"tRNS" and ctype == 3:
            alpha = np.frombuffer(payload, np.uint8)
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from None
    passes = _png_passes(h, w, interlace)
    sizes = [ph * (1 + (pw * channels * depth + 7) // 8)
             for *_, ph, pw in passes]
    if len(raw) != sum(sizes):
        raise ValueError(f"{name}: PNG image data of {len(raw)} bytes, not "
                         f"{sum(sizes)}")
    out = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
    pos = rows = 0
    for (r0, c0, rs, cs, ph, pw), n in zip(passes, sizes):
        out[r0::rs, c0::cs] = _png_unfilter(raw[pos:pos + n], ph, pw,
                                            channels, depth, name, rows)
        pos, rows = pos + n, rows + ph
    if ctype == 0 and depth < 8:
        out *= 255 // ((1 << depth) - 1)
    return out, ctype, depth, palette, alpha


def _png_palette(samples, palette, alpha, name, with_alpha):
    idx = samples[..., 0]
    if int(idx.max()) >= len(palette):
        raise ValueError(f"{name}: palette index beyond the PLTE chunk")
    rgb = palette[idx]
    if not with_alpha:
        return rgb
    a = np.full(len(palette), 255, np.uint8)
    a[:min(len(alpha), len(palette))] = alpha[:len(palette)]
    return np.concatenate([rgb, a[idx][..., None]], -1)


def _png_image(data: bytes, name: str) -> np.ndarray:
    samples, ctype, _, palette, alpha = _read_png(data, name)
    if ctype == 0:
        return samples[..., 0]
    if ctype == 3:
        return _png_palette(samples, palette, alpha, name, alpha is not None)
    if ctype == 4:
        return samples[..., [0, 0, 0, 1]]
    return samples


def _png_rgb(data: bytes, name: str) -> np.ndarray:
    samples, ctype, depth, palette, alpha = _read_png(data, name)
    if ctype == 3:
        return _png_palette(samples, palette, alpha, name, False)
    if depth == 16:
        # PIL opens 16-bit grey as "I;16", whose RGB clips, and the other
        # 16-bit types through their "...;16B" raw modes, the high bytes
        samples = (np.minimum(samples, 255) if ctype == 0
                   else samples >> 8).astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(samples[..., :1], 3, -1)
    return np.ascontiguousarray(samples[..., :3])


def _header(data: bytes, name: str):
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib = _lib()
    code = lib.jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w),
                           ctypes.byref(c))
    if code:
        raise ValueError(f"{name}: {lib.jpeg_strerror(code).decode()}")
    return h.value, w.value, c.value


def _decode(data: bytes, name: str, h: int, w: int, channels: int):
    out = np.empty((h, w, channels), np.uint8)
    lib = _lib()
    code = lib.jpeg_decode(data, len(data),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           h, w, channels)
    if code:
        raise ValueError(f"{name}: {lib.jpeg_strerror(code).decode()}")
    return out


def read_image(src: Source) -> np.ndarray:
    """The file's own samples, as ``cv2.imread(IMREAD_UNCHANGED)`` gives
    them but in RGB order: (H, W) uint8 for a grayscale JPEG, (H, W, 3) for
    a colour one; for a PNG see the module docstring ((H, W) uint16 for a
    16-bit grey map)."""
    data, name = _read(src)
    if data.startswith(_PNG_SIGNATURE):
        return _png_image(data, name)
    h, w, c = _header(data, name)
    out = _decode(data, name, h, w, 1 if c == 1 else 3)
    return out[..., 0] if c == 1 else out


def read_rgb(src: Source) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as ``PIL.Image.open(src).convert("RGB")``: a
    grayscale file's samples are repeated in the three channels."""
    data, name = _read(src)
    if data.startswith(_PNG_SIGNATURE):
        return _png_rgb(data, name)
    h, w, _ = _header(data, name)
    return _decode(data, name, h, w, 3)


def read_luma(src: Source) -> np.ndarray:
    """(H, W) uint8, as ``PIL.Image.open(src).convert("L")``: ITU-R 601-2
    luma of ``read_rgb`` in PIL's fixed point, ``(R * 19595 + G * 38470 +
    B * 7471 + 0x8000) >> 16`` (a grey file's own samples, since the
    weights sum to 65536)."""
    rgb = read_rgb(src).astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def image_size(src: Source):
    """(height, width) of a JPEG or PNG from its header alone (the PNG's
    IHDR, the JPEG's first frame header of any kind), as ``PIL.Image.open(
    src).size`` gives them (reversed), without decoding the image."""
    data, name = _read(src)
    if data.startswith(_PNG_SIGNATURE):
        if len(data) < 24 or data[12:16] != b"IHDR":
            raise ValueError(f"{name}: PNG without an IHDR chunk")
        w, h = struct.unpack(">II", data[16:24])
        return h, w
    if not data.startswith(b"\xff\xd8"):
        raise ValueError(f"{name}: not a JPEG or PNG file")
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt JPEG (no marker at byte "
                             f"{pos})")
        marker = data[pos + 1]
        if marker == 0xFF:                       # fill byte
            pos += 1
            continue
        if marker == 0x01 or 0xD0 <= marker <= 0xD8:
            pos += 2                             # markers without a length
            continue
        # SOF0-SOF15 but DHT (C4), JPG (C8) and DAC (CC)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if pos + 9 > len(data):
                break
            h, w = struct.unpack(">HH", data[pos + 5:pos + 9])
            return h, w
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
    raise ValueError(f"{name}: truncated JPEG (no frame header)")


def read_gray(src: Source) -> np.ndarray:
    """(H, W) uint8 of a single-component JPEG or an 8-bit grey PNG; a
    colour file raises."""
    data, name = _read(src)
    if data.startswith(_PNG_SIGNATURE):
        out = _png_image(data, name)
        if out.ndim != 2 or out.dtype != np.uint8:
            raise ValueError(f"{name}: not an 8-bit single-channel image")
        return out
    h, w, c = _header(data, name)
    if c != 1:
        raise ValueError(f"{name}: has {c} channels (expected a "
                         "single-channel image)")
    return _decode(data, name, h, w, 1)[..., 0]


def encode_png(arr: np.ndarray) -> bytes:
    """A non-interlaced 8-bit PNG of ``arr``: (H, W) grey, (H, W, 3) RGB or
    (H, W, 4) RGBA uint8; every row takes filter 0 (None), and the stream
    is deflated by the standard library's ``zlib`` at level 6."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (
            arr.ndim == 3 and arr.shape[2] not in (3, 4)):
        raise ValueError(f"encode_png takes uint8 (H, W), (H, W, 3) or "
                         f"(H, W, 4), not {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    ctype = {2: 0, 3: {3: 2, 4: 6}.get(arr.shape[-1])}[arr.ndim]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)],
                          axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))
