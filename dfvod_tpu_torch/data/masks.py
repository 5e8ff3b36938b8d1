"""COCO instance masks on the host without pycocotools or PIL (counterpart
of ``rasterize_segmentation`` in ``dfvod_tpu/data/dataset.py``).

- RLE, uncompressed (a list of run lengths) or compressed (pycocotools'
  ``counts`` string), decodes exactly; runs are column-major.
- Polygons are filled as the JAX package fills them, with PIL's
  ``ImageDraw.polygon(xy, fill=1, outline=1)``, whose pixels this scanline
  fill reproduces (the card machine has no PIL): each vertex rounded to
  the nearest integer (half away from zero), the horizontal edges drawn
  whole, and on each row y from the polygon's top to its bottom the
  crossings ``(y - y0) * dx + x0`` of the edges spanning y, in f32, a
  crossing at an edge's lower end counted twice above the last row, the
  sorted crossings paired, and each pair's span from ``round(left)`` to
  ``round_down(right)`` set. A crossing that lands on an integer where two
  edges of the same slope sign meet (a corner between rows) is moved as
  PIL moves it (``Draw.c``, "connect discontiguous corners").
"""
from __future__ import annotations

import math
from typing import List

import numpy as np


def decode_rle_counts(s) -> List[int]:
    """pycocotools' compressed RLE ``counts`` string as run lengths: 5-bit
    chunks biased by 48, bit 5 continues, bit 4 of the last chunk extends
    the sign, and from the fourth value on each is a delta from the value
    two before."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    i = 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _round_up(f: float) -> int:
    """PIL's ``ROUND_UP``: to the nearest integer, halves away from
    zero."""
    return int(math.floor(f + 0.5)) if f >= 0 else -int(math.floor(
        abs(f) + 0.5))


def _roundf(x) -> np.float32:
    """C's ``roundf``: to the nearest integer, halves away from zero."""
    x = float(x)
    return np.float32(math.copysign(math.floor(abs(x) + 0.5), x))


def _round_down(f: float) -> int:
    """PIL's ``ROUND_DOWN``: to the nearest integer, halves toward
    zero."""
    return int(math.ceil(f - 0.5)) if f >= 0 else -int(math.ceil(
        abs(f) - 0.5))


class _Edge:
    __slots__ = ("xmin", "xmax", "ymin", "ymax", "x0", "y0", "dx")

    def __init__(self, x0, y0, x1, y1):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.x0, self.y0 = x0, y0
        self.dx = (np.float32(0.0) if y0 == y1
                   else np.float32(x1 - x0) / np.float32(y1 - y0))

    def at(self, y):
        """The edge's x on row ``y``, in f32 as PIL computes it."""
        return np.float32(np.float32(y - self.y0) * self.dx) \
            + np.float32(self.x0)


def _edges(pts) -> List[_Edge]:
    """PIL's edge list of a closed polygon of integer vertices: a
    horizontal edge right after another one going the same way extends
    it."""
    edges: List[_Edge] = []
    n = len(pts)
    for i in range(n - 1):
        (x0, y0), (x1, y1) = pts[i], pts[i + 1]
        if y0 == y1 and i != 0 and y0 == pts[i - 1][1]:
            last, px = edges[-1], pts[i - 1][0]
            if x1 > x0 > px:
                last.xmax = x1
                continue
            if x1 < x0 < px:
                last.xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    if pts[-1] != pts[0]:
        edges.append(_Edge(*pts[-1], *pts[0]))
    return edges


def fill_polygon(mask: np.ndarray, xy) -> None:
    """Fill the polygon of vertices ``xy`` ([(x, y), ...], floats) into
    ``mask`` (H, W) with 1, as PIL's ``ImageDraw.polygon(xy, fill=1,
    outline=1)`` does."""
    H, W = mask.shape
    pts = [(int(x), int(y)) for x, y in xy]

    def hline(x0, y, x1):
        if 0 <= y < H:
            x0, x1 = max(x0, 0), min(x1, W - 1)
            if x0 <= x1:
                mask[y, x0:x1 + 1] = 1

    ymin, ymax = H - 1, 0
    table = []
    for e in _edges(pts):
        ymin, ymax = min(ymin, e.ymin), max(ymax, e.ymax)
        if e.ymin == e.ymax:
            hline(e.xmin, e.ymin, e.xmax)
        else:
            table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, H)
    for y in range(ymin, ymax + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            x = cur.at(y)
            xx.append(x)
            if y == cur.ymax and y < ymax:
                xx.append(x)
            elif cur.dx != 0 and _roundf(x) == x:
                xx[-1] = _corner(table, i, cur, y, x)
        xx.sort()
        for a, b in zip(xx[0::2], xx[1::2]):
            hline(_round_up(float(a)), y, _round_down(float(b)))


def _corner(table, i, cur, y, x):
    """PIL's "connect discontiguous corners": a crossing on an integer
    where ``cur`` meets an earlier edge of the same slope sign on row y is
    moved past the nearer of the two edges' crossings on the next row (the
    previous one on the edge's last row), so that the corner's pixels
    join."""
    for other in table[:i]:
        if (cur.dx > 0 and other.dx <= 0) or (cur.dx < 0 and other.dx >= 0):
            continue
        if not other.ymin <= y <= other.ymax or x != other.at(y):
            continue
        off = -1 if y == cur.ymax else 1
        if not other.ymin <= y + off <= other.ymax:
            continue
        a, b = cur.at(y + off), other.at(y + off)
        if x > a + 1 and x > b + 1:
            return _roundf(max(a, b)) + np.float32(0.5)
        if x < a - 1 and x < b - 1:
            return _roundf(min(a, b)) - np.float32(0.5)
        break
    return x


def rasterize_segmentation(seg, h: int, w: int) -> np.ndarray:
    """A COCO ``segmentation`` as an (h, w) uint8 {0, 1} mask: a list of
    flat ``[x0, y0, x1, y1, ...]`` polygons (their union; one of fewer
    than 3 vertices is skipped), or an RLE dict ``{size: [h, w], counts}``
    (column-major runs, uncompressed or compressed), cut to (h, w)."""
    if isinstance(seg, list):
        mask = np.zeros((h, w), np.uint8)
        for poly in seg:
            xy = [(float(poly[i]), float(poly[i + 1]))
                  for i in range(0, len(poly) - 1, 2)]
            if len(xy) >= 3:
                fill_polygon(mask, xy)
        return mask
    counts = seg["counts"]
    rh, rw = seg["size"]
    if isinstance(counts, (str, bytes)):
        counts = decode_rle_counts(counts)
    flat = np.zeros(rh * rw, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape(rw, rh).T[:h, :w]
