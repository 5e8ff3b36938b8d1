"""Sample-point patterns of the weighted bilinear sampling (K3) and its
backward (K4) on which the kernels' merged paths hinge, made with numpy
from a seed. The CPU parity tests hold the plain versions against the
Pallas kernels on them, and the card tests hold the kernels against the
plain versions on the same patterns. Imports neither JAX nor torch."""
import numpy as np

PATTERNS = ("one_token", "on_integer", "cancelling", "clustered", "spread")


def point_pattern(name, rng, BM, Lq, PL, H, W):
    """px, py, aw of shape (BM, Lq, PL), f32, finite:

    - ``one_token``: every point at (x, y) = (2.25, 1.5), so every corner of
      every query falls on the same 4 tokens (the most merging there is);
    - ``on_integer``: every point exactly on token (2, 1): one corner of
      weight 1 and three of weight 0, all on the grid (the one-sided
      derivative);
    - ``cancelling``: the points of a query in pairs at one spot, weights
      aw and -aw, so equal corners within a query sum to 0;
    - ``clustered``: each 7 consecutive queries within 1.5 tokens of a
      centre of their own, like the bins of a RoI, with no regard to where
      a tile of queries begins;
    - ``spread``: uniform over [-1, W) x [-1, H), so almost no corner is
      shared.
    """
    shape = (BM, Lq, PL)
    aw = rng.standard_normal(shape)
    if name == "one_token":
        px, py = np.full(shape, 2.25), np.full(shape, 1.5)
    elif name == "on_integer":
        px, py = np.full(shape, 2.0), np.full(shape, 1.0)
    elif name == "cancelling":
        px = rng.uniform(-0.5, W - 0.5, shape)
        py = rng.uniform(-0.5, H - 0.5, shape)
        even = PL - PL % 2
        px[..., 1:even:2] = px[..., 0:even:2]
        py[..., 1:even:2] = py[..., 0:even:2]
        aw[..., 1:even:2] = -aw[..., 0:even:2]
    elif name == "clustered":
        groups = -(-Lq // 7)
        cx = np.repeat(rng.uniform(0, W - 1, (BM, groups, 1)), 7, 1)[:, :Lq]
        cy = np.repeat(rng.uniform(0, H - 1, (BM, groups, 1)), 7, 1)[:, :Lq]
        px = np.clip(cx + rng.uniform(-1.5, 1.5, shape), 0, W - 1)
        py = np.clip(cy + rng.uniform(-1.5, 1.5, shape), 0, H - 1)
    elif name == "spread":
        px = rng.uniform(-1, W, shape)
        py = rng.uniform(-1, H, shape)
    else:
        raise ValueError(f"no point pattern {name!r}")
    return tuple(np.asarray(a, np.float32) for a in (px, py, aw))
