"""K3's contract on the CPU: the port's plain ``hat_sample`` against the
Pallas kernel ``msda_pallas.hat_sample`` in interpret mode (at edge points
and at the point patterns of ``torch_hat_patterns.py``), and the port's
``roi_align`` against the JAX package's ``roi_align`` on both of its paths
(``impl="xla"`` and ``impl="pallas_hat"``, interpret mode), the QRF's
geometry included.

Inputs are made with numpy from seeds. Tolerance: atol/rtol 1e-5 in f32
(the same products, summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.ops import msda_pallas
from dfvod_tpu.ops.roi_align import roi_align as j_roi_align
from dfvod_tpu_torch.ops import hat_sample as hs
from dfvod_tpu_torch.ops.roi_align import roi_align
from torch_hat_patterns import PATTERNS, point_pattern
from torch_port_helpers import assert_close


def grid_coords(H, W):
    """The token coordinates of the regular grid, as the JAX caller builds
    them (``roi_align.py:90-91``)."""
    return (np.tile(np.arange(W, dtype=np.float32), H),
            np.repeat(np.arange(H, dtype=np.float32), W))


def edge_points(rng, BM, Lq, PL, H, W):
    """px, py, aw (BM, Lq, PL) f32 covering: points outside the grid, in
    (-1, 0) and (H-1, H) / (W-1, W), on integer coordinates, with aw = 0,
    and the -1e6 padding."""
    px = rng.uniform(-2.5, W + 1.5, (BM, Lq, PL)).astype(np.float32)
    py = rng.uniform(-2.5, H + 1.5, (BM, Lq, PL)).astype(np.float32)
    aw = rng.standard_normal((BM, Lq, PL)).astype(np.float32)
    px[:, 0:10] = np.floor(px[:, 0:10])                 # integer x
    py[:, 5:15] = np.floor(py[:, 5:15])                 # integer y (and both)
    px[:, 15:20] = rng.uniform(-1, 0, (BM, 5, PL))      # (-1, 0)
    py[:, 20:25] = rng.uniform(-1, 0, (BM, 5, PL))
    px[:, 25:30] = rng.uniform(W - 1, W, (BM, 5, PL))   # (W-1, W)
    py[:, 30:35] = rng.uniform(H - 1, H, (BM, 5, PL))   # (H-1, H)
    px[:, 35:40] = rng.choice([-1.0, -3.0, W, W + 2.0], (BM, 5, PL))
    aw[:, 40:45] = 0.0
    px[:, 45:50] = -1e6
    py[:, 45:50] = -1e6
    return px, py, aw


# Lq = 133 is not a multiple of the Pallas kernel's 128-query block
@pytest.mark.parametrize("D", [8, 40])
def test_plain_matches_pallas_kernel(D):
    rng = np.random.default_rng(D)
    BM, H, W, Lq, PL = 3, 6, 9, 133, 5
    v = rng.standard_normal((BM, H * W, D)).astype(np.float32)
    px, py, aw = edge_points(rng, BM, Lq, PL, H, W)
    sx, sy = grid_coords(H, W)
    ref = msda_pallas.hat_sample(*map(jnp.asarray, (v, sx, sy, px, py, aw)),
                                 interpret=True)
    got = hs.hat_sample_plain(*map(torch.from_numpy, (v, px, py, aw)),
                              grid=(H, W))
    assert got.shape == (BM, Lq, D) and got.dtype == torch.float32
    assert_close(got, ref, atol=1e-5, rtol=1e-5)


# 3 frames of Lq = 37 queries: not a multiple of K4's 16-row tile, so the
# kernels' tiles straddle frames and the last one is partial
PATTERN_SHAPE = dict(BM=3, Lq=37, PL=4, H=6, W=9)


def pattern_inputs(pattern, D, seed):
    """value (BM, H*W, D), the pattern's px, py, aw, and go (BM, Lq, D)."""
    rng = np.random.default_rng(seed)
    BM, Lq, H, W = (PATTERN_SHAPE[k] for k in ("BM", "Lq", "H", "W"))
    v = rng.standard_normal((BM, H * W, D)).astype(np.float32)
    px, py, aw = point_pattern(pattern, rng, **PATTERN_SHAPE)
    go = rng.standard_normal((BM, Lq, D)).astype(np.float32)
    return (H, W), v, px, py, aw, go


@pytest.mark.parametrize("pattern", PATTERNS)
def test_plain_matches_pallas_kernel_on_merge_patterns(pattern):
    """The point patterns on which K3's merge of equal corners hinges (all
    on one token, on an integer token, cancelling weights within a query,
    RoI-like clusters, spread over the map) against the Pallas kernel."""
    (H, W), v, px, py, aw, _ = pattern_inputs(pattern, 16,
                                              PATTERNS.index(pattern))
    sx, sy = grid_coords(H, W)
    ref = msda_pallas.hat_sample(*map(jnp.asarray, (v, sx, sy, px, py, aw)),
                                 interpret=True)
    got = hs.hat_sample_plain(*map(torch.from_numpy, (v, px, py, aw)),
                              grid=(H, W))
    assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_grid_and_flat_layouts_agree():
    """A (BM, H, W, D) value and its flat (BM, S, D) view with the grid
    give the same result, through the dispatching wrapper."""
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.standard_normal((2, 5, 7, 8)).astype(
        np.float32))
    px, py, aw = map(torch.from_numpy, edge_points(rng, 2, 60, 4, 5, 7))
    before = hs.hat_sample.launches
    a = hs.hat_sample(v, px, py, aw)
    b = hs.hat_sample(v.reshape(2, 35, 8), px, py, aw, grid=(5, 7))
    assert hs.hat_sample.launches == before      # plain on the CPU
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError):
        hs.hat_sample(v.reshape(2, 35, 8), px, py, aw)
    with pytest.raises(ValueError):
        hs.hat_sample(v, px, py, aw, grid=(7, 5))


def test_non_finite_points_contribute_zero():
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.standard_normal((1, 4, 5, 3)).astype(
        np.float32))
    px = torch.tensor([[[1.5, np.nan, np.inf, 2.0]]], dtype=torch.float32)
    py = torch.tensor([[[2.25, 1.0, 1.0, -np.inf]]], dtype=torch.float32)
    aw = torch.ones((1, 1, 4))
    got = hs.hat_sample_plain(v, px, py, aw)
    ref = hs.hat_sample_plain(v, px[..., :1], py[..., :1], aw[..., :1])
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_bf16_value_gives_bf16_output():
    """Coordinates and sum in f32, the result cast once to the value's
    dtype: the bf16 result is the f32 result of the bf16-rounded value,
    rounded."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((2, 6, 9, 16)).astype(
        np.float32)).bfloat16()
    px, py, aw = map(torch.from_numpy, edge_points(rng, 2, 70, 4, 6, 9))
    got = hs.hat_sample(v, px, py, aw)
    assert got.dtype == torch.bfloat16
    ref = hs.hat_sample(v.float(), px, py, aw).bfloat16()
    torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_autograd_function_asks_k4_for_what_needs_a_gradient(monkeypatch,
                                                              dtype):
    """``HatSampleFunction`` (K3 forward, K4 backward on the card), driven
    on CPU tensors with both kernel wrappers replaced by the plain
    versions: the backward passes ``needs_input_grad`` to the K4 wrapper,
    returns None where no gradient is needed, and gives the value's
    gradient in the value's (grid) shape and dtype. RoIAlign's case: only
    the value needs a gradient."""
    asked = []

    def bwd(value, px, py, aw, go, grid, needs):
        asked.append(tuple(needs))
        got = hs.hat_sample_plain_bwd(value, px, py, aw, go, grid)
        return tuple(g if n else None for g, n in zip(got, needs))

    monkeypatch.setattr(hs, "hat_sample_cuda", hs.hat_sample_plain)
    monkeypatch.setattr(hs, "hat_sample_bwd_cuda", bwd)
    rng = np.random.default_rng(4)
    v = torch.from_numpy(rng.standard_normal((2, 5, 7, 16)).astype(
        np.float32)).to(dtype)
    px, py, aw = map(torch.from_numpy, edge_points(rng, 2, 60, 4, 5, 7))
    go = torch.from_numpy(rng.standard_normal((2, 60, 16)).astype(
        np.float32)).to(dtype)
    want = hs.hat_sample_plain_bwd(v, px, py, aw, go)
    leaf = v.clone().requires_grad_()
    hs.HatSampleFunction.apply(leaf, px, py, aw, None).backward(go)
    assert asked == [(True, False, False, False)]
    assert leaf.grad.shape == v.shape and leaf.grad.dtype == dtype
    torch.testing.assert_close(leaf.grad, want[0], atol=0, rtol=0)
    pts = [t.clone().requires_grad_() for t in (px, py, aw)]
    hs.HatSampleFunction.apply(v, *pts, None).backward(go)
    assert asked[1] == (False, True, True, True)
    for p, w in zip(pts, want[1:]):
        torch.testing.assert_close(p.grad, w, atol=0, rtol=0)


def test_other_devices_are_refused():
    v = torch.zeros((1, 2, 2, 8), device="meta")
    p = torch.zeros((1, 3, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        hs.hat_sample(v, p, p, p)


# ------------------------------------------------------------- RoIAlign
def boxes_fixed(rng=None):
    """The boxes of ``tests/test_temporal.py:84-87``: inside, crossing the
    top-left border, crossing the bottom-right one, fully outside."""
    return np.asarray([[[1.0, 1.5, 8.0, 7.0], [-3.0, -2.0, 2.0, 3.0],
                        [6.0, 4.0, 14.0, 12.0], [-40.0, 0.0, -20.0, 4.0]]]
                      * 2, np.float32)


def boxes_random(rng):
    """The boxes of ``tests/test_temporal.py:119-125``: 17 per frame,
    uniform in [-8, 48], corners sorted."""
    b = rng.uniform(-8, 48, (2, 17, 4)).astype(np.float32)
    return np.concatenate([np.minimum(b[..., :2], b[..., 2:]),
                           np.maximum(b[..., :2], b[..., 2:])], -1)


def boxes_qrf(rng):
    """20 boxes per frame as ``chip_smoke.py::qrf_points`` draws them on
    the 608x800 image: centres U(0.05, 0.95), sizes U(0.02, 0.62) of it,
    xyxy in pixels."""
    cxcy = rng.uniform(0.05, 0.95, (2, 20, 2))
    wh = rng.uniform(0.02, 0.62, (2, 20, 2))
    whwh = np.asarray([800, 608, 800, 608])
    return (np.concatenate([cxcy - wh / 2, cxcy + wh / 2], -1)
            * whwh).astype(np.float32)


ROI_CASES = {
    # name: (feature shape, boxes, output_size, spatial_scale)
    "fixed": ((2, 9, 11, 8), boxes_fixed, 3, 1.0),
    "qrf_like": ((2, 10, 13, 16), boxes_random, 7, 0.25),
    # the QRF's geometry, cut to 2 frames, 20 RoIs and D = 16: the 38x50
    # stride-16 memory, spatial_scale 1/32, 7x7 bins of 2x2 sub-samples
    "qrf_geometry": ((2, 38, 50, 16), boxes_qrf, 7, 1 / 32),
}


@pytest.mark.parametrize("impl", ["xla", "pallas_hat"])
@pytest.mark.parametrize("case", list(ROI_CASES))
def test_roi_align_matches_jax(case, impl):
    shape, make_boxes, P, scale = ROI_CASES[case]
    rng = np.random.default_rng(0)
    feat = rng.standard_normal(shape).astype(np.float32)
    boxes = make_boxes(rng)
    ref = j_roi_align(jnp.asarray(feat), jnp.asarray(boxes), output_size=P,
                      spatial_scale=scale, sampling_ratio=2, impl=impl,
                      interpret=impl == "pallas_hat")
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(boxes),
                    output_size=P, spatial_scale=scale, sampling_ratio=2)
    assert got.shape == ref.shape == (shape[0], boxes.shape[1], P, P,
                                      shape[-1])
    assert_close(got, ref, atol=1e-5, rtol=1e-5)


def test_roi_align_constant_map_and_ramp():
    """The JAX package's own RoIAlign checks: a constant map pools to the
    constant; on f(y, x) = x each bin is the x of its center."""
    feat = torch.full((1, 8, 8, 3), 5.0)
    out = roi_align(feat, torch.tensor([[[4.0, 4.0, 20.0, 20.0]]]),
                    output_size=7, spatial_scale=0.25)
    torch.testing.assert_close(out, torch.full((1, 1, 7, 7, 3), 5.0))
    ramp = torch.arange(16, dtype=torch.float32)[None, None, :, None]
    ramp = ramp.expand(1, 16, 16, 1).contiguous()
    out = roi_align(ramp, torch.tensor([[[2.0, 2.0, 10.0, 10.0]]]),
                    output_size=4)[0, 0, :, :, 0]
    cols = 2.0 - 0.5 + (np.arange(4) + 0.5) * 2.0
    np.testing.assert_allclose(out.numpy(), np.tile(cols, (4, 1)),
                               rtol=1e-5)


def test_roi_align_feature_gradient_matches_jax():
    """On the CPU autograd differentiates the plain version: the features'
    gradient equals ``jax.grad`` of the XLA path; the boxes get none."""
    import jax
    rng = np.random.default_rng(4)
    feat = rng.standard_normal((2, 9, 11, 8)).astype(np.float32)
    boxes = boxes_fixed()
    co = rng.standard_normal((2, 4, 3, 3, 8)).astype(np.float32)

    def loss(f):
        return jnp.sum(j_roi_align(f, jnp.asarray(boxes), output_size=3,
                                   impl="xla") * co)

    ref = jax.grad(loss)(jnp.asarray(feat))
    f = torch.from_numpy(feat).requires_grad_()
    b = torch.from_numpy(boxes).requires_grad_()
    (roi_align(f, b, output_size=3) * torch.from_numpy(co)).sum().backward()
    assert_close(f.grad, ref, atol=1e-5, rtol=1e-5)
    assert b.grad is None
