"""K4's contract on the CPU: the port's plain backward of the weighted
bilinear sampling (``hat_sample_plain_bwd``, the counterpart of the CUDA
kernel ``csrc/hat_sample_bwd.cu``) against the TPU kernel
``msda_pallas.hat_sample_bwd`` in interpret mode and against ``jax.vjp`` of
``hat_sample_vjp`` (at edge points, and against the kernel at the point
patterns of ``torch_hat_patterns.py``); autograd of the plain forward
against it; and the features' gradient of RoIAlign against ``jax.grad`` of
the JAX package's ``roi_align`` on both of its paths, the QRF's geometry
included.

Inputs are made with numpy from seeds. Tolerance: atol/rtol 1e-5 in f32
(the same products, summed in another order). The Pallas kernel propagates
a NaN coordinate into every gradient of its frame, so the points compared
with it are finite; non-finite points are checked on their own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.ops import msda_pallas
from dfvod_tpu.ops.roi_align import roi_align as j_roi_align
from dfvod_tpu_torch.ops import hat_sample as hs
from dfvod_tpu_torch.ops.roi_align import roi_align
from test_torch_hat_sample import (ROI_CASES, grid_coords, pattern_inputs)
from torch_hat_patterns import PATTERNS
from torch_port_helpers import assert_close

TOL = dict(atol=1e-5, rtol=1e-5)


def edge_points(rng, BM, Lq, PL, H, W):
    """px, py, aw (BM, Lq, PL) f32 covering: points outside the grid, in
    (-1, 0) and (H-1, H) / (W-1, W), on integer coordinates, at exactly -1
    and exactly W or H, with aw = 0, and the -1e6 padding."""
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
    py[:, 40:45] = rng.choice([-1.0, H], (BM, 5, PL))   # exactly -1 or H
    px[:, 40:45] = rng.uniform(0, W - 1, (BM, 5, PL))   # with x inside
    px[:, 45:48] = -1.0                                 # exactly -1 with
    py[:, 45:48] = rng.uniform(0, H - 1, (BM, 3, PL))   # y inside
    aw[:, 48:53] = 0.0
    px[:, 53:58] = -1e6
    py[:, 53:58] = -1e6
    return px, py, aw


def inputs(D, seed, BM=3, H=6, W=9, Lq=133, PL=5):
    """value (BM, H*W, D), the edge points, go (BM, Lq, D). Lq = 133 is not
    a multiple of the Pallas kernel's 128-query block."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((BM, H * W, D)).astype(np.float32)
    px, py, aw = edge_points(rng, BM, Lq, PL, H, W)
    go = rng.standard_normal((BM, Lq, D)).astype(np.float32)
    return (H, W), v, px, py, aw, go


def plain_bwd(grid, v, px, py, aw, go):
    return hs.hat_sample_plain_bwd(*map(torch.from_numpy, (v, px, py, aw,
                                                           go)), grid=grid)


@pytest.mark.parametrize("D", [8, 40])
def test_plain_bwd_matches_pallas_kernel(D):
    """All four outputs against ``_hat_bwd_kernel`` in interpret mode."""
    (H, W), v, px, py, aw, go = inputs(D, seed=D)
    sx, sy = grid_coords(H, W)
    ref = msda_pallas.hat_sample_bwd(
        *map(jnp.asarray, (v, sx, sy, px, py, aw, go)), interpret=True)
    got = plain_bwd((H, W), v, px, py, aw, go)
    for name, g, r, x in zip(("gv", "gpx", "gpy", "gaw"), got, ref,
                             (v, px, py, aw)):
        assert g.shape == x.shape and g.dtype == torch.float32, name
        assert_close(g, r, **TOL, err_msg=name)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_plain_bwd_matches_pallas_kernel_on_merge_patterns(pattern):
    """All four outputs against ``_hat_bwd_kernel`` at the point patterns
    on which K4's merged path hinges: every corner of a tile on one token,
    corners on an integer token (weight-0 corners, one-sided derivatives),
    cancelling weights within a query, RoI-like clusters, spread points;
    3 frames of 37 queries, so K4's tiles straddle frames."""
    (H, W), v, px, py, aw, go = pattern_inputs(pattern, 16,
                                               10 + PATTERNS.index(pattern))
    sx, sy = grid_coords(H, W)
    ref = msda_pallas.hat_sample_bwd(
        *map(jnp.asarray, (v, sx, sy, px, py, aw, go)), interpret=True)
    got = plain_bwd((H, W), v, px, py, aw, go)
    for name, g, r in zip(("gv", "gpx", "gpy", "gaw"), got, ref):
        assert_close(g, r, **TOL, err_msg=name)


@pytest.mark.parametrize("D", [8, 40])
def test_plain_bwd_matches_jax_vjp(D):
    """Against ``jax.vjp`` of ``hat_sample_vjp`` (Pallas forward and
    backward, interpret mode), the differentiable function the JAX
    RoIAlign calls; the token coordinates get zero cotangents."""
    (H, W), v, px, py, aw, go = inputs(D, seed=10 + D)
    sx, sy = grid_coords(H, W)
    f = msda_pallas.hat_sample_vjp(interpret=True)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (v, sx, sy, px, py, aw)))
    gv, gsx, gsy, gpx, gpy, gaw = vjp(jnp.asarray(go))
    np.testing.assert_array_equal(np.asarray(gsx), 0.0)
    np.testing.assert_array_equal(np.asarray(gsy), 0.0)
    got = plain_bwd((H, W), v, px, py, aw, go)
    for name, g, r in zip(("gv", "gpx", "gpy", "gaw"), got,
                          (gv, gpx, gpy, gaw)):
        assert_close(g, r, **TOL, err_msg=name)


@pytest.mark.parametrize("D", [8, 40])
def test_autograd_of_plain_equals_plain_bwd(D):
    """Autograd through the plain forward (what the CPU path runs) equals
    the written-out backward, on the grid layout the model uses."""
    (H, W), v, px, py, aw, go = inputs(D, seed=20 + D)
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (v.reshape(3, H, W, D), px, py, aw)]
    hs.hat_sample(*leaves).backward(torch.from_numpy(go))
    want = plain_bwd((H, W), v, px, py, aw, go)
    assert want[0].shape == (3, H * W, D)
    assert_close(leaves[0].grad.reshape(3, H * W, D), want[0].numpy(), **TOL)
    for name, leaf, w in zip(("gpx", "gpy", "gaw"), leaves[1:], want[1:]):
        assert_close(leaf.grad, w.numpy(), **TOL, err_msg=name)


def test_point_at_minus_one_has_the_pallas_derivative():
    """The repaired fault: ``hat_sample_plain`` dropped a point whose
    coordinate is exactly -1 (``px > -1``), so autograd gave it no
    derivative, while the Pallas backward gives the one-sided derivative
    from the corner at 0 (with these inputs: at px = -1, py = 1.5 gpx =
    -0.4361; at px = 2, py = -1 gpy = -3.6031). The forward value there is
    0 either way."""
    rng = np.random.default_rng(4)
    H, W, D = 4, 5, 8
    v = rng.standard_normal((1, H * W, D)).astype(np.float32)
    px = np.array([[[-1.0], [2.0]]], np.float32)          # (1, 2, 1)
    py = np.array([[[1.5], [-1.0]]], np.float32)
    aw = np.ones_like(px)
    go = rng.standard_normal((1, 2, D)).astype(np.float32)
    sx, sy = grid_coords(H, W)
    _, ref_gpx, ref_gpy, _ = msda_pallas.hat_sample_bwd(
        *map(jnp.asarray, (v, sx, sy, px, py, aw, go)), interpret=True)
    assert abs(float(ref_gpx[0, 0, 0])) > 0.1
    assert abs(float(ref_gpy[0, 1, 0])) > 0.1
    leaves = [torch.from_numpy(a).requires_grad_() for a in (v, px, py, aw)]
    out = hs.hat_sample_plain(*leaves, grid=(H, W))
    assert_close(out, np.zeros((1, 2, D)), atol=0, rtol=0)
    out.backward(torch.from_numpy(go))
    assert_close(leaves[1].grad, ref_gpx, **TOL)
    assert_close(leaves[2].grad, ref_gpy, **TOL)


def test_non_finite_points_get_zero_gradients():
    """A NaN or infinite coordinate contributes nothing to gv and gets zero
    point gradients: the result equals the one with that point's weight
    set to 0 and its coordinates moved far outside."""
    (H, W), v, px, py, aw, go = inputs(8, seed=5, Lq=64)
    px[:, 3, 0], py[:, 4, 1], px[:, 5, 2] = np.nan, np.inf, -np.inf
    got = plain_bwd((H, W), v, px, py, aw, go)
    bad = ~(np.isfinite(px) & np.isfinite(py))
    px2, py2, aw2 = px.copy(), py.copy(), aw.copy()
    px2[bad], py2[bad], aw2[bad] = -1e6, -1e6, 0.0
    want = plain_bwd((H, W), v, px2, py2, aw2, go)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    for g in got[1:]:
        assert bool((g[torch.from_numpy(bad)] == 0).all())


def test_cpu_dispatch_takes_the_plain_backward(monkeypatch):
    """On CPU tensors ``hat_sample_bwd`` is the plain backward and neither
    kernel is reached or counted."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a CUDA kernel")

    monkeypatch.setattr(hs, "hat_sample_cuda", no_kernel)
    monkeypatch.setattr(hs, "hat_sample_bwd_cuda", no_kernel)
    fwd, bwd = hs.hat_sample.launches, hs.hat_sample_bwd.launches
    grid, v, px, py, aw, go = inputs(8, seed=6, Lq=64)
    got = hs.hat_sample_bwd(*map(torch.from_numpy, (v, px, py, aw, go)),
                            grid=grid)
    for g, w in zip(got, plain_bwd(grid, v, px, py, aw, go)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert (hs.hat_sample.launches, hs.hat_sample_bwd.launches) == (fwd, bwd)


def test_bwd_kernel_arg_checks():
    """What the K4 wrapper refuses, checked before any build: these raise
    on the CPU too."""
    grid, v, px, py, aw, go = (x if isinstance(x, tuple) else
                               torch.from_numpy(x)
                               for x in inputs(8, seed=7, Lq=64))
    with pytest.raises(ValueError, match="grad_out"):
        hs.hat_sample_bwd_cuda(v, px, py, aw, go[:, :4], grid)
    with pytest.raises(ValueError, match="grad_out"):
        hs.hat_sample_bwd_cuda(v, px, py, aw, go.half(), grid)
    with pytest.raises(ValueError, match="contiguous"):
        strided = go.transpose(1, 2).contiguous().transpose(1, 2)
        hs.hat_sample_bwd_cuda(v, px, py, aw, strided, grid)
    with pytest.raises(TypeError):
        hs.hat_sample_bwd_cuda(v.half(), px, py, aw, go, grid)
    with pytest.raises(ValueError, match="cpu or cuda"):
        hs.hat_sample_bwd(v.to("meta"), px, py, aw, go, grid)


# ------------------------------------------------------------- RoIAlign
@pytest.mark.parametrize("impl", ["xla", "pallas_hat"])
@pytest.mark.parametrize("case", list(ROI_CASES))
def test_roi_align_feature_gradient_matches_jax_grad(case, impl):
    """The features' gradient of the port's RoIAlign (autograd through the
    plain sampling on the CPU) against ``jax.grad`` of the JAX package's
    ``roi_align`` on its XLA path and on its Pallas path (K3 and K4 in
    interpret mode); the boxes get no gradient on either side."""
    shape, make_boxes, P, scale = ROI_CASES[case]
    rng = np.random.default_rng(1)
    feat = rng.standard_normal(shape).astype(np.float32)
    boxes = make_boxes(rng)
    co = rng.standard_normal((shape[0], boxes.shape[1], P, P, shape[-1])
                             ).astype(np.float32)

    def loss(f, b):
        return jnp.sum(j_roi_align(f, b, output_size=P, spatial_scale=scale,
                                   sampling_ratio=2, impl=impl,
                                   interpret=impl == "pallas_hat") * co)

    ref, ref_boxes = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feat),
                                                    jnp.asarray(boxes))
    np.testing.assert_array_equal(np.asarray(ref_boxes), 0.0)
    f = torch.from_numpy(feat).requires_grad_()
    b = torch.from_numpy(boxes).requires_grad_()
    (roi_align(f, b, output_size=P, spatial_scale=scale, sampling_ratio=2)
     * torch.from_numpy(co)).sum().backward()
    assert_close(f.grad, ref, **TOL)
    assert b.grad is None
