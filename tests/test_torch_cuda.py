"""Tests of the port that need the card: the CUDA MSDA kernels (forward
and backward, up to TDAM's 5 levels; their vector kernels at D = 8 to 256
and their scalar kernels at D = 5 and on unaligned views, NaN / inf and
integer-pixel locations) and the bilinear-sampling kernel under
RoIAlign (K3) and its backward (K4) against their plain versions (at edge
points and at the point patterns of ``torch_hat_patterns.py``), gradients
through the MSDA module and RoIAlign on the card, and small models
(single-frame, TransVOD++, TransVOD+TDAM) and small single-frame and
TransVOD++ train steps on the card against the same on the CPU. Then the
opt-in forms: the folded-corner gather (K5b/c), the level-stacked sampling
(K5a) and the fused ResNet layer1 (K6) against their plain versions, the
``impl`` dispatch's launches per form, and the K5b/c + K2 gradient against
the CPU's. Last, the other two fusion modes: K1 and K2 at a copy of
Backbone_CrossFusion's stage-2 geometry on their vector kernels, and small
Encoder_CrossFusion and Backbone_CrossFusion models and train steps on the
card against the CPU. Then the data path: loader batches pinned and
copied to the card against the host's, and one epoch of a small model
through ``cli.main`` on the card against the CPU. They skip without a CUDA
device. This file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""
import os

import numpy as np
import pytest
import torch

from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models import backbone_resnet as br
from dfvod_tpu_torch.models.layers import MSDeformAttn
from dfvod_tpu_torch.ops import corner_gather as cg
from dfvod_tpu_torch.ops import fused_bottleneck as fb
from dfvod_tpu_torch.ops import hat_sample as hs
from dfvod_tpu_torch.ops import msda
from dfvod_tpu_torch.ops import msda_forms as mf
from dfvod_tpu_torch.ops.roi_align import roi_align
from dfvod_tpu_torch.train.engine import create_train_state, forward
from dfvod_tpu_torch.utils.config import Config, ModelConfig
from torch_hat_patterns import PATTERNS, point_pattern

pytestmark = pytest.mark.cuda

# (spatial_shapes, B, Lq, M, D, P)
CASES = {
    "enc": (((38, 50),), 2, 1900, 8, 32, 4),
    "multi_odd_d": (((7, 9), (4, 5)), 2, 37, 3, 5, 2),
    "three_level_d40": (((5, 6), (3, 3), (2, 2)), 1, 131, 2, 40, 3),
    # TDAM with 5 reference frames: 5 levels of one frame's shape
    "five_level_tdam": (((6, 7),) * 5, 2, 42, 2, 16, 4),
}
# the warp layouts of K1's and K2's vector kernels: D = 8 (8 queries per
# warp in bf16, 4 in f32) at L * P = 6, which no slot count divides, and
# 37 queries, which no query count per warp divides; D = 64; D = 256 (one
# point per warp in bf16, the scalar kernels in f32); power-of-two maps
# for exact integer pixels; a 60 x 75 map with few queries (sparse
# atomics)
LAYOUT_CASES = {
    "d8_l2_p3": (((6, 7), (3, 4)), 2, 37, 3, 8, 3),
    "d64": (((9, 11),), 2, 53, 2, 64, 4),
    "d256": (((5, 7),), 1, 19, 2, 256, 4),
    "pow2_l2": (((8, 16), (4, 4)), 2, 37, 2, 32, 4),
    "wide_map": (((60, 75),), 1, 67, 2, 32, 4),
}
# "case/variant" inputs of the K1 and K2 tests beyond the plain ones:
# "offset", contiguous views one element into their buffers, which are not
# 16-byte aligned (the scalar kernels); "nonfinite", NaN and +-inf
# locations, which add nothing and get exact zero point gradients;
# "integer_px", locations on exact integer pixels (K2's one-sided
# difference); "needs_value" / "needs_points", K2 asked for grad_value
# alone or the point gradients alone
K1_VARIANTS = ["enc/offset", "d64/offset", "d8_l2_p3/nonfinite",
               "d256/nonfinite", "pow2_l2/integer_px"]
K2_VARIANTS = K1_VARIANTS + ["enc/needs_value", "enc/needs_points",
                             "d64/needs_points", "d8_l2_p3/needs_value",
                             "wide_map/needs_value", "wide_map/offset"]
NEEDS = {"needs_value": (True, False, False),
         "needs_points": (False, True, True)}
DTYPES = {"f32": (torch.float32,) * 3,
          "bf16_serving": (torch.bfloat16, torch.float32, torch.bfloat16),
          "bf16_training": (torch.bfloat16, torch.float32, torch.float32),
          "bf16_all": (torch.bfloat16,) * 3}
SMALL = dict(fusion_type="LateFusion", num_queries=12, hidden_dim=64,
             nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=128,
             dropout=0.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("case", [*CASES, *LAYOUT_CASES, *K1_VARIANTS])
def test_kernel_matches_plain(cuda_device, case, dtypes):
    """f32: atol/rtol 1e-5. bf16: against the f32 plain version on the same
    bf16-rounded inputs, atol 3e-2 (the output is rounded to bf16). A
    non-finite location adds nothing: the plain version takes it at 2.0,
    outside the map."""
    vdt = DTYPES[dtypes][0]
    shapes, value, loc, attw, _ = msda_inputs(cuda_device, case,
                                              DTYPES[dtypes])
    B, Lq, M = loc.shape[:3]
    before = msda.ms_deform_attn.launches
    got = msda.ms_deform_attn(value, shapes, loc, attw)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn.launches == before + 1
    assert got.dtype == vdt and got.shape == (B, Lq, M * value.shape[-1])
    ref = msda.ms_deform_attn_plain(value.float(), shapes, finite_loc(loc),
                                    attw.float())
    if vdt == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), ref, atol=3e-2, rtol=0)


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    shapes = ((6, 8),)
    value = torch.randn(1, 48, 2, 8, device=cuda_device)
    loc = torch.rand(1, 4, 2, 1, 4, 2, device=cuda_device)
    attw = torch.rand(1, 4, 2, 1, 4, device=cuda_device)
    with pytest.raises(TypeError):
        msda.ms_deform_attn(value.half(), shapes, loc, attw)
    with pytest.raises(ValueError):
        msda.ms_deform_attn(value, shapes, loc.cpu(), attw)
    with pytest.raises(ValueError):
        msda.ms_deform_attn(value, ((6, 7),), loc, attw)


def test_small_model_card_matches_cpu(cuda_device):
    """The LateFusion model on the card (CUDA kernel) against the same
    weights on the CPU (plain MSDA), f32, padded input: atol 1e-4 / rtol
    1e-3, TF32 off."""
    cfg = Config(model=ModelConfig(**SMALL))
    cpu_model, _, _ = build_model(cfg, device="cpu", seed=3)
    gpu_model, _, _ = build_model(cfg, device=cuda_device, seed=3)
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (2, 96, 128, 4), generator=gen,
                      dtype=torch.uint8)
    sizes = torch.tensor([[96, 128], [60, 84]])
    before = msda.ms_deform_attn.launches
    with torch.no_grad():
        ref = cpu_model(*device_normalize(x, sizes))
        got = gpu_model(*device_normalize(x.to(cuda_device),
                                          sizes.to(cuda_device)))
    assert msda.ms_deform_attn.launches == before + 1 + 2 + 2
    for k in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(got[k].cpu(), ref[k], atol=1e-4,
                                   rtol=1e-3)


def offset_view(t):
    """``t``'s values in a contiguous view one element into its buffer, so
    its address is not 16-byte aligned."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    view = view.view(t.shape).copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


def integer_pixel_loc(gen, shapes, B, Lq, M, P, device):
    """Locations on exact integer pixels (loc * W - 0.5 an integer in
    [-1, W], exactly, for power-of-two W and H)."""
    loc = torch.empty((B, Lq, M, len(shapes), P, 2), device=device)
    for lvl, (h, w) in enumerate(shapes):
        for c, n in ((0, w), (1, h)):
            k = torch.randint(-1, n + 1, (B, Lq, M, P), generator=gen,
                              device=device)
            loc[:, :, :, lvl, :, c] = (k + 0.5) / n
    return loc


def finite_loc(loc):
    """``loc`` in f32 with every NaN or infinite coordinate at 2.0, outside
    the map: what the kernels make of such a point."""
    loc = loc.float()
    return torch.where(torch.isfinite(loc), loc, 2.0)


def msda_inputs(device, case, dtypes, seed=0):
    """value, loc, attw and go of ``case`` ("name" or "name/variant") in
    ``dtypes`` (value, loc, attw; go in the value's)."""
    name, _, variant = case.partition("/")
    shapes, B, Lq, M, D, P = {**CASES, **LAYOUT_CASES}[name]
    gen = torch.Generator(device=device).manual_seed(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = torch.randn((B, S, M, D), generator=gen, device=device)
    loc = torch.rand((B, Lq, M, L, P, 2), generator=gen,
                     device=device) * 1.2 - 0.1
    attw = torch.randn((B, Lq, M, L * P), generator=gen,
                       device=device).softmax(-1).reshape(B, Lq, M, L, P)
    go = torch.randn((B, Lq, M * D), generator=gen, device=device)
    if variant == "integer_px":
        loc = integer_pixel_loc(gen, shapes, B, Lq, M, P, device)
    if variant == "nonfinite":
        loc[:, 0::3, :, :, 0, 0] = float("nan")
        loc[:, 1::3, :, :, -1, 1] = float("inf")
        loc[:, 2::3, :, -1, 0, 0] = float("-inf")
    vdt, ldt, adt = dtypes
    tensors = (value.to(vdt), loc.to(ldt), attw.to(adt), go.to(vdt))
    if variant == "offset":
        tensors = tuple(offset_view(t) for t in tensors)
    return (shapes, *tensors)


@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("case", [*CASES, *LAYOUT_CASES, *K2_VARIANTS])
def test_bwd_kernel_matches_plain(cuda_device, case, dtypes):
    """K2 against the plain backward on the same (bf16-rounded) inputs in
    f32: f32 atol/rtol 1e-4 (the order of the atomics), bf16 rtol 2e-2 /
    atol 3e-2 (the JAX package's bf16 backward gate). Gradients come in
    each input's dtype, None where not asked for. A non-finite location
    gets exact zero gradients and scatters nothing."""
    shapes, value, loc, attw, go = msda_inputs(cuda_device, case,
                                               DTYPES[dtypes])
    needs = NEEDS.get(case.partition("/")[2], (True, True, True))
    before = msda.ms_deform_attn_bwd.launches
    if all(needs):
        got = msda.ms_deform_attn_bwd(value, shapes, loc, attw, go)
    else:
        got = msda.ms_deform_attn_bwd_cuda(value, shapes, loc, attw, go,
                                           needs)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn_bwd.launches == before + 1
    assert [g is not None for g in got] == list(needs)
    ref = msda.ms_deform_attn_plain_bwd(value.float(), shapes,
                                        finite_loc(loc), attw.float(),
                                        go.float())
    atol, rtol = ((1e-4, 1e-4) if value.dtype == torch.float32
                  else (3e-2, 2e-2))
    for g, r, x in zip(got, ref, (value, loc, attw)):
        if g is None:
            continue
        assert g.dtype == x.dtype and g.shape == x.shape
        torch.testing.assert_close(g.float(), r, atol=atol, rtol=rtol)
    nonfinite = ~torch.isfinite(loc.float()).all(-1)
    if needs[1] and bool(nonfinite.any()):
        assert int(torch.count_nonzero(got[1][nonfinite])) == 0
        assert int(torch.count_nonzero(got[2][nonfinite])) == 0


def test_bwd_kernel_out_of_bounds_gives_exact_zeros(cuda_device):
    shapes, value, loc, attw, go = msda_inputs(cuda_device, "multi_odd_d",
                                               DTYPES["f32"])
    loc = torch.where(loc < 0.5, -0.6, 1.6)
    for g in msda.ms_deform_attn_bwd(value, shapes, loc, attw, go):
        assert int(torch.count_nonzero(g)) == 0


def test_msda_module_grads_reach_its_projections(cuda_device):
    """The repaired fault: before MSDeformAttnFunction, the kernel's output
    had no grad_fn and value_proj, sampling_offsets and attention_weights
    got no gradient through MSDA on the card. Now each gets one, launched
    through msda_fwd and msda_bwd once each, and it equals the CPU
    module's (plain MSDA) within atol 1e-4 / rtol 1e-3."""
    torch.manual_seed(0)
    cpu = MSDeformAttn(64, 2, 4, 4)
    with torch.no_grad():
        cpu.sampling_offsets.weight.normal_(0, 0.02)
        cpu.attention_weights.weight.normal_(0, 0.2)
    gpu = MSDeformAttn(64, 2, 4, 4).to(cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    shapes = ((6, 8), (3, 4))
    query = torch.randn(2, 20, 64)
    src = torch.randn(2, 60, 64)
    ref = torch.rand(2, 20, 2, 2)
    fwd, bwd = msda.ms_deform_attn.launches, msda.ms_deform_attn_bwd.launches
    for mod, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        out = mod(query.to(dev), ref.to(dev), src.to(dev), shapes)
        out.square().sum().backward()
    assert msda.ms_deform_attn.launches == fwd + 1
    assert msda.ms_deform_attn_bwd.launches == bwd + 1
    for name in ("value_proj", "sampling_offsets", "attention_weights"):
        g = getattr(gpu, name).weight.grad
        assert g is not None and bool(g.abs().sum() > 0), name
        torch.testing.assert_close(g.cpu(), getattr(cpu, name).weight.grad,
                                   atol=1e-4, rtol=1e-3)


def test_small_train_step_card_matches_cpu(cuda_device):
    """One train-step loss and every gradient: the small LateFusion model
    on the card (both kernels) against the same weights and batch on the
    CPU (plain MSDA), f32, dropout 0. Loss and components atol 1e-5 /
    rtol 1e-4, gradients atol 1e-4 / rtol 1e-3, TF32 off."""
    cfg = Config(model=ModelConfig(**SMALL))
    cpu_model, criterion, _ = build_model(cfg, device="cpu", seed=3)
    gpu_model, _, _ = build_model(cfg, device=cuda_device, seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(1)
    B, T = 2, 8
    valid = torch.arange(T)[None] < torch.tensor([[3], [5]])
    batch = {"images": torch.randint(0, 256, (B, 96, 128, 4), generator=gen,
                                     dtype=torch.uint8),
             "sizes": torch.tensor([[96, 128], [60, 84]]),
             "labels": torch.randint(0, 2, (B, T), generator=gen),
             "boxes": torch.cat([torch.rand((B, T, 2), generator=gen) * 0.6
                                 + 0.2, torch.rand((B, T, 2), generator=gen)
                                 * 0.3 + 0.05], -1),
             "valid": valid}
    results = []
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda_device)):
        state = create_train_state(model, cfg)
        loss, parts = criterion(*forward(
            state, {k: v.to(dev) for k, v in batch.items()}))
        loss.backward()
        results.append(({"loss": loss.detach(), **parts},
                        {n: p.grad for n, p in model.named_parameters()
                         if p.grad is not None}))
    (ref_parts, ref_grads), (parts, grads) = results
    for k, r in ref_parts.items():
        torch.testing.assert_close(parts[k].detach().cpu(), r.detach(),
                                   atol=1e-5, rtol=1e-4)
    assert grads.keys() == ref_grads.keys()
    for n, r in ref_grads.items():
        torch.testing.assert_close(grads[n].cpu(), r, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [8, 40, 256])
def test_hat_kernel_matches_plain(cuda_device, D, dtype):
    """K3 against its plain version on the same (bf16-rounded) value, with
    points outside the grid, in (-1, 0) and (H-1, H), on integers, with
    aw = 0, the -1e6 padding and NaN: f32 atol/rtol 1e-5; bf16 atol 1e-5 /
    rtol 2^-8 (the output rounded once to bf16)."""
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    BM, H, W, Lq, PL = 3, 7, 9, 133, 5
    value = torch.randn((BM, H, W, D), generator=gen,
                        device=cuda_device).to(dtype)
    px = torch.rand((BM, Lq, PL), generator=gen, device=cuda_device) * 13 - 2
    py = torch.rand((BM, Lq, PL), generator=gen, device=cuda_device) * 11 - 2
    aw = torch.randn((BM, Lq, PL), generator=gen, device=cuda_device)
    px[:, :10] = torch.floor(px[:, :10])
    px[:, 10:15] = -0.5
    py[:, 15:20] = H - 0.5
    aw[:, 20:25] = 0
    px[:, 25:30] = -1e6
    py[:, 25:30] = -1e6
    px[:, 30:32, 0] = float("nan")
    before = hs.hat_sample.launches
    got = hs.hat_sample(value, px, py, aw)
    torch.cuda.synchronize()
    assert hs.hat_sample.launches == before + 1
    assert got.dtype == dtype and got.shape == (BM, Lq, D)
    ref = hs.hat_sample_plain(value.float(), px, py, aw)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), ref, atol=1e-5,
                                   rtol=2.0 ** -8)


def test_hat_kernel_refuses_what_it_does_not_take(cuda_device):
    value = torch.randn(1, 4, 5, 8, device=cuda_device)
    p = torch.rand(1, 6, 4, device=cuda_device)
    with pytest.raises(TypeError):
        hs.hat_sample(value.half(), p, p, p)
    with pytest.raises(TypeError):
        hs.hat_sample(value, p.double(), p, p)
    with pytest.raises(ValueError):
        hs.hat_sample(value, p.cpu(), p, p)
    with pytest.raises(ValueError):
        hs.hat_sample(value, p[:, :, :2], p, p)


@pytest.mark.parametrize("needs", ["gv", "all"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [8, 40, 256])
def test_hat_bwd_kernel_matches_plain(cuda_device, D, dtype, needs):
    """K4 against the plain backward in f32 on the same (bf16-rounded)
    value and go, at points outside the grid, in (-1, 0) and (H-1, H), on
    integers, at exactly -1 and exactly W, with aw = 0, the -1e6 padding
    and NaN: atol/rtol 1e-4 (the atomics add gv in another order on every
    run), a bf16 gv rtol 2^-8 more (rounded once). With ``needs="gv"``
    only gv comes back, in the value's dtype and shape."""
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    BM, H, W, Lq, PL = 3, 7, 9, 133, 5
    value = torch.randn((BM, H, W, D), generator=gen,
                        device=cuda_device).to(dtype)
    px = torch.rand((BM, Lq, PL), generator=gen, device=cuda_device) * 13 - 2
    py = torch.rand((BM, Lq, PL), generator=gen, device=cuda_device) * 11 - 2
    aw = torch.randn((BM, Lq, PL), generator=gen, device=cuda_device)
    px[:, :10] = torch.floor(px[:, :10])
    px[:, 10:15] = -0.5
    py[:, 15:20] = H - 0.5
    aw[:, 20:25] = 0
    px[:, 25:30] = -1e6
    py[:, 25:30] = -1e6
    px[:, 30:32, 0] = float("nan")
    px[:, 32:35] = -1.0
    py[:, 35:38] = -1.0
    px[:, 38:40] = float(W)
    go = torch.randn((BM, Lq, D), generator=gen, device=cuda_device).to(dtype)
    want = (True, False, False, False) if needs == "gv" else (True,) * 4
    before = hs.hat_sample_bwd.launches
    got = hs.hat_sample_bwd(value, px, py, aw, go, needs=want)
    torch.cuda.synchronize()
    assert hs.hat_sample_bwd.launches == before + 1
    assert [g is not None for g in got] == list(want)
    assert got[0].dtype == dtype and got[0].shape == value.shape
    ref = hs.hat_sample_plain_bwd(value.float(), px, py, aw, go.float())
    for g, r in zip(got, ref):
        if g is not None:
            rtol = 1e-4 + (2.0 ** -8 if g.dtype == torch.bfloat16 else 0)
            torch.testing.assert_close(g.float(), r.reshape(g.shape),
                                       atol=1e-4, rtol=rtol)


# (value dtype, go dtype) of the K3/K4 pattern tests: f32, bf16, and an f32
# value under a bf16 go
HAT_MIXES = {"f32": (torch.float32, torch.float32),
             "bf16": (torch.bfloat16, torch.bfloat16),
             "f32_value_bf16_go": (torch.float32, torch.bfloat16)}
# case: (pattern of tests/torch_hat_patterns.py, PL, BM, Lq). The patterns
# at PL = 4 on 3 frames of Lq = 133 queries (K4's merged path at D = 256;
# its 16-row tiles straddle two frames and the last one is partial); spread
# points at PL = 9, more than the merged path takes (K4's scalar path); and
# 7 frames of Lq = 5, so a tile spans four frames
HAT_CASES = {**{p: (p, 4, 3, 133) for p in PATTERNS},
             "spread_pl9": ("spread", 9, 3, 133),
             "one_token_lq5": ("one_token", 4, 7, 5),
             "clustered_lq5": ("clustered", 4, 7, 5)}


@pytest.mark.parametrize("mix", list(HAT_MIXES))
@pytest.mark.parametrize("D", [256, 40])
@pytest.mark.parametrize("pattern", list(HAT_CASES))
def test_hat_kernels_on_point_patterns(cuda_device, pattern, D, mix):
    """K3 and K4 (gv alone, then every gradient) against their plain
    versions at the point patterns on which their merged paths hinge: every
    corner of a tile on one token, on an integer token, cancelling weights
    within a query, RoI-like clusters, points spread over the whole 38x50
    map; tiles that straddle two frames or span four. D = 256 takes the
    vector paths (K4's merged path at PL = 4, as its C entry counts it),
    40 the scalar ones. Tolerances as in the two tests above."""
    vdt, gdt = HAT_MIXES[mix]
    name, PL, BM, Lq = HAT_CASES[pattern]
    rng = np.random.default_rng(list(HAT_CASES).index(pattern) * 1000 + D)
    H, W = 38, 50
    px, py, aw = (torch.from_numpy(a).to(cuda_device)
                  for a in point_pattern(name, rng, BM, Lq, PL, H, W))
    value = torch.from_numpy(rng.standard_normal((BM, H, W, D)).astype(
        np.float32)).to(cuda_device).to(vdt)
    go = torch.from_numpy(rng.standard_normal((BM, Lq, D)).astype(
        np.float32)).to(cuda_device).to(gdt)
    got = hs.hat_sample(value, px, py, aw)
    torch.cuda.synchronize()
    ref = hs.hat_sample_plain(value.float(), px, py, aw)
    assert got.dtype == vdt
    torch.testing.assert_close(got.float(), ref, atol=1e-5,
                               rtol=1e-5 if vdt == torch.float32
                               else 2.0 ** -8)
    ref = hs.hat_sample_plain_bwd(value.float(), px, py, aw, go.float())
    for needs in ((True, False, False, False), (True,) * 4):
        before = hs.hat_sample_bwd.launches
        tile_rows, tiles = hs.bwd_merged_tiles()
        got = hs.hat_sample_bwd(value, px, py, aw, go, needs=needs)
        torch.cuda.synchronize()
        assert hs.hat_sample_bwd.launches == before + 1
        # every tile on K4's merged path at D = 256 and PL = 4, none else
        merged = -(-BM * Lq // tile_rows) if D == 256 and PL == 4 else 0
        assert hs.bwd_merged_tiles()[1] == tiles + merged
        assert [g is not None for g in got] == list(needs)
        for g, r in zip(got, ref):
            if g is not None:
                rtol = 1e-4 + (2.0 ** -8 if g.dtype == torch.bfloat16 else 0)
                torch.testing.assert_close(g.float(), r.reshape(g.shape),
                                           atol=1e-4, rtol=rtol)


def test_roi_align_feature_grad_card_matches_cpu(cuda_device):
    """The features' gradient of RoIAlign on the card (K3 forward, K4
    backward, one launch each) against the CPU's (autograd of the plain
    sampling), at boxes inside, across and outside the map: atol/rtol 1e-4
    (the order of the atomics)."""
    gen = torch.Generator().manual_seed(0)
    feat = torch.randn((2, 10, 13, 16), generator=gen)
    boxes = torch.rand((2, 17, 4), generator=gen) * 56 - 8
    boxes = torch.cat([torch.minimum(boxes[..., :2], boxes[..., 2:]),
                       torch.maximum(boxes[..., :2], boxes[..., 2:])], -1)
    co = torch.randn((2, 17, 7, 7, 16), generator=gen)
    grads = []
    fwd, bwd = hs.hat_sample.launches, hs.hat_sample_bwd.launches
    for dev in ("cpu", cuda_device):
        f = feat.to(dev).detach().requires_grad_()
        (roi_align(f, boxes.to(dev), output_size=7, spatial_scale=0.25)
         * co.to(dev)).sum().backward()
        grads.append(f.grad.cpu())
    assert hs.hat_sample.launches == fwd + 1
    assert hs.hat_sample_bwd.launches == bwd + 1
    torch.testing.assert_close(grads[1], grads[0], atol=1e-4, rtol=1e-4)


TEMPORAL = {
    "transvod_pp": (dict(temporal_mode="transvod_pp", num_ref_frames=2), 8,
                    1),
    "transvod_tdam": (dict(temporal_mode="transvod", use_tdam=True,
                           num_ref_frames=5), 7, 0),
}


@pytest.mark.parametrize("name", list(TEMPORAL))
def test_small_temporal_model_card_matches_cpu(cuda_device, name):
    """A small TransVOD++ or TransVOD+TDAM (5 reference frames: K1 at 5
    levels) model on the card against the same weights on the CPU, f32,
    2 padded clips: every head atol 1e-4 / rtol 1e-3, TF32 off; the card
    launches K1 once per deformable layer and K3 once for TransVOD++."""
    kw, k1_want, k3_want = TEMPORAL[name]
    cfg = Config(model=ModelConfig(**dict(SMALL, num_queries=100), **kw))
    cpu_model, _, _ = build_model(cfg, device="cpu", seed=3)
    gpu_model, _, _ = build_model(cfg, device=cuda_device, seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    F = 1 + kw["num_ref_frames"]
    gen = torch.Generator().manual_seed(2)
    x = torch.randint(0, 256, (2 * F, 96, 128, 4), generator=gen,
                      dtype=torch.uint8)
    sizes = torch.tensor([[96, 128]] * (2 * F))
    sizes[1], sizes[F] = torch.tensor([60, 84]), torch.tensor([80, 128])
    k1, k3 = msda.ms_deform_attn.launches, hs.hat_sample.launches
    with torch.no_grad():
        ref = cpu_model(*device_normalize(x, sizes))
        got = gpu_model(*device_normalize(x.to(cuda_device),
                                          sizes.to(cuda_device)))
    assert msda.ms_deform_attn.launches == k1 + k1_want
    assert hs.hat_sample.launches == k3 + k3_want
    pairs = [(got, ref), (got["_single_frame"], ref["_single_frame"])]
    pairs += list(zip(got.get("aux_outputs", []), ref.get("aux_outputs",
                                                          [])))
    for g, r in pairs:
        for k in ("pred_logits", "pred_boxes"):
            torch.testing.assert_close(g[k].cpu(), r[k], atol=1e-4,
                                       rtol=1e-3)


def test_small_video_train_step_card_matches_cpu(cuda_device):
    """One train-step loss and every gradient of a small TransVOD++ model on
    one padded clip: the card (K1-K4) against the same weights and batch on
    the CPU, f32, dropout 0, TF32 off. Loss and components atol 1e-5 /
    rtol 1e-4; gradients per tensor within 1e-2 in relative L2 norm (a
    structurally zero one atol 1e-4), as ``chip_smoke.py`` compares its
    small video steps: the trunk trains, and its ReLUs make the gradients
    too ill-conditioned for an elementwise comparison
    (``tests/test_torch_temporal_train.py``)."""
    cfg = Config(model=ModelConfig(**dict(SMALL, num_queries=100),
                                   **TEMPORAL["transvod_pp"][0]))
    cpu_model, criterion, _ = build_model(cfg, device="cpu", seed=3)
    gpu_model, _, _ = build_model(cfg, device=cuda_device, seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(1)
    F, T = 3, 8
    sizes = torch.tensor([[96, 128], [60, 84], [96, 128]])
    batch = {"images": torch.randint(0, 256, (F, 96, 128, 4), generator=gen,
                                     dtype=torch.uint8),
             "sizes": sizes,
             "labels": torch.randint(0, 2, (F, T), generator=gen),
             "boxes": torch.cat([torch.rand((F, T, 2), generator=gen) * 0.6
                                 + 0.2, torch.rand((F, T, 2), generator=gen)
                                 * 0.3 + 0.05], -1),
             "valid": torch.arange(T)[None] < torch.tensor([[3], [5], [2]])}
    results = []
    k4 = hs.hat_sample_bwd.launches
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda_device)):
        state = create_train_state(model, cfg)
        loss, parts = criterion(*forward(
            state, {k: v.to(dev) for k, v in batch.items()}))
        loss.backward()
        results.append(({"loss": loss.detach(), **parts},
                        {n: p.grad for n, p in model.named_parameters()
                         if p.grad is not None}))
    assert hs.hat_sample_bwd.launches == k4 + 1
    (ref_parts, ref_grads), (parts, grads) = results
    for k, r in ref_parts.items():
        torch.testing.assert_close(parts[k].detach().cpu(), r.detach(),
                                   atol=1e-5, rtol=1e-4)
    assert grads.keys() == ref_grads.keys()
    for n, r in ref_grads.items():
        g = grads[n].cpu()
        rel = float((g - r).norm() / r.norm().clamp_min(1e-30))
        assert rel <= 1e-2 or (float(r.abs().max()) < 1e-4 and float(
            (g - r).abs().max()) <= 1e-4), (n, rel)


# ------------------------------------------------- the opt-in forms (K5, K6)
def rounded_close(got, ref):
    """f32 atol/rtol 1e-5; a bf16 output against the f32 plain version on
    the same bf16 value, atol 1e-5 / rtol 2^-8 (rounded once)."""
    rtol = 1e-5 if got.dtype == torch.float32 else 2.0 ** -8
    torch.testing.assert_close(got.float(), ref, atol=1e-5, rtol=rtol)


@pytest.mark.parametrize("vdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_corner_gather_kernel_matches_plain(cuda_device, case, vdt):
    """K5b/c on the folded corners of MSDA's flat form, one launch."""
    shapes, value, loc, attw, _ = msda_inputs(
        cuda_device, case, (vdt, torch.float32, torch.float32))
    idx, w = cg.corner_indices_weights(shapes, loc, attw)
    before = cg.corner_gather.launches
    got = cg.corner_gather(value, idx, w)
    torch.cuda.synchronize()
    assert cg.corner_gather.launches == before + 1
    assert got.dtype == vdt and got.shape == value.shape[:1] + idx.shape[1:3] \
        + value.shape[-1:]
    rounded_close(got, cg.corner_gather_plain(value.float(), idx, w))


@pytest.mark.parametrize("D", [8, 32, 40])
def test_onehot_sample_kernel_out_of_range_indices(cuda_device, D):
    """The JAX layout (BM, S, D) with indices in [-5, S + 5): an index
    outside [0, S) contributes 0, as the one-hot matrix's row with no
    match and the row gather's ``fill_value=0``."""
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    for dt in (torch.float32, torch.bfloat16):
        v = torch.randn((3, 50, D), generator=gen, device=cuda_device).to(dt)
        idx = torch.randint(-5, 55, (3, 133, 12), generator=gen,
                            device=cuda_device, dtype=torch.int32)
        w = torch.randn((3, 133, 12), generator=gen, device=cuda_device)
        got = cg.onehot_sample(v, idx, w)
        inside = (idx >= 0) & (idx < 50)
        ref = cg.onehot_sample(v.float().cpu(), idx.clamp(0, 49).cpu(),
                               torch.where(inside, w, 0.0).cpu())
        rounded_close(got.cpu(), ref)


# (D, value dtype, K, value one element into its buffer) -> the path the
# C entry reports: the vector kernel for rows of whole 16-byte chunks (D =
# 40 bf16 is 5 of them, a slot of 8 lanes with 3 idle; f32 D = 256 is 64,
# two chunks per lane), K a multiple of 4 and aligned pointers; the scalar
# kernel for D = 5, K = 6 and a view one element into its buffer
GATHER_PATHS = {
    "d8_f32": (8, torch.float32, 16, False, "vector"),
    "d8_bf16": (8, torch.bfloat16, 16, False, "vector"),
    "d32_f32": (32, torch.float32, 16, False, "vector"),
    "d32_bf16": (32, torch.bfloat16, 16, False, "vector"),
    "d64_f32": (64, torch.float32, 12, False, "vector"),
    "d64_bf16": (64, torch.bfloat16, 12, False, "vector"),
    "d256_f32": (256, torch.float32, 8, False, "vector"),
    "d256_bf16": (256, torch.bfloat16, 8, False, "vector"),
    "d40_bf16": (40, torch.bfloat16, 16, False, "vector"),
    "d5_f32": (5, torch.float32, 16, False, "scalar"),
    "d5_bf16": (5, torch.bfloat16, 16, False, "scalar"),
    "d32_offset": (32, torch.bfloat16, 16, True, "scalar"),
    "k6_bf16": (32, torch.bfloat16, 6, False, "scalar"),
}


@pytest.mark.parametrize("case", list(GATHER_PATHS))
def test_corner_gather_kernel_paths(cuda_device, case):
    """K5b/c on each path against its plain version, with indices in [-5,
    S + 5) (outside [0, S) they add 0), 37 queries (no whole number of
    queries per warp) and 3 heads; the C entry's count of the path taken
    grows by one, the other's by none."""
    D, dt, K, offset, path = GATHER_PATHS[case]
    B, S, Lq, M = 2, 70, 37, 3
    gen = torch.Generator(device=cuda_device).manual_seed(D * K)
    value = torch.randn((B, S, M, D), generator=gen,
                        device=cuda_device).to(dt)
    if offset:
        value = offset_view(value)
    idx = torch.randint(-5, S + 5, (B, Lq, M, K), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    w = torch.randn((B, Lq, M, K), generator=gen, device=cuda_device)
    before = cg.kernel_paths()
    got = cg.corner_gather(value, idx, w)
    torch.cuda.synchronize()
    after = cg.kernel_paths()
    assert {k: after[k] - before[k] for k in after} == {
        "vector": int(path == "vector"), "scalar": int(path == "scalar")}
    assert got.dtype == dt and got.shape == (B, Lq, M, D)
    rounded_close(got, cg.corner_gather_plain(value.float(), idx, w))


# (spatial_shapes, B, Lq, P); one_level_p3: Lq = 37, which no number of
# queries per warp divides, and 3 points per query, so a query's 4 slots
# hold one idle
SPARSE = {"one_level": (((9, 11),), 2, 131, 4),
          "one_level_p3": (((9, 11),), 2, 37, 3),
          "four_levels": (((12, 16), (6, 8), (3, 4), (2, 2)), 1, 70, 2)}
# D -> the path K5a's C entry takes for an (f32, bf16) value: the vector
# kernel for rows of whole 16-byte chunks, at most 32 of them (D = 12 in
# f32 is 3, a slot of 4 lanes with one idle; D = 40 is 10 in f32, 5 in
# bf16; D = 256 in bf16 is 32, one point per warp, 8 or 16 rounds at four
# levels x P = 2 or 4); the scalar kernel for D = 12 in bf16 (24 bytes)
# and D = 256 in f32 (64 chunks)
SPARSE_PATHS = {8: ("vector", "vector"), 12: ("vector", "scalar"),
                32: ("vector", "vector"), 40: ("vector", "vector"),
                256: ("scalar", "vector")}


def sparse_path_delta(before, path):
    after = hs.kernel_paths()
    assert {k: after[k] - before[k] for k in after} == {
        "vector": int(path == "vector"), "scalar": int(path == "scalar")}


@pytest.mark.parametrize("D", list(SPARSE_PATHS))
@pytest.mark.parametrize("case", list(SPARSE))
def test_hat_sparse_kernel_matches_plain(cuda_device, case, D):
    """K5a against its plain version: each point on its own level, points
    outside it, a query whose every point is NaN (exactly 0), f32 and bf16,
    each on the path the table above names, as the C entry counts it."""
    shapes, B, Lq, P = SPARSE[case]
    L, S, M = len(shapes), sum(h * w for h, w in shapes), 2
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    loc = torch.rand((B, Lq, M, L, P, 2), generator=gen,
                     device=cuda_device) * 1.6 - 0.3
    loc[:, :2] = float("nan")
    attw = torch.rand((B, Lq, M, L, P), generator=gen, device=cuda_device)
    for dt, path in zip((torch.float32, torch.bfloat16), SPARSE_PATHS[D]):
        value = torch.randn((B, S, M, D), generator=gen,
                            device=cuda_device).to(dt)
        before = hs.hat_sample_sparse.launches
        paths = hs.kernel_paths()
        got = mf.ms_deform_attn_hat(value, shapes, loc, attw, sparse=True)
        torch.cuda.synchronize()
        assert hs.hat_sample_sparse.launches == before + 1
        sparse_path_delta(paths, path)
        assert got.dtype == dt and got.shape == (B, Lq, M * D)
        assert bool((got[:, :2] == 0).all())
        ref = mf.ms_deform_attn_hat(value.float().cpu(), shapes, loc.cpu(),
                                    attw.cpu(), sparse=True)
        rounded_close(got.cpu(), ref)
        # the same function as K1 wherever the points are finite; py
        # carries the level offset, rounded once in f32 (atol 5e-5)
        k1 = msda.ms_deform_attn_plain(value.float(), shapes, loc, attw)
        torch.testing.assert_close(
            got[:, 2:].float(), k1[:, 2:], atol=5e-5,
            rtol=1e-5 if dt == torch.float32 else 2.0 ** -8)


@pytest.mark.parametrize("case", list(SPARSE))
def test_hat_sparse_kernel_unaligned_value_takes_the_scalar_path(
        cuda_device, case):
    """K5a on a contiguous value one element past a 16-byte boundary, D =
    32: the scalar kernel, in f32 and bf16, against the plain version."""
    shapes, B, Lq, P = SPARSE[case]
    L, S, BM, D = len(shapes), sum(h * w for h, w in shapes), 2 * B, 32
    gen = torch.Generator(device=cuda_device).manual_seed(L * P)
    loc = torch.rand((BM, Lq, L, P, 2), generator=gen,
                     device=cuda_device) * 1.6 - 0.3
    pxs, pys, yo = [], [], 0.0
    for lvl, (h, w) in enumerate(shapes):
        pxs.append(loc[:, :, lvl, :, 0] * w - 0.5)
        pys.append(loc[:, :, lvl, :, 1] * h - 0.5 + yo)
        yo += h + 2.0
    px, py = torch.cat(pxs, -1), torch.cat(pys, -1)
    aw = torch.rand((BM, Lq, L * P), generator=gen, device=cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        value = offset_view(torch.randn((BM, S, D), generator=gen,
                                        device=cuda_device).to(dt))
        paths = hs.kernel_paths()
        got = hs.hat_sample_sparse(value, shapes, px, py, aw)
        torch.cuda.synchronize()
        sparse_path_delta(paths, "scalar")
        rounded_close(got.cpu(), hs.hat_sample_sparse_plain(
            value.float().cpu(), shapes, px.cpu(), py.cpu(), aw.cpu()))


@pytest.mark.parametrize("impl", [None, *msda.IMPLS])
def test_dispatch_launches_per_impl(cuda_device, monkeypatch, impl):
    """``DFVOD_MSDA_IMPL`` on the card: unset, ``xla`` and ``pallas_hat``
    launch K1, the flat family K5b/c, once; each output equals its plain
    version. The tiled and separable entries launch K1 whatever the
    variable says."""
    if impl is None:
        monkeypatch.delenv("DFVOD_MSDA_IMPL", raising=False)
    else:
        monkeypatch.setenv("DFVOD_MSDA_IMPL", impl)
    shapes, value, loc, attw, _ = msda_inputs(cuda_device, "multi_odd_d",
                                              DTYPES["f32"])
    gather = impl in msda.GATHER_IMPLS
    counts = (msda.ms_deform_attn.launches, cg.corner_gather.launches)
    got = msda.ms_deform_attn(value, shapes, loc, attw)
    torch.cuda.synchronize()
    assert (msda.ms_deform_attn.launches - counts[0],
            cg.corner_gather.launches - counts[1]) == (
        (0, 1) if gather else (1, 0))
    ref = msda.ms_deform_attn_plain(value, shapes, loc, attw)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown impl"):
        msda.ms_deform_attn(value, shapes, loc, attw, impl="cuda")
    shapes, value, loc, attw, _ = msda_inputs(cuda_device, "enc",
                                              DTYPES["f32"])
    for entry in (mf.ms_deform_attn_hat_tiled, mf.ms_deform_attn_hat_sep):
        before = msda.ms_deform_attn.launches
        got = entry(value, shapes, loc, attw)
        torch.cuda.synchronize()
        assert msda.ms_deform_attn.launches == before + 1
        torch.testing.assert_close(
            got, msda.ms_deform_attn_plain(value, shapes, loc, attw),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["flat", "pallas", "pallas_onehot"])
def test_gather_form_grads_card_match_cpu(cuda_device, impl):
    """The flat family on the card is K5b/c forward and K2 backward, one
    launch each and none of K1; the module's projections get the CPU's
    gradients (the flat form's autograd) within atol 1e-4 / rtol 1e-3."""
    torch.manual_seed(0)
    cpu = MSDeformAttn(64, 2, 4, 4, impl=impl)
    with torch.no_grad():
        cpu.sampling_offsets.weight.normal_(0, 0.02)
        cpu.attention_weights.weight.normal_(0, 0.2)
    gpu = MSDeformAttn(64, 2, 4, 4, impl=impl).to(cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    shapes = ((6, 8), (3, 4))
    query, src = torch.randn(2, 20, 64), torch.randn(2, 60, 64)
    ref = torch.rand(2, 20, 2, 2)
    counts = (msda.ms_deform_attn.launches, cg.corner_gather.launches,
              msda.ms_deform_attn_bwd.launches)
    outs = []
    for mod, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        out = mod(query.to(dev), ref.to(dev), src.to(dev), shapes)
        out.square().sum().backward()
        outs.append(out.detach().cpu())
    assert (msda.ms_deform_attn.launches, cg.corner_gather.launches,
            msda.ms_deform_attn_bwd.launches) == (
        counts[0], counts[1] + 1, counts[2] + 1)
    torch.testing.assert_close(outs[1], outs[0], atol=1e-4, rtol=1e-3)
    for name in ("value_proj", "sampling_offsets", "attention_weights"):
        g = getattr(gpu, name).weight.grad
        assert g is not None and bool(g.abs().sum() > 0), name
        torch.testing.assert_close(g.cpu(), getattr(cpu, name).weight.grad,
                                   atol=1e-4, rtol=1e-3)


def random_blocks(gen, cin, cm, nblocks, device):
    """Per block (w1, b1, w2, b2, w3, b3, wd, bd): bf16 weights in matmul
    layouts, f32 biases; a projection on the first block."""
    def w(*shape):
        return (torch.randn(shape, generator=gen, device=device)
                * shape[-2] ** -0.5).bfloat16()

    def b(n):
        return torch.randn((n,), generator=gen, device=device) * 0.5

    blks = []
    for i in range(nblocks):
        c = cin if i == 0 else 4 * cm
        proj = i == 0 and c != 4 * cm
        blks.append((w(c, cm), b(cm), w(3, 3, cm, cm), b(cm), w(cm, 4 * cm),
                     b(4 * cm), w(c, 4 * cm) if proj else None,
                     b(4 * cm) if proj else None))
    return blks


def k6_close(got, ref):
    """K6 sums each product on the tensor cores, the plain version with
    f32 FMAs, so a bf16 rounding of t, u or a block's output may fall one
    step the other way and carry into the next block: relative L2 within
    2e-3 (``chip_smoke.py::k6_agrees`` has the readings), every entry
    within 2^-5 of the largest output."""
    d = (got.float() - ref.float()).abs()
    assert float(d.norm() / ref.float().norm()) <= 2e-3
    assert float(d.max()) <= 2.0 ** -5 * float(ref.float().abs().max())


# (x shape, Cin, Cm): whole tiles, H and W no multiple of the 8 x 16 tile,
# a grid smaller than one tile, layer1's channels and others
FUSED = {"tile": ((1, 8, 16, 64), 64, 64), "odd": ((2, 149, 37, 64), 64, 64),
         "tiny": ((3, 5, 3, 64), 64, 64), "narrow": ((2, 19, 21, 32), 32, 16),
         "identity_first": ((1, 9, 30, 64), 64, 16)}


# cases of K6's layer1 path (Cm = 64, Cout = 256): a tile count below the
# SM count (4, and 45 with ragged borders), one above it that is no
# multiple of the persistent grid (180 tiles), and W = 200 (the serve
# width: the last tile column half outside) through the Cin = 256 blocks
FUSED.update({"few_tiles": ((1, 16, 32, 64), 64, 64),
              "ragged_45": ((3, 37, 45, 64), 64, 64),
              "tiles_180": ((3, 75, 90, 64), 64, 64),
              "w200": ((2, 21, 200, 64), 64, 64)})
# the path the C entry reports for each case's three launches
FUSED_PATHS = {"tile": "layer1", "odd": "layer1", "tiny": "layer1",
               "narrow": "generic", "identity_first": "generic",
               "few_tiles": "layer1", "ragged_45": "layer1",
               "tiles_180": "layer1", "w200": "layer1"}


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_bottleneck_kernel_matches_plain(cuda_device, case):
    """K6, one launch per block, against the plain fused stage on the same
    card: borders included (the 3x3's padding is 0, not relu(b1))."""
    shape, cin, cm = FUSED[case]
    gen = torch.Generator(device=cuda_device).manual_seed(len(case))
    x = torch.relu(torch.randn(shape, generator=gen,
                               device=cuda_device)).bfloat16()
    blks = random_blocks(gen, cin, cm, 3, cuda_device)
    before = fb.fused_bottleneck_stage.launches
    got = fb.fused_bottleneck_stage(x, blks)
    torch.cuda.synchronize()
    assert fb.fused_bottleneck_stage.launches == before + 3
    assert got.dtype == torch.bfloat16 and got.shape == shape[:3] + (4 * cm,)
    assert bool(torch.isfinite(got.float()).all())
    k6_close(got, fb.fused_stage_plain(x, blks))


@pytest.mark.parametrize("case", list(FUSED))
def test_fused_bottleneck_kernel_paths(cuda_device, case):
    """Each case's three launches take the path the C entry reports for
    it, and agree with the plain stage."""
    shape, cin, cm = FUSED[case]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.relu(torch.randn(shape, generator=gen,
                               device=cuda_device)).bfloat16()
    blks = random_blocks(gen, cin, cm, 3, cuda_device)
    before = fb.kernel_paths()
    got = fb.fused_bottleneck_stage(x, blks)
    torch.cuda.synchronize()
    after = fb.kernel_paths()
    want = FUSED_PATHS[case]
    assert {k: after[k] - before[k] for k in after} == {
        "layer1": 3 * (want == "layer1"), "generic": 3 * (want == "generic")}
    k6_close(got, fb.fused_stage_plain(x, blks))


def test_fused_bottleneck_serve_shape_takes_the_layer1_path(cuda_device):
    """Layer1 at the serve shape, (8, 152, 200, 64) bf16: three launches of
    the layer1 path by the C entry's count, within K6's gate of the plain
    stage."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.relu(torch.randn((8, 152, 200, 64), generator=gen,
                               device=cuda_device)).bfloat16()
    blks = random_blocks(gen, 64, 64, 3, cuda_device)
    before = fb.kernel_paths()
    got = fb.fused_bottleneck_stage(x, blks)
    torch.cuda.synchronize()
    after = fb.kernel_paths()
    assert {k: after[k] - before[k] for k in after} == {"layer1": 3,
                                                        "generic": 0}
    assert bool(torch.isfinite(got.float()).all())
    k6_close(got, fb.fused_stage_plain(x, blks))


def test_fused_bottleneck_refuses_a_strided_view(cuda_device):
    """K6 reads no strides: a non-contiguous NHWC view raises, as do f32
    activations; nothing falls back to the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    blks = random_blocks(gen, 64, 64, 1, cuda_device)
    x = torch.randn((1, 8, 16, 64), device=cuda_device).bfloat16()
    before = fb.fused_bottleneck_stage.launches
    with pytest.raises(ValueError, match="contiguous"):
        fb.fused_bottleneck_stage(x.transpose(1, 2), blks)
    with pytest.raises(TypeError, match="bf16"):
        fb.fused_bottleneck_stage(x.float(), blks)
    assert fb.fused_bottleneck_stage.launches == before


def test_resnet50_fused_layer1_on_the_card(cuda_device):
    """A ``ResNet50(fused_stages=True)`` in bf16 eval, channels-last, on the
    card: layer1 launches K6 three times with no copy of its input, and the
    stages agree with the f32 unfused ResNet on the CPU within bf16's reach
    (relative L2 3e-2, as on the CPU)."""
    torch.manual_seed(0)
    ref = br.ResNet50(return_stages=(1, 2)).eval()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, br.FrozenBatchNorm):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    model = br.ResNet50(return_stages=(1, 2), fused_stages=True).eval()
    model.load_state_dict(ref.state_dict())
    model = model.to(device=cuda_device, dtype=torch.bfloat16,
                     memory_format=torch.channels_last)
    x = torch.randn(2, 64, 96, 3)
    before = fb.fused_bottleneck_stage.launches
    with torch.no_grad():
        want = ref(x)
        got = model(x.to(cuda_device).bfloat16())
    torch.cuda.synchronize()
    assert fb.fused_bottleneck_stage.launches == before + 3
    for s in (1, 2):
        err = float((got[s].float().cpu() - want[s]).norm() / want[s].norm())
        assert err < 3e-2, (s, err)


# ------------------------------------------------ the other fusion modes
# Backbone_CrossFusion's stage-2 fusion site at 608x800 has 76x100 RGB
# queries onto a 152x200 depth map: a copy at a quarter of each side, the
# query grid at half the value grid's resolution (Lq:S = 1:4)
CF_STAGE2 = (((38, 50),), 2, 19 * 25, 8, 32, 4)
FUSION_LAUNCHES = {"Encoder_CrossFusion": 2 + 2 + 2,
                   "Backbone_CrossFusion": 3 + 2 + 2}


def paths_delta(name, fn):
    """(fn(), {"vector": n, "scalar": n}): the launches of each kernel of
    ``csrc/<name>.cu`` during ``fn``, as its C entry counts them."""
    before = msda.kernel_paths(name)
    out = fn()
    torch.cuda.synchronize()
    after = msda.kernel_paths(name)
    return out, {k: after[k] - before[k] for k in after}


def stage2_inputs(device, dtypes):
    shapes, B, Lq, M, D, P = CF_STAGE2
    gen = torch.Generator(device=device).manual_seed(5)
    S = shapes[0][0] * shapes[0][1]
    value = torch.randn((B, S, M, D), generator=gen, device=device)
    loc = torch.rand((B, Lq, M, 1, P, 2), generator=gen,
                     device=device) * 1.2 - 0.1
    attw = torch.randn((B, Lq, M, P), generator=gen,
                       device=device).softmax(-1).reshape(B, Lq, M, 1, P)
    go = torch.randn((B, Lq, M * D), generator=gen, device=device)
    vdt, ldt, adt = dtypes
    return shapes, value.to(vdt), loc.to(ldt), attw.to(adt), go.to(vdt)


@pytest.mark.parametrize("dtypes", ["f32", "bf16_serving"])
def test_kernel_at_crossfusion_stage2_geometry(cuda_device, dtypes):
    """K1 on the stage-2 geometry (CF_STAGE2) takes its vector kernel and
    agrees with the plain version: f32 atol/rtol 1e-5, bf16 atol 3e-2."""
    shapes, value, loc, attw, _ = stage2_inputs(cuda_device, DTYPES[dtypes])
    got, paths = paths_delta("msda_fwd", lambda: msda.ms_deform_attn(
        value, shapes, loc, attw))
    assert paths == {"vector": 1, "scalar": 0}
    ref = msda.ms_deform_attn_plain(value.float(), shapes, loc.float(),
                                    attw.float())
    if value.dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)
    else:
        torch.testing.assert_close(got.float(), ref, atol=3e-2, rtol=0)


@pytest.mark.parametrize("dtypes", ["f32", "bf16_training"])
def test_bwd_kernel_at_crossfusion_stage2_geometry(cuda_device, dtypes):
    """K2 on the stage-2 geometry (CF_STAGE2), all three gradients, takes
    its vector kernel and agrees with the plain backward: f32 atol/rtol
    1e-4, bf16 atol 3e-2 / rtol 2e-2."""
    shapes, value, loc, attw, go = stage2_inputs(cuda_device,
                                                 DTYPES[dtypes])
    got, paths = paths_delta("msda_bwd", lambda: msda.ms_deform_attn_bwd(
        value, shapes, loc, attw, go))
    assert paths == {"vector": 1, "scalar": 0}
    ref = msda.ms_deform_attn_plain_bwd(value.float(), shapes, loc.float(),
                                        attw.float(), go.float())
    atol, rtol = ((1e-4, 1e-4) if value.dtype == torch.float32
                  else (3e-2, 2e-2))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g.float(), r, atol=atol, rtol=rtol)


def fusion_models(mode, device):
    cfg = Config(model=ModelConfig(**dict(SMALL, fusion_type=mode)))
    cpu_model, criterion, _ = build_model(cfg, device="cpu", seed=3)
    gpu_model, _, _ = build_model(cfg, device=device, seed=3)
    gpu_model.load_state_dict(cpu_model.state_dict())
    return cfg, cpu_model, gpu_model, criterion


@pytest.mark.parametrize("mode", list(FUSION_LAUNCHES))
def test_small_fusion_model_card_matches_cpu(cuda_device, mode):
    """A small model of each mode on the card against the same weights on
    the CPU, f32, padded input: atol 1e-4 / rtol 1e-3, TF32 off; K1 runs
    once per MSDA layer (2 + 2 + 2 with Encoder_CrossFusion's 2 fusion
    layers, 3 + 2 + 2 with Backbone_CrossFusion's 3 fusion sites)."""
    _, cpu_model, gpu_model, _ = fusion_models(mode, cuda_device)
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (2, 96, 128, 4), generator=gen,
                      dtype=torch.uint8)
    sizes = torch.tensor([[96, 128], [60, 84]])
    before = msda.ms_deform_attn.launches
    with torch.no_grad():
        ref = cpu_model(*device_normalize(x, sizes))
        got = gpu_model(*device_normalize(x.to(cuda_device),
                                          sizes.to(cuda_device)))
    assert msda.ms_deform_attn.launches == before + FUSION_LAUNCHES[mode]
    for k in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(got[k].cpu(), ref[k], atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("mode", list(FUSION_LAUNCHES))
def test_small_fusion_train_step_card_matches_cpu(cuda_device, mode):
    """One train-step loss and every gradient of a small model of each
    mode, card against CPU, f32, dropout 0, padded frames. Loss and
    components atol 1e-5 / rtol 1e-4; gradients atol 1e-4 / rtol 1e-3,
    except Backbone_CrossFusion's backbone (the ResNet-50, depth path and
    fusion sites, which train): within 1e-2 in relative L2 norm, as
    ``chip_smoke.py`` holds a training trunk, since its ReLUs make the
    gradients ill-conditioned. K1 and K2 launch once per MSDA layer."""
    cfg, cpu_model, gpu_model, criterion = fusion_models(mode, cuda_device)
    gen = torch.Generator().manual_seed(1)
    B, T = 2, 8
    valid = torch.arange(T)[None] < torch.tensor([[3], [5]])
    batch = {"images": torch.randint(0, 256, (B, 96, 128, 4), generator=gen,
                                     dtype=torch.uint8),
             "sizes": torch.tensor([[96, 128], [60, 84]]),
             "labels": torch.randint(0, 2, (B, T), generator=gen),
             "boxes": torch.cat([torch.rand((B, T, 2), generator=gen) * 0.6
                                 + 0.2, torch.rand((B, T, 2), generator=gen)
                                 * 0.3 + 0.05], -1),
             "valid": valid}
    results = []
    fwd, bwd = msda.ms_deform_attn.launches, msda.ms_deform_attn_bwd.launches
    for model, dev in ((cpu_model, "cpu"), (gpu_model, cuda_device)):
        state = create_train_state(model, cfg)
        loss, parts = criterion(*forward(
            state, {k: v.to(dev) for k, v in batch.items()}))
        loss.backward()
        results.append(({"loss": loss.detach(), **parts},
                        {n: p.grad for n, p in model.named_parameters()
                         if p.grad is not None}))
    n = FUSION_LAUNCHES[mode]
    assert msda.ms_deform_attn.launches == fwd + n
    assert msda.ms_deform_attn_bwd.launches == bwd + n
    (ref_parts, ref_grads), (parts, grads) = results
    for k, r in ref_parts.items():
        torch.testing.assert_close(parts[k].detach().cpu(), r.detach(),
                                   atol=1e-5, rtol=1e-4)
    assert grads.keys() == ref_grads.keys()
    trunk = mode == "Backbone_CrossFusion"
    assert trunk == ("backbone.conv1.weight" in grads)
    for name, r in ref_grads.items():
        g = grads[name].cpu()
        if trunk and name.startswith("backbone."):
            rel = float((g - r).norm() / r.norm().clamp_min(1e-30))
            assert rel <= 1e-2 or float((g - r).abs().max()) <= 1e-4, (
                name, rel)
        else:
            torch.testing.assert_close(g, r, atol=1e-4, rtol=1e-3)


# ------------------------------------------------------ data path and CLI
SYNTH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "datasets", "synth_rgbd", "coco")


def test_loader_batches_on_the_card_equal_the_host_batch(cuda_device):
    """val.json's first batches through the loader, pinned and copied
    ``non_blocking`` to the card: every key equal to the host batch."""
    from dfvod_tpu_torch.data.dataset import CocoDetectionDataset
    from dfvod_tpu_torch.data.loader import Loader
    from dfvod_tpu_torch.data.transforms import EvalTransform
    ds = CocoDetectionDataset(os.path.join(SYNTH, "images"),
                              os.path.join(SYNTH, "annotations", "val.json"),
                              use_depth=True, train=False)
    kw = dict(batch_size=8, use_depth=True, shuffle=False)
    host = Loader(ds, EvalTransform(600, 1333), **kw)
    card = Loader(ds, EvalTransform(600, 1333), device=cuda_device, **kw)
    for n, (h, c) in enumerate(zip(host, card)):
        assert h.keys() == c.keys()
        for k, v in h.items():
            assert c[k].is_cuda
            np.testing.assert_array_equal(c[k].cpu().numpy(), v, err_msg=k)
        if n == 2:
            break


def synth_tree(root):
    """8 frames of datasets/synth_rgbd (RGB and depth) under ``root`` as
    the reference's layout, train.json = val.json."""
    import json
    import shutil
    dirs = [os.path.join(root, "coco", d) for d in ("images", "depth_pred",
                                                    "annotations")]
    for d in dirs:
        os.makedirs(d)
    with open(os.path.join(SYNTH, "annotations", "val.json")) as f:
        val = json.load(f)
    images = val["images"][:8]
    ids = {im["id"] for im in images}
    for im in images:
        for src, dst in zip(("images", "depth_pred"), dirs):
            shutil.copy(os.path.join(SYNTH, src, im["file_name"]), dst)
    ds = {**val, "images": images,
          "annotations": [a for a in val["annotations"]
                          if a["image_id"] in ids]}
    for split in ("train", "val"):
        with open(os.path.join(dirs[2], f"{split}.json"), "w") as f:
            json.dump(ds, f)
    return root


def test_cli_epoch_on_the_card_matches_the_cpu(cuda_device, tmp_path):
    """One epoch (one step of 8 frames, f32, dropout 0) of a small
    LateFusion model through ``cli.main`` on the card and on the CPU: the
    losses within the train step's gate (atol 1e-5 / rtol 1e-4); every
    parameter within the gradient gate (atol 1e-4 / rtol 1e-3) or within
    twice Adam's step, 2.01 lr (``chip_smoke.params_agree``: where K2's
    summation order flips a noise-level gradient's sign, the two runs step
    an entry in opposite directions). The card's run launches K1 and K2 3
    times in its step (1 encoder, 1 depth encoder, 1 decoder layer) and K1
    3 times in its final evaluation of one batch."""
    import json
    from dfvod_tpu_torch.cli import main as cli
    from dfvod_tpu_torch.train.optim import label_params
    from dfvod_tpu_torch.utils.checkpoint import load_checkpoint
    tree = synth_tree(str(tmp_path / "data"))
    lr = 1e-5

    def argv(out):
        return ["--coco_path", tree, "--output_dir", str(out),
                "--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1",
                "--dec_layers", "1", "--dim_feedforward", "64",
                "--num_queries", "12", "--dropout", "0",
                "--num_feature_levels", "1", "--dilation",
                "--with_box_refine", "--fusion_type", "LateFusion",
                "--dformer_backbone", "--batch_size", "8", "--epochs", "1",
                "--train_short_sides", "96", "--eval_short_side", "96",
                "--max_size", "128", "--lr", str(lr), "--device_preprocess"]

    fwd, bwd = msda.ms_deform_attn.launches, msda.ms_deform_attn_bwd.launches
    logs, params = [], []
    for dev in ("cpu", cuda_device):
        out = tmp_path / str(dev)
        stats = cli.main(argv(out), device=dev)
        assert all(np.isfinite(v) for v in stats.values())
        with open(out / "log.txt") as f:
            logs.append(json.loads(f.readline()))
        params.append(load_checkpoint(str(out))[0]["model"])
    assert msda.ms_deform_attn_bwd.launches - bwd == 3
    assert msda.ms_deform_attn.launches - fwd == 3 + 3
    for k in ("train_loss", "train_loss_ce", "train_loss_bbox",
              "train_loss_giou"):
        np.testing.assert_allclose(logs[1][k], logs[0][k], atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    model = build_model(Config(model=ModelConfig(
        fusion_type="LateFusion", hidden_dim=32, nheads=4, enc_layers=1,
        dec_layers=1, dim_feedforward=64, num_queries=12)), device="cpu")[0]
    mult = {"base": 1.0, "linear_proj": 0.1, "fusion10x": 10.0,
            "frozen": 0.0}
    lrs = {k: lr * mult[label] for k, label in
           label_params(model, "LateFusion").items()}
    for k, r in params[0].items():
        g = params[1][k].cpu().float()
        err = (g - r.float()).abs()
        close = err <= 1e-4 + 1e-3 * r.float().abs()
        assert bool((close | (err <= 2.01 * lrs.get(k, 0.0))).all()), k
