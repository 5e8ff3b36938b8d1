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
the CPU's. They skip without a CUDA device. This file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""
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


# (spatial_shapes, B, Lq, P)
SPARSE = {"one_level": (((9, 11),), 2, 131, 4),
          "four_levels": (((12, 16), (6, 8), (3, 4), (2, 2)), 1, 70, 2)}


@pytest.mark.parametrize("D", [8, 40, 256])
@pytest.mark.parametrize("case", list(SPARSE))
def test_hat_sparse_kernel_matches_plain(cuda_device, case, D):
    """K5a (K3's kernel at one level, the level loop at four) against its
    plain version: each point on its own level, points outside it, a query
    whose every point is NaN (exactly 0), f32 and bf16."""
    shapes, B, Lq, P = SPARSE[case]
    L, S, M = len(shapes), sum(h * w for h, w in shapes), 2
    gen = torch.Generator(device=cuda_device).manual_seed(D)
    loc = torch.rand((B, Lq, M, L, P, 2), generator=gen,
                     device=cuda_device) * 1.6 - 0.3
    loc[:, :2] = float("nan")
    attw = torch.rand((B, Lq, M, L, P), generator=gen, device=cuda_device)
    for dt in (torch.float32, torch.bfloat16):
        value = torch.randn((B, S, M, D), generator=gen,
                            device=cuda_device).to(dt)
        before = hs.hat_sample_sparse.launches
        got = mf.ms_deform_attn_hat(value, shapes, loc, attw, sparse=True)
        torch.cuda.synchronize()
        assert hs.hat_sample_sparse.launches == before + 1
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
