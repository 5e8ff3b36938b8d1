"""Tests of the port that need the card: the CUDA MSDA kernels (forward
and backward, up to TDAM's 5 levels) and the bilinear-sampling kernel under
RoIAlign (K3) against their plain versions, gradients through the MSDA
module on the card, the refused backward through K3, and small models
(single-frame, TransVOD++, TransVOD+TDAM) and a small train step on the
card against the same on the CPU. They skip without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""
import pytest
import torch

from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.models.layers import MSDeformAttn
from dfvod_tpu_torch.ops import hat_sample as hs
from dfvod_tpu_torch.ops import msda
from dfvod_tpu_torch.ops.roi_align import roi_align
from dfvod_tpu_torch.train.engine import create_train_state, forward
from dfvod_tpu_torch.utils.config import Config, ModelConfig

pytestmark = pytest.mark.cuda

# (spatial_shapes, B, Lq, M, D, P)
CASES = {
    "enc": (((38, 50),), 2, 1900, 8, 32, 4),
    "multi_odd_d": (((7, 9), (4, 5)), 2, 37, 3, 5, 2),
    "three_level_d40": (((5, 6), (3, 3), (2, 2)), 1, 131, 2, 40, 3),
    # TDAM with 5 reference frames: 5 levels of one frame's shape
    "five_level_tdam": (((6, 7),) * 5, 2, 42, 2, 16, 4),
}
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
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda_device, case, dtypes):
    """f32: atol/rtol 1e-5. bf16: against the f32 plain version on the same
    bf16-rounded inputs, atol 3e-2 (the output is rounded to bf16)."""
    shapes, B, Lq, M, D, P = CASES[case]
    vdt, ldt, adt = DTYPES[dtypes]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = torch.randn((B, S, M, D), generator=gen, device=cuda_device)
    loc = torch.rand((B, Lq, M, L, P, 2), generator=gen,
                     device=cuda_device) * 1.2 - 0.1
    attw = torch.randn((B, Lq, M, L * P), generator=gen,
                       device=cuda_device).softmax(-1).reshape(
        B, Lq, M, L, P)
    value, loc, attw = value.to(vdt), loc.to(ldt), attw.to(adt)
    before = msda.ms_deform_attn.launches
    got = msda.ms_deform_attn(value, shapes, loc, attw)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn.launches == before + 1
    assert got.dtype == vdt and got.shape == (B, Lq, M * D)
    ref = msda.ms_deform_attn_plain(value.float(), shapes, loc.float(),
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


def msda_inputs(device, case, dtypes, seed=0):
    shapes, B, Lq, M, D, P = CASES[case]
    gen = torch.Generator(device=device).manual_seed(seed)
    L, S = len(shapes), sum(h * w for h, w in shapes)
    value = torch.randn((B, S, M, D), generator=gen, device=device)
    loc = torch.rand((B, Lq, M, L, P, 2), generator=gen,
                     device=device) * 1.2 - 0.1
    attw = torch.randn((B, Lq, M, L * P), generator=gen,
                       device=device).softmax(-1).reshape(B, Lq, M, L, P)
    go = torch.randn((B, Lq, M * D), generator=gen, device=device)
    vdt, ldt, adt = dtypes
    return shapes, value.to(vdt), loc.to(ldt), attw.to(adt), go.to(vdt)


@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_bwd_kernel_matches_plain(cuda_device, case, dtypes):
    """K2 against the plain backward on the same (bf16-rounded) inputs in
    f32: f32 atol/rtol 1e-4 (the order of the atomics), bf16 rtol 2e-2 /
    atol 3e-2 (the JAX package's bf16 backward gate). Gradients come in
    each input's dtype."""
    shapes, value, loc, attw, go = msda_inputs(cuda_device, case,
                                               DTYPES[dtypes])
    before = msda.ms_deform_attn_bwd.launches
    got = msda.ms_deform_attn_bwd(value, shapes, loc, attw, go)
    torch.cuda.synchronize()
    assert msda.ms_deform_attn_bwd.launches == before + 1
    ref = msda.ms_deform_attn_plain_bwd(value.float(), shapes, loc.float(),
                                        attw.float(), go.float())
    atol, rtol = ((1e-4, 1e-4) if value.dtype == torch.float32
                  else (3e-2, 2e-2))
    for g, r, x in zip(got, ref, (value, loc, attw)):
        assert g.dtype == x.dtype and g.shape == x.shape
        torch.testing.assert_close(g.float(), r, atol=atol, rtol=rtol)


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


def test_roi_align_backward_on_card_raises(cuda_device):
    """K3's backward (K4) waits for the TransVOD++ training slice: a
    backward through RoIAlign on the card raises rather than returning no
    gradient for the features."""
    feat = torch.randn(1, 9, 11, 8, device=cuda_device, requires_grad=True)
    boxes = torch.tensor([[[1.0, 1.5, 8.0, 7.0]]], device=cuda_device)
    out = roi_align(feat, boxes, output_size=3)
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="K4"):
        out.sum().backward()


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
