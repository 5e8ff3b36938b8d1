"""Tests of the port that need the card: the CUDA MSDA kernel against its
plain version, and a small model on the card against the same model on the
CPU. They skip without a CUDA device. This file imports neither JAX nor the
JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""
import pytest
import torch

from dfvod_tpu_torch.data.device_pipeline import device_normalize
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.ops import msda
from dfvod_tpu_torch.utils.config import Config, ModelConfig

pytestmark = pytest.mark.cuda

# (spatial_shapes, B, Lq, M, D, P)
CASES = {
    "enc": (((38, 50),), 2, 1900, 8, 32, 4),
    "multi_odd_d": (((7, 9), (4, 5)), 2, 37, 3, 5, 2),
    "three_level_d40": (((5, 6), (3, 3), (2, 2)), 1, 131, 2, 40, 3),
}
DTYPES = {"f32": (torch.float32,) * 3,
          "bf16_serving": (torch.bfloat16, torch.float32, torch.bfloat16),
          "bf16_all": (torch.bfloat16,) * 3}


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
    cfg = Config(model=ModelConfig(
        fusion_type="LateFusion", num_queries=12, hidden_dim=64, nheads=4,
        enc_layers=2, dec_layers=2, dim_feedforward=128))
    cpu_model, _ = build_model(cfg, device="cpu", seed=3)
    gpu_model, _ = build_model(cfg, device=cuda_device, seed=3)
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
