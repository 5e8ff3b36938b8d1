"""The FLOP and byte counts of perfbench/harness/flops.py against hand
counts."""
import pytest
import torch
from torch import nn

from perfbench.harness import flops, spec
from perfbench.reference import model as ref_model
from perfbench.tests import tiny


def counted(fn):
    with torch.device("meta"), flops.flop_counter() as fc:
        fn()
    return fc.get_total_flops()


def test_conv_and_linear_hand_counts():
    with torch.device("meta"):
        conv = nn.Conv2d(64, 128, 3, 2, 1, bias=False)
        lin = nn.Linear(256, 1024)
    # 2 FLOPs a multiply-add: B * Cout * Ho * Wo * Cin * k * k
    assert counted(lambda: conv(torch.empty(2, 64, 32, 48))) == \
        2 * 2 * 128 * 16 * 24 * 64 * 9
    assert counted(lambda: lin(torch.empty(7, 256))) == 2 * 7 * 256 * 1024


def test_deformable_attention_hand_count():
    B, Lq, S, M, L, P, D = 2, 300, 1900, 8, 1, 4, 32
    call = flops.MSDACall(B, Lq, S, M, L, P, D)
    points = B * Lq * M * L * P
    assert call.fwd_flops() == points * D * 10
    assert call.bwd_flops() == points * D * 18
    # value and output in bf16, locations in f32, weights in bf16
    assert call.fwd_bytes() == (B * S * M * D * 2 + points * 8 + points * 2
                                + B * Lq * M * D * 2)
    bound = flops.msda_fwd_bound_s([call])
    assert bound == max(call.fwd_bytes() / 3.35e12,
                        call.fwd_flops() / 67e12)


def test_model_count_adds_the_sampling():
    cfg = dict(tiny.TINY_MODEL)
    file = spec.load_json(
        f"{spec.PERFBENCH}/configs/latefusion_r50_dformer.json")
    base = file["config"]
    base.update(cfg)
    got = flops.count(base, 2, 64, 96, spec.reference(file))
    with torch.device("meta"):
        m = ref_model.build(base)
        x = torch.empty(2, 64, 96, 4)
        mask = torch.zeros(2, 64, 96, dtype=torch.bool)
    dense = counted(lambda: m(x, mask))
    # one depth layer, the encoder and the decoder each call MSDA once a
    # layer; 64x96 frames give 4x6 maps at stride 16
    layers = 1 + cfg["enc_layers"] + cfg["dec_layers"]
    assert len(got["msda"]) == layers
    hand = sum(2 * q * 8 * 1 * 4 * (cfg["hidden_dim"] // 8) * 10
               for q in [24] * (1 + cfg["enc_layers"])
               + [cfg["num_queries"]] * cfg["dec_layers"])
    assert got["flops"] == dense + hand





# (config, mix, train): model FLOPs a call, RoIAlign's FLOPs, MSDA calls,
# K1's and K2's bounds in seconds, as the counts read before a
# configuration could name its reference
EXISTING = [
    (("latefusion_r50_dformer", "serve.b32", False),
     (4672028672000.0, 0.0, 13, 0.00024080811940298507,
      0.0004077659701492537)),
    (("transvodpp_latefusion_r50_dformer", "serve.c8x5", False),
     (6225482465280.0, 4816896000.0, 16, 0.0003097676417910448,
      0.0005261220298507463)),
    (("latefusion_r50_dformer", "train.b32", True),
     (6249008332800.0, 0.0, 13, 0.00024080811940298507,
      0.0004077659701492537))]


@pytest.mark.parametrize("cell,want", EXISTING)
def test_existing_counts_are_unchanged(cell, want):
    config, mix, train = cell
    cfg = spec.load_json(f"{spec.PERFBENCH}/configs/{config}.json")
    t = spec.load_json(f"{spec.PERFBENCH}/traffic/{mix}.json")
    got = flops.count(cfg["config"], t["frames_per_request"], t["height"],
                      t["width"], spec.reference(cfg), train=train)
    assert (got["flops"], got["roi_flops"], len(got["msda"]),
            flops.msda_fwd_bound_s(got["msda"]),
            flops.msda_bwd_bound_s(got["msda"])) == want
