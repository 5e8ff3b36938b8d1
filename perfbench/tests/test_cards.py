"""Readings know how many cards a cell has: a whole call's share of the
peak (``mfu.*``) is over the cell's cards' peaks, and a kernel's roofline
(``msda_*_roofline.*``), read on one card, is against that card's share
of the call's bound. A one-card cell reads what it read before."""
import types

import pytest

from perfbench.harness import flops, spec

CALL = flops.MSDACall(32, 1900, 1900, 8, 1, 4, 32)


def ctx(chips):
    profile = types.SimpleNamespace(calls=3, kernel_us=lambda pred: 900.0)
    return types.SimpleNamespace(
        chips=chips, frames_per_s=600.0, key_frames_per_call=128,
        peaks=flops.PEAKS, profile=profile,
        counts={"flops": 2.5e13, "msda": [CALL] * 13})


@pytest.mark.parametrize("name", ["mfu.serve", "mfu.train",
                                  "msda_fwd_roofline.serve",
                                  "msda_bwd_roofline.train"])
def test_four_cards_read_a_quarter(name):
    read = spec.metric_reader(name)
    one, four = read(ctx(1)), read(ctx(4))
    assert one > 0
    assert four == pytest.approx(one / 4, rel=1e-12)


def test_one_card_reads_as_before():
    c = ctx(1)
    per_s = c.frames_per_s / c.key_frames_per_call
    assert spec.metric_reader("mfu.train")(c) == \
        100.0 * c.counts["flops"] * per_s / c.peaks["bf16_flops"]
    bound = flops.msda_bwd_bound_s(c.counts["msda"])
    assert spec.metric_reader("msda_bwd_roofline.train")(c) == \
        100.0 * bound / (900.0 * 1e-6 / 3)
