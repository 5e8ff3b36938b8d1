"""The check at a tiny size on the CPU, with limits set for that size as
the cells' own are (``tiny.TINY_LIMITS``): the program passes; its lower-precision control (serving: the port's int8
path; training: the reference in fp8 in the program's place) and every
fault a cell can have (an answer altered where it is produced, half of the
batch left out, a step that leaves the state unchanged) come out not
correct. A run here skips only the harness's look for a card."""
import pytest
import torch

from perfbench.harness import cell, faults, inputs, lowprec, spec
from perfbench.loops import train
from perfbench.tests import tiny

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def run(root, name, **kw):
    torch.manual_seed(0)
    return cell.run(spec.Cell(name, root=root), SEED, 0.3, False,
                    device="cpu", **kw)


@pytest.mark.parametrize("name", ["tiny.serve", "tiny.clips", "tiny.train"])
def test_the_program_passes(root, name):
    r = run(root, name)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name", ["tiny.serve", "tiny.clips"])
def test_int8_control_fails(root, name):
    from dfvod_tpu_torch.ops import quant
    with quant.int8_mode():
        r = run(root, name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", ["tiny.serve", "tiny.clips"])
def test_fp8_reference_fails_serving(root, name):
    from perfbench import control
    c = spec.Cell(name, root=root)
    _, correct = cell.judge(control.serve_fp8_control(c, SEED, "cpu"),
                            cell.limits_of(c))
    assert not correct


def test_fp8_control_fails(root):
    c = spec.Cell("tiny.train", root=root)
    pool = inputs.pool(c.traffic, SEED, "cpu", c.kind)
    n = c.traffic["check_steps"]
    args = (c.config, SEED, pool, n, "cpu", c.reference)
    low = train.reference_steps(*args, lowprec=lowprec.fp8)
    ref = train.reference_steps(*args)
    emu = train.reference_steps(*args, lowprec=lowprec.bf16)
    _, correct = cell.judge(train.ratios(low, emu, ref, c.reference),
                            cell.limits_of(c))
    assert not correct


@pytest.mark.parametrize("name,loop,fault", [
    ("tiny.serve", "serve", "altered_answer"),
    ("tiny.serve", "serve", "half_batch"),
    ("tiny.serve", "serve", "decoder_layer_dropped"),
    ("tiny.clips", "serve", "altered_answer"),
    ("tiny.clips", "serve", "half_batch"),
    ("tiny.clips", "serve", "decoder_layer_dropped"),
    ("tiny.clips", "serve", "temporal_skipped"),
    ("tiny.train", "train", "half_batch"),
    ("tiny.train", "train", "unchanged")])
def test_faults_fail(root, name, loop, fault):
    r = run(root, name, faults=faults.FAULTS[loop][fault])
    assert not r["correct"], r["checks"]
