"""The data-parallel loop at a tiny size on the CPU: two ranks (gloo), the
second a process of its own, as the port's CLI spawns them. The program
passes its check; its float32 path agrees with the reference's
``DataParallelStep`` to rounding (a second witness that the reference
follows the ranks' step); and every fault that the cell can have comes
out not correct: a rank that keeps its own gradient (the exchange left
out), the BatchNorms' statistics taken per rank, rank 1 on rank 0's
rows, half of each rank's rows left out, a state left unchanged."""
import pytest
import torch

from perfbench.harness import cell, faults, spec
from perfbench.tests import tiny

SEED = 2 ** 31 + 12345
NAME = "tiny.train_ddp"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def run(c, **kw):
    torch.manual_seed(0)
    return cell.run(c, SEED, 0.3, False, device="cpu", **kw)


def test_the_program_passes(root):
    c = spec.Cell(NAME, root=root)
    assert c.kind == "train" and c.chips == 2
    r = run(c)
    assert r["correct"], r["checks"]
    assert r["checks"]["ranks_state_mismatch"]["value"] == 0


def test_f32_program_follows_the_reference(root):
    c = spec.Cell(NAME, root=root)
    c.config["config"]["train_dtype"] = "float32"
    r = run(c)
    got = {k: v["value"] for k, v in r["checks"].items()}
    assert got["ranks_state_mismatch"] == 0
    assert got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-3
    assert got["grad_median_gap"] < 1e-4
    assert got["change_gap"] < 1e-2


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["train_ddp"]))
def test_faults_fail(root, fault):
    r = run(spec.Cell(NAME, root=root),
            faults=faults.FAULTS["train_ddp"][fault])
    assert not r["correct"], r["checks"]
