"""The port's on-device matcher against the JAX package's: the plain LAPJV
(``dfvod_tpu_torch/ops/lapjv.py::lapjv_plain``) against
``dfvod_tpu/models/matcher.py::hungarian_lapjv`` in every slot, invalid
slots included, and its total cost against scipy's optimum; the backends
of ``match_layers`` and ``SetCriterion``; the wrapper's refusals.

Costs are f32 made with numpy from a seed. Each case is one JAX shape, so
one compile; the JAX results are shared between the tests of a case. The
kernel ``csrc/lapjv.cu`` against ``lapjv_plain`` is in
``tests/test_torch_cuda.py`` (it needs the card).
"""
import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from dfvod_tpu.models import criterion as j_criterion
from dfvod_tpu.models.matcher import hungarian_lapjv as j_hungarian_lapjv
from dfvod_tpu_torch.models.criterion import SetCriterion
from dfvod_tpu_torch.models.matcher import (
    hungarian_lapjv,
    match_layers,
    matching_cost,
    solve,
)
from dfvod_tpu_torch.ops.lapjv import lapjv, lapjv_plain
from dfvod_tpu_torch.utils.config import LossConfig

# name: (B, Q, T, cost kind, valid slots). "scattered": an image without
# targets (row 0) and one with a single valid target (row 1), the others'
# valid slots scattered among invalid ones; "path": the train paths' 64
# slots, 1-20 valid first in each row, as the loader pads them; "all":
# every slot valid (more valid rows than the kernel's shared memory holds
# at the largest proposal count)
CASES = {
    "scattered": (4, 30, 10, "normal", "scattered"),
    "integer_ties": (4, 30, 10, "integer", "scattered"),
    "q_equals_t": (3, 8, 8, "normal", "scattered"),
    "q_equals_t_ties": (3, 8, 8, "integer", "scattered"),
    "s1900": (2, 1900, 16, "normal", "scattered"),
    "path_t64": (2, 300, 64, "normal", "path"),
    "path_t64_ties": (2, 300, 64, "integer", "path"),
    "path_t64_all_valid": (2, 300, 64, "normal", "all"),
    "s1900_t64": (1, 1900, 64, "normal", "path"),
}


@functools.lru_cache(maxsize=None)
def case_inputs(name):
    B, Q, T, kind, slots = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    if kind == "integer":          # costs in {0, 1, 2}: many exact ties
        cost = rng.integers(0, 3, (B, Q, T)).astype(np.float32)
    else:
        cost = rng.standard_normal((B, Q, T)).astype(np.float32)
    if slots == "path":
        valid = np.arange(T)[None] < rng.integers(1, 21, (B, 1))
        return cost, valid
    if slots == "all":
        return cost, np.ones((B, T), bool)
    valid = rng.random((B, T)) < 0.6
    valid[0] = False
    valid[1] = False
    valid[1, rng.integers(T)] = True
    return cost, valid


@functools.lru_cache(maxsize=None)
def jax_assignment(name):
    cost, valid = case_inputs(name)
    return np.asarray(j_hungarian_lapjv(jnp.asarray(cost),
                                        jnp.asarray(valid)))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_equals_jax_in_every_slot(name):
    cost, valid = case_inputs(name)
    got = lapjv_plain(torch.from_numpy(cost), torch.from_numpy(valid))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), jax_assignment(name))
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        lapjv(torch.from_numpy(cost), torch.from_numpy(valid)).numpy(),
        jax_assignment(name))


@pytest.mark.parametrize("name", list(CASES))
def test_total_cost_equals_scipy_optimum(name):
    """A matching (no query twice, invalid rows included) whose valid
    slots cost scipy's optimum, within f32 rounding: the sums are taken
    in f64 over the f32 entries, 1e-5 of the sum of absolute entries."""
    cost, valid = case_inputs(name)
    got = lapjv_plain(torch.from_numpy(cost),
                      torch.from_numpy(valid)).numpy()
    ref = solve(cost, valid)
    for b in range(cost.shape[0]):
        assert len(set(got[b])) == cost.shape[2]
        cols = np.flatnonzero(valid[b])
        mine = cost[b, got[b, cols], cols].astype(np.float64)
        opt = cost[b, ref[b, cols], cols].astype(np.float64)
        assert abs(mine.sum() - opt.sum()) <= 1e-5 * (np.abs(opt).sum() + 1)


def layer_outputs(seed, B=2, T=8):
    """A final and an aux layer of 12 queries, an encoder of 40 proposals,
    and targets with scattered valid slots and an image of one target."""
    rng = np.random.default_rng(seed)

    def layer(Q):
        cxcy = rng.uniform(0.1, 0.9, (B, Q, 2))
        wh = rng.uniform(0.02, 0.5, (B, Q, 2))
        return {"pred_logits": torch.from_numpy(
                    rng.standard_normal((B, Q, 3)).astype(np.float32)),
                "pred_boxes": torch.from_numpy(np.concatenate(
                    [cxcy, wh], -1).astype(np.float32))}
    valid = np.zeros((B, T), bool)
    valid[0, rng.choice(T, 5, replace=False)] = True
    valid[1, 3] = True
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, T, 2)),
                            rng.uniform(0.05, 0.35, (B, T, 2))], -1)
    targets = {"labels": torch.from_numpy(
                   rng.integers(0, 2, (B, T)).astype(np.int32)),
               "boxes": torch.from_numpy(boxes.astype(np.float32)),
               "valid": torch.from_numpy(valid)}
    return [layer(12), layer(12), layer(40)], targets


def test_match_layers_default_is_lapjv_and_never_calls_scipy(monkeypatch):
    """The default backend gives, per layer, JAX's ``hungarian_lapjv`` of
    the port's costs in every slot (the two 12-query layers in one stacked
    problem set, the 40 proposals in another), without scipy; the scipy
    backend gives ``solve``'s assignment, 0 in invalid slots, equal to the
    default's in the valid ones."""
    outs, tg = layer_outputs(0)
    binary = [False, False, True]
    cfg = LossConfig()

    def refuse(*a, **k):
        raise AssertionError("linear_sum_assignment called")
    with monkeypatch.context() as m:
        m.setattr(scipy.optimize, "linear_sum_assignment", refuse)
        got = match_layers(outs, tg, cfg, binary=binary)
        assert torch.equal(got, match_layers(outs, tg, cfg, binary=binary,
                                             backend="lapjv"))
    assert got.shape == (3, 2, 8) and got.dtype == torch.int64
    valid = tg["valid"].numpy()
    host = match_layers(outs, tg, cfg, binary=binary, backend="scipy")
    for k, (o, is_bin) in enumerate(zip(outs, binary)):
        labels = torch.zeros_like(tg["labels"]) if is_bin else tg["labels"]
        c = matching_cost(o["pred_logits"], o["pred_boxes"], labels,
                          tg["boxes"], tg["valid"], cfg.set_cost_class,
                          cfg.set_cost_bbox, cfg.set_cost_giou).numpy()
        np.testing.assert_array_equal(
            got[k].numpy(),
            np.asarray(j_hungarian_lapjv(jnp.asarray(c),
                                         jnp.asarray(valid))))
        np.testing.assert_array_equal(host[k].numpy(), solve(c, valid))
    np.testing.assert_array_equal(got.numpy()[:, valid],
                                  host.numpy()[:, valid])
    with pytest.raises(ValueError, match="backend"):
        match_layers(outs, tg, cfg, backend="hungarian")


def test_scipy_backend_survives_nan_costs():
    """``test_nan_costs_do_not_hang`` on the host oracle: a diverged step's
    NaN / inf outputs, sanitized, still give a matching."""
    outs, tg = layer_outputs(1)
    outs[0]["pred_logits"][0, :4] = float("nan")
    outs[0]["pred_boxes"][1] = float("inf")
    for backend in ("scipy", "auto"):
        a = match_layers(outs[:1], tg, LossConfig(), backend=backend)
        assert bool(((a >= 0) & (a < 12)).all()), backend


@pytest.mark.parametrize("K", [3, 5], ids=["modified_focal", "focal"])
def test_criterion_backends_agree(K):
    """``SetCriterion(..., matcher_backend="scipy")`` gives the default's
    losses exactly: the valid slots' assignments are equal, and only they
    enter the losses."""
    outs, tg = layer_outputs(2)
    for o in outs:
        o["pred_logits"] = torch.randn(*o["pred_logits"].shape[:2], K,
                                       generator=torch.Generator()
                                       .manual_seed(K))
    out = {**outs[0], "aux_outputs": [outs[1]], "enc_outputs": outs[2]}
    _, parts = SetCriterion(K, LossConfig(), dec_layers=2)(out, tg)
    _, ref = SetCriterion(K, LossConfig(), "scipy", dec_layers=2)(out, tg)
    assert set(parts) == set(ref)
    for k in parts:
        assert torch.equal(parts[k], ref[k]), k


def test_set_criterion_signature_equals_jax():
    def params(cls):
        return [(p.name, p.kind, p.default) for p in
                inspect.signature(cls.__init__).parameters.values()]
    assert params(SetCriterion) == params(j_criterion.SetCriterion)
    assert SetCriterion(3, LossConfig()).matcher_backend == "auto"


def test_wrapper_refusals():
    cost = torch.zeros((2, 4, 5))
    valid = torch.ones((2, 5), dtype=torch.bool)
    with pytest.raises(ValueError, match="T <= Q"):
        lapjv(cost, valid)
    with pytest.raises(ValueError, match="T <= Q"):
        hungarian_lapjv(cost, valid)
    meta = torch.zeros((2, 5, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        lapjv(meta, torch.ones((2, 4), dtype=torch.bool, device="meta"))
    with pytest.raises(TypeError, match="bool"):
        lapjv(torch.zeros((2, 5, 4)), torch.ones((2, 4)))
    with pytest.raises(ValueError, match=r"\(P, Q, T\)"):
        lapjv(torch.zeros((2, 5, 4)), torch.ones((2, 5), dtype=torch.bool))
    assert lapjv(torch.zeros((0, 5, 4)),
                 torch.ones((0, 4), dtype=torch.bool)).shape == (0, 4)
