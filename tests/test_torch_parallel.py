"""The port's data parallelism and clip-parallel serving on the CPU: two
gloo processes (``tests/torch_parallel_worker.py``, spawned once for the
module) against the JAX package's one program over the global batch, run
once here on one device through its own entry points (its CPU path takes
the XLA reference, never Pallas), and against the port's own one-process
runs.

Small sizes (hidden 32, 4 heads, 1+1 layers, 64x96 uint8 frames, random
flax variables carried into the port by ``utils/convert.py``), f32,
dropout 0. Tolerances: atol 1e-4 / rtol 1e-3, the JAX package's
full-model torch-parity tolerance, unless a test says otherwise. Each
rank has its own time limit (``WORKER_TIMEOUT_S``), and the group's
rendezvous and collectives time out after the worker's
``GROUP_TIMEOUT_S``, so that a rank that hangs fails the module in
seconds.

Checked: ``shard_indices`` against JAX's; a 2-rank LateFusion + DFormer
step (the BN statistics synchronised) against ``make_train_step`` on the
whole batch and against the port's one-process step; a 2-rank TransVOD++
step, a clip per rank, against ``make_train_step(frames=F)`` with the
video tolerances; the evaluation merge over 5 images (an odd count) equal
to one process, and the JAX merge's double count of the wrapped image;
clip-parallel serving of a clip straddling the ranks against the JAX
forward; a checkpoint written by 2 ranks loading into one process; the
helpers and the ``('clip', 'data')`` layout of ``make_mesh``; the
differentiable gather's backward; an auto-resume with dropout on each
rank's own dropout state; clip-parallel TransVOD++ training with the trunk
trained, the 2 ranks one clip group, against the port's one-process step
and ``make_train_step(frames=4)``; the clip-parallel row and group
arithmetic for (C, D) = (2, 2) and (4, 1) without a process.
"""
import copy
import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfvod_tpu.data import coco_eval as j_coco_eval
from dfvod_tpu.data.coco import COCO as JCOCO
from dfvod_tpu.data.device_pipeline import device_normalize as j_normalize
from dfvod_tpu.data.loader import shard_indices as j_shard_indices
from dfvod_tpu.models import build_model as j_build_model
from dfvod_tpu.parallel import make_mesh
from dfvod_tpu.train.engine import TrainState as JTrainState
from dfvod_tpu.train.engine import make_train_step
from dfvod_tpu.train.optim import build_optimizer as j_build_optimizer
from dfvod_tpu.utils.config import Config as JConfig
from dfvod_tpu.utils.config import ModelConfig as JModelConfig
from dfvod_tpu.utils.config import TrainConfig as JTrainConfig
from dfvod_tpu_torch import parallel
from dfvod_tpu_torch.data import coco_eval
from dfvod_tpu_torch.data.coco import COCO
from dfvod_tpu_torch.data.loader import shard_indices
from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.train.engine import (
    create_train_state,
    train_step,
    unused_parameters_expected,
)
from dfvod_tpu_torch.train.evaluate import evaluate
from dfvod_tpu_torch.utils.checkpoint import load_checkpoint, merge_matching
from dfvod_tpu_torch.utils.config import Config, ModelConfig, TrainConfig
from dfvod_tpu_torch.utils.convert import load_jax_variables, port_key
from torch_port_helpers import assert_close, flat_params, random_variables

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

WORKER = os.path.join(HERE, "torch_parallel_worker.py")
WORKER_TIMEOUT_S = 300
KEY = jax.random.PRNGKey(0)
TOL = dict(atol=1e-4, rtol=1e-3)
# the video step's gates (tests/test_torch_temporal_train.py)
GRAD_L2, UPDATE_L2 = 1.5e-2, 3e-2
TRAIN = dict(lr=1e-5, weight_decay=2e-5, clip_max_norm=0.1, epochs=3)
SMALL = dict(num_classes=3, hidden_dim=32, nheads=4, enc_layers=1,
             dec_layers=1, dim_feedforward=64, dropout=0.0,
             num_feature_levels=1, fusion_type="LateFusion")
SINGLE = dict(SMALL, num_queries=12, depth_backbone_type="dformer")
# TransVOD++ with the trunk fixed (its backward, which the single-frame
# step covers, would triple the JAX step's compile), 3 reference frames:
# trained a clip per rank, served one clip whose 4 frames straddle the
# ranks
VIDEO = dict(SMALL, num_queries=30, temporal_mode="transvod_pp",
             num_ref_frames=3, fixed_pretrained_model=True)
# clip-parallel training: the same model with the trunk trained (the
# recipe's default), one 4-frame clip over a clip group of both ranks
VIDEO_CLIP = dict(VIDEO, fixed_pretrained_model=False)
F_VIDEO = 4
EVAL_IMAGES = 5


def frames_and_targets(seed, n, H=64, W=96, T=6):
    """uint8 RGB-D frames (every second one keeps a 40 x 70 block, padded
    bottom/right) and targets on every row, 1..4 valid boxes each."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, H, W, 4), dtype=np.uint8)
    sizes = np.array([[H, W]] * n)
    sizes[1::2] = [40, 70]
    for i, (h, w) in enumerate(sizes):
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    valid = np.arange(T)[None] < rng.integers(1, 5, (n, 1))
    cxcy = rng.uniform(0.2, 0.8, (n, T, 2))
    wh = rng.uniform(0.05, 0.35, (n, T, 2))
    return {"images": imgs, "sizes": sizes,
            "labels": rng.integers(0, 2, (n, T)).astype(np.int32),
            "boxes": np.concatenate([cxcy, wh], -1).astype(np.float32),
            "valid": valid}


def flax_init(kw, batch, seed):
    model, criterion, _ = j_build_model(JConfig(model=JModelConfig(**kw)))
    x, mask = j_normalize(jnp.asarray(batch["images"]),
                          jnp.asarray(batch["sizes"]))
    variables = random_variables(
        lambda: model.init(KEY, x, mask, train=False), seed=seed)
    return model, criterion, dict(variables)


def eval_dataset():
    """The first ``EVAL_IMAGES`` images of val.json and their boxes."""
    coco = COCO(chip_smoke.VAL_JSON)
    ids = coco.getImgIds()[:EVAL_IMAGES]
    return {"images": [coco.imgs[i] for i in ids],
            "annotations": [a for i in ids for a in coco.imgToAnns[i]],
            "categories": list(coco.cats.values())}


@pytest.fixture(scope="module")
def cases():
    """The inputs both ranks read, and the flax models they came from."""
    sf_batch = frames_and_targets(0, 4)
    video_batch = frames_and_targets(1, 2 * F_VIDEO)
    out, models = {}, {}
    clip_batch = frames_and_targets(3, F_VIDEO)
    for name, kw, batch, seed in (("single_frame", SINGLE, sf_batch, 11),
                                  ("video", VIDEO, video_batch, 31),
                                  ("video_clip", VIDEO_CLIP, clip_batch, 41)):
        model, criterion, variables = flax_init(kw, batch, seed)
        models[name] = (model, criterion)
        out[name] = {"model": kw, "train": TRAIN, "variables": variables,
                     "batch": batch}
    out["single_frame"]["resume_batches"] = [frames_and_targets(5, 4),
                                             frames_and_targets(6, 4)]
    serve = frames_and_targets(2, F_VIDEO)
    out["serve"] = {"model": VIDEO, "variables": out["video"]["variables"],
                    "images": serve["images"], "sizes": serve["sizes"]}
    out["eval"] = {"dataset": eval_dataset()}
    return out, models


@pytest.fixture(scope="module")
def launch(cases, tmp_path_factory):
    """Both ranks started; they run while the JAX references compile."""
    tmp = tmp_path_factory.mktemp("parallel")
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(cases[0], f)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(tmp / "init"),
         str(tmp / "inputs.pkl"), str(tmp)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for r in range(2)]
    yield procs, tmp
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


@pytest.fixture(scope="module")
def ranks(launch, refs):
    """Each rank's results, after both exited 0 within their limit (the
    references are computed first, while the ranks run)."""
    procs, tmp = launch
    outs = []
    for r, p in enumerate(procs):
        try:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {r} still running after {WORKER_TIMEOUT_S} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "TORCH_PARALLEL_OK" in out, \
            f"rank {r} failed (rc {p.returncode}):\n{out[-6000:]}"
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)], tmp


def jax_step(cases, name, frames=1):
    """One ``make_train_step`` on the whole batch: (metrics, new params,
    new BN statistics, initial variables)."""
    inputs, models = cases
    model, criterion = models[name]
    case = inputs[name]
    variables = dict(case["variables"])
    params = variables.pop("params")
    jcfg = JConfig(model=JModelConfig(**case["model"]),
                   train=JTrainConfig(**TRAIN))
    tx, labels = j_build_optimizer(params, jcfg.model, jcfg.train,
                                   steps_per_epoch=1)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        model_state=variables, opt_state=tx.init(params))
    step = make_train_step(model, criterion, tx, donate=False, frames=frames,
                           labels=labels)
    state, m = step(state, jax.tree_util.tree_map(jnp.asarray,
                                                  case["batch"]), KEY)
    stats = {}
    for path, v in jax.tree_util.tree_flatten_with_path(
            state.model_state.get("batch_stats", {}))[0]:
        k, val = port_key("batch_stats", tuple(p.key for p in path),
                          np.asarray(v))
        stats[k] = val
    return ({k: float(v) for k, v in m.items()}, flat_params(state.params),
            stats, case["variables"])


def port_step(cases, name):
    """The port's one-process step on the whole batch: (metrics, state
    dict, clipped gradients)."""
    case = cases[0][name]
    cfg = Config(model=ModelConfig(**case["model"]),
                 train=TrainConfig(**TRAIN))
    model, criterion, _ = build_model(cfg, device="cpu")
    load_jax_variables(model, copy.deepcopy(case["variables"]))
    state = create_train_state(model, cfg, steps_per_epoch=1)
    assert state.ddp is None
    m = train_step(state, criterion, case["batch"])
    return ({k: float(v) for k, v in m.items()},
            {k: v.detach().clone() for k, v in model.state_dict().items()},
            {k: p.grad for k, p in model.named_parameters()})


def flax_serve(cases):
    """The JAX one-device forward of the served clip."""
    inputs, models = cases
    case = inputs["serve"]
    x, mask = j_normalize(jnp.asarray(case["images"]),
                          jnp.asarray(case["sizes"]))
    return jax.jit(lambda v, i, m: models["video"][0].apply(
        v, i, m, train=False))(case["variables"], x, mask)


@pytest.fixture(scope="module")
def refs(cases, launch):
    """The references, computed in threads while the ranks run (XLA
    compiles without the interpreter lock): the JAX step and the port's
    one-process step of each training case, and the JAX forward of the
    served clip."""
    with ThreadPoolExecutor(7) as pool:
        jobs = {"jax_single_frame": pool.submit(jax_step, cases,
                                                "single_frame"),
                "jax_video": pool.submit(jax_step, cases, "video",
                                         frames=F_VIDEO),
                "flax_serve": pool.submit(flax_serve, cases),
                "jax_video_clip": pool.submit(jax_step, cases,
                                              "video_clip", frames=F_VIDEO),
                "port_single_frame": pool.submit(port_step, cases,
                                                 "single_frame"),
                "port_video": pool.submit(port_step, cases, "video"),
                "port_video_clip": pool.submit(port_step, cases,
                                               "video_clip")}
        return {k: f.result() for k, f in jobs.items()}


# ------------------------------------------------------------ no process
@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered",
                                                        "shuffled"])
@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("n", [5, 6, 60])
def test_shard_indices_equal_jax(n, world, shuffle):
    """Each rank's contiguous shard of the order, padded by wrapping, as
    the JAX loader's; together they cover every index."""
    shards = [shard_indices(n, r, world, shuffle=shuffle, seed=3, epoch=2)
              for r in range(world)]
    for r, got in enumerate(shards):
        np.testing.assert_array_equal(got, j_shard_indices(
            n, r, world, shuffle=shuffle, seed=3, epoch=2))
    assert set(np.concatenate(shards)) == set(range(n))


def test_without_a_group_the_helpers_are_one_process():
    """No process group: rank 0 of 1, values back as they are, rows
    sharded by the same rule, a remainder refused as JAX refuses it."""
    assert not parallel.initialized()
    assert (parallel.rank(), parallel.world()) == (0, 1)
    assert parallel.is_main_process()
    v = {"loss": torch.tensor(2.0)}
    assert parallel.reduce_mean(v) is v
    x = torch.arange(12).reshape(6, 2)
    assert parallel.all_gather_rows(x) is x
    assert torch.equal(parallel.shard_rows(x, 1, 3), x[2:4])
    with pytest.raises(ValueError, match="should be divisible by 4"):
        parallel.shard_rows(x, 0, 4)
    parallel.barrier()


def test_devices_per_process(monkeypatch):
    """``--num_devices``: N CPU processes on the CPU; on the card one per
    card, 0 meaning all, more than are visible refused naming both."""
    assert parallel.local_devices(2, "cpu") == ["cpu", "cpu"]
    assert parallel.local_devices(0, "cpu") == ["cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert parallel.local_devices(0) == ["cuda:0", "cuda:1"]
    assert parallel.local_devices(1) == ["cuda:0"]
    with pytest.raises(ValueError, match="--num_devices 3: only 2 CUDA"):
        parallel.local_devices(3)
    with pytest.raises(ValueError, match="must be 0"):
        parallel.local_devices(-1, "cpu")


def test_a_group_that_cannot_form_raises(tmp_path):
    """One process of a world of two: the rendezvous times out and
    raises, and no group is left behind; nothing falls back to one
    process."""
    with pytest.raises(Exception, match="(?i)time"):
        parallel.init_distributed(0, 2, init_method=f"file://{tmp_path}/i",
                                  device="cpu", timeout_s=1)
    assert not parallel.initialized() and parallel.world() == 1


@pytest.mark.parametrize("kw", [
    dict(fusion_type="LateFusion"),
    dict(fusion_type="LateFusion", two_stage=True, with_box_refine=True),
    dict(fusion_type="LateFusion", temporal_mode="transvod_pp",
         num_ref_frames=1)],
    ids=["late", "two_stage", "transvod_pp"])
def test_unused_parameters_expected_where_a_step_leaves_some(kw):
    """DDP searches for parameters without a gradient exactly where a
    one-process step leaves a trainable one without: in the temporal
    models (the trunk's heads feed only a top-k)."""
    cfg = Config(model=ModelConfig(**dict(SMALL, num_queries=12, **kw)),
                 train=TrainConfig(**TRAIN))
    model, criterion, _ = build_model(cfg, device="cpu")
    state = create_train_state(model, cfg, steps_per_epoch=1)
    F = 1 + cfg.model.num_ref_frames if "temporal_mode" in kw else 1
    batch = frames_and_targets(4, 2 * F)
    train_step(state, criterion, batch)
    unused = [k for k, p in model.named_parameters()
              if p.requires_grad and p.grad is None]
    assert bool(unused) == unused_parameters_expected(cfg.model), unused


# --------------------------------------------------------------- 2 ranks
def test_helpers_over_two_ranks(ranks):
    """``reduce_mean`` averages, ``all_gather_rows`` concatenates in rank
    order (bf16 through gloo's host bytes too), and ``make_groups`` lays
    the ranks out as ``make_mesh`` lays out devices: (clip, world/clip),
    clip groups the columns, data groups the rows. A single-frame
    ``Server`` refuses a group: clip-parallel serving splits clips."""
    res, _ = ranks
    for r in range(2):
        h = res[r]["helpers"]
        assert "a single-frame model has none" in h["single_frame_server"]
        assert h["reduce_mean"] == {"a": 1.5, "b": 5.0}
        want = torch.tensor([0.0, 0.0, 1.0, 1.0])[:, None].expand(4, 3)
        assert torch.equal(h["gather_f32"], want)
        assert h["gather_bf16"].dtype == torch.bfloat16
        assert torch.equal(h["gather_bf16"].float(), want + 0.5)
        for clip in (1, 2):
            mesh = np.vectorize(lambda d: d.id)(
                make_mesh(jax.devices()[:2], clip=clip).devices)
            col, row = h[f"groups_clip{clip}"]
            c, d = divmod(r, 2 // clip)
            assert col == mesh[:, d].tolist() and row == mesh[c].tolist()


def test_two_rank_step_equals_jax_global_batch(ranks, refs):
    """A LateFusion + DFormer step on 2 ranks of 2 rows each equals the
    JAX package's one step over the 4 rows: loss, every component and
    grad_norm; every parameter; the DFormer BN running statistics, which
    need the global batch's statistics (one rank's alone miss them).
    Both ranks hold the same parameters and statistics, bitwise."""
    res, _ = ranks
    jm, jparams, jstats, _ = refs["jax_single_frame"]
    got = res[0]["single_frame"]
    assert got["rows"] == 2 and got["ddp"] == "DistributedDataParallel"
    assert got["find_unused"] is False
    assert set(got["metrics"]) == set(jm)
    for k in jm:
        np.testing.assert_allclose(got["metrics"][k], jm[k], **TOL,
                                   err_msg=k)
    for k, v in jparams.items():
        assert_close(got["state"][k], v, **TOL, err_msg=k)
    assert len(jstats) >= 8
    for k, v in jstats.items():
        assert_close(got["state"][k], v, **TOL, err_msg=k)
    other = res[1]["single_frame"]
    assert other["metrics"] == got["metrics"]
    for k, v in got["state"].items():
        assert torch.equal(v, other["state"][k]), k


def test_two_rank_step_equals_the_one_process_step(ranks, refs):
    """The 2-rank step against the port's one-process step on the same 4
    rows: metrics within 1e-6 relative, every clipped gradient within 1e-5
    of its tensor's largest entry plus 1e-9 (the halves summed in another
    order, and the global BN variance taken as E[x^2] - E[x]^2: measured
    1.4e-6 of the largest entry; the structurally zero gradients of the
    conv biases before a BN, about 1e-10, are rounding noise),
    and the parameters wherever Adam's step is decided (the clipped
    gradient above 1e-6, 100x Adam's epsilon) within atol 1e-7 / rtol
    1e-6, elsewhere within 2 lr; the BN statistics within 1e-6."""
    res, _ = ranks
    pm, pstate, pgrads = refs["port_single_frame"]
    got = res[0]["single_frame"]
    for k in pm:
        np.testing.assert_allclose(got["metrics"][k], pm[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    for k, g in pgrads.items():
        if g is None:
            assert got["grads"][k] is None, k
            continue
        scale = float(g.abs().max())
        assert_close(got["grads"][k], g.numpy(), 1e-5 * scale + 1e-9, 0,
                     err_msg=k)
        decided = (g.abs() > 1e-6).numpy()
        p, want = got["state"][k].numpy(), pstate[k].numpy()
        np.testing.assert_allclose(p[decided], want[decided], atol=1e-7,
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(p, want, atol=2 * TRAIN["lr"], rtol=0,
                                   err_msg=k)
    for k in pstate:
        if "running" in k:
            assert_close(got["state"][k], pstate[k].numpy(), 1e-6, 1e-6,
                         err_msg=k)


def rel_l2(got, want):
    return float(np.linalg.norm(got - want)
                 / max(float(np.linalg.norm(want)), 1e-30))


def test_two_rank_video_step_equals_jax(ranks, refs):
    """TransVOD++ (3 reference frames, the trunk fixed), one clip of 4
    frames per rank, against ``make_train_step(frames=4)`` on both clips:
    loss, components and grad_norm within atol 1e-4 / rtol 1e-3; each
    tensor's update over the entries whose Adam step is decided (the
    one-process clipped gradient above 1e-6) within relative L2 3e-2, and
    every gradient against the one-process step's within relative L2
    1.5e-2 (the video gates, ``tests/test_torch_temporal_train.py``); the
    frozen trunk bitwise unchanged, its DFormer BN statistics (global over
    both clips) within atol 1e-5 / rtol 1e-4 of flax's. A temporal step
    leaves trainable heads without a gradient, so DDP searches for unused
    parameters."""
    res, _ = ranks
    jm, jparams, jstats, init = refs["jax_video"]
    pgrads = refs["port_video"][2]
    got = res[0]["video"]
    assert got["rows"] == F_VIDEO and got["find_unused"] is True
    for k in jm:
        np.testing.assert_allclose(got["metrics"][k], jm[k], **TOL,
                                   err_msg=k)
    init = flat_params(init["params"])
    checked = 0
    for k, g in pgrads.items():
        if g is None:
            assert got["grads"][k] is None, k
            if k.startswith("detr."):
                np.testing.assert_array_equal(got["state"][k].numpy(),
                                              init[k], err_msg=k)
            continue
        rel = rel_l2(got["grads"][k].numpy(), g.numpy())
        assert rel <= GRAD_L2 or float(g.abs().max()) < 1e-4, (k, rel)
        decided = (g.abs() > 1e-6).numpy()
        if decided.any():
            rel = rel_l2((got["state"][k].numpy() - init[k])[decided],
                         (jparams[k] - init[k])[decided])
            assert rel <= UPDATE_L2, (k, rel)
            checked += 1
    assert checked > 50, checked
    assert jstats
    for k, v in jstats.items():
        assert_close(got["state"][k], v, 1e-5, 1e-4, err_msg=k)
    assert res[1]["video"]["metrics"] == got["metrics"]


def one_process_stats(detector, coco):
    return evaluate(detector, list(chip_smoke.eval_batches(
        coco, batch=2, size=(64, 96), content=(60, 75))), coco,
        print_freq=0)


def jax_stats(dets, seen, dataset):
    ev = j_coco_eval.COCOEvaluator(JCOCO(dataset=copy.deepcopy(dataset)))
    ev.detections, ev._seen = copy.deepcopy(dets), set(seen)
    return ev.summarize(verbose=False)


def test_evaluation_merge_over_an_odd_count_equals_one_process(ranks):
    """5 images over 2 ranks (rank 1's shard wraps to image 0): every
    rank's merged stats equal one process's ``evaluate`` exactly, which
    equal the JAX evaluator's over the same detections."""
    res, _ = ranks
    dataset = eval_dataset()
    coco = COCO(dataset=copy.deepcopy(dataset))
    ids = coco.getImgIds()
    assert res[1]["eval"]["shard"] == [ids[3], ids[4], ids[0]]
    want = one_process_stats(chip_smoke.noisy_oracle(coco), coco)
    assert 0.2 < want["mAP"] < 0.95
    for r in range(2):
        assert res[r]["eval"]["noisy"]["stats"] == want
    held = [res[r]["eval"]["noisy"]["held"][0] for r in range(2)]
    dets = held[0] + [d for d in held[1] if d["image_id"] != ids[0]]
    assert jax_stats(dets, ids, dataset) == want


def test_jax_merge_counts_a_wrapped_image_twice(ranks):
    """Perfect predictions (the oracle): the port's merge scores mAP 1.0,
    as one process does. The same detections merged as the JAX package
    merges them (``dfvod_tpu/data/coco_eval.py:152-158``: every rank's
    list concatenated) count image 0 twice and score 0.868 (ROADMAP
    Queue 3, known differences)."""
    res, _ = ranks
    for r in range(2):
        assert res[r]["eval"]["oracle"]["stats"]["mAP"] == 1.0
    held = [res[r]["eval"]["oracle"]["held"] for r in range(2)]
    dets = [d for part, _ in held for d in part]
    seen = set().union(*(s for _, s in held))
    jax_map = jax_stats(dets, seen, eval_dataset())["mAP"]
    assert round(jax_map, 3) == 0.868


def test_clip_parallel_serve_equals_the_jax_forward(ranks, refs):
    """One TransVOD++ clip of 4 frames over 2 ranks (2 frames each, the
    clip straddling them): every rank's key-frame outputs, the rounds'
    and the trunk's key frame, equal the JAX one-device forward; the
    ranks' detections are the same."""
    res, _ = ranks
    flax_serve = refs["flax_serve"]
    for r in range(2):
        got = res[r]["serve"]
        assert got["rows"] == [2, 2]      # Server.forward, then __call__
        pairs = [(got["out"], flax_serve),
                 (got["single_frame"], flax_serve["_single_frame"]),
                 *zip(got["aux"], flax_serve["aux_outputs"])]
        for o, ref in pairs:
            for k in ("pred_logits", "pred_boxes"):
                assert_close(o[k], np.asarray(ref[k]), **TOL, err_msg=k)
    for k, v in res[0]["serve"]["dets"].items():
        assert torch.equal(v, res[1]["serve"]["dets"][k]), k


def test_checkpoint_from_two_ranks_loads_into_one_process(ranks, cases):
    """``save_checkpoint`` called by both ranks of a DDP state: rank 0
    alone wrote, every rank found the file after the barrier, and its keys
    are the one-process model's, none missing or left over (no
    ``module.`` prefix)."""
    res, tmp = ranks
    assert res[0]["ckpt"]["saves"] == ["checkpoint0000.pth.tmp"]
    assert res[1]["ckpt"]["saves"] == []
    assert res[0]["ckpt"]["exists"] and res[1]["ckpt"]["exists"]
    model = build_model(Config(model=ModelConfig(**SINGLE)),
                        device="cpu")[0]
    saved = load_checkpoint(str(tmp / "ckpt"))[0]["model"]
    assert set(saved) == set(model.state_dict())
    merged, _ = merge_matching(model.state_dict(), saved)
    model.load_state_dict(merged)
    variables = cases[0]["single_frame"]["variables"]
    want = load_jax_variables(build_model(Config(model=ModelConfig(
        **SINGLE)), device="cpu")[0], copy.deepcopy(variables))
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


# ------------------------------------------------- clip-parallel training
@pytest.mark.parametrize("clip,world", [(2, 4), (4, 4)],
                         ids=["C2_D2", "C4_D1"])
def test_clip_layout_rows_and_groups(clip, world):
    """Rank r = c * D + d sits at (c, d) of ``make_mesh``'s (clip, data)
    layout; every rank of clip group d passes the same rows, group d's
    contiguous share of the global batch, which holds whole clips, and
    the groups' rows together are the batch in order."""
    D = world // clip
    mesh = np.arange(world).reshape(clip, D)
    x = torch.arange(8 * D).reshape(8 * D, 1)       # 2 clips of 4 per group
    per_group = {}
    for r in range(world):
        c, d = parallel.clip_layout(r, world, clip)
        assert mesh[c, d] == r
        rows = parallel.clip_group_rows(x, clip, r, world)
        assert torch.equal(rows, x[8 * d:8 * (d + 1)])
        per_group.setdefault(d, []).append(rows)
    assert len(per_group) == D
    for d, rows in per_group.items():
        assert len(rows) == clip
        assert all(torch.equal(r, rows[0]) for r in rows)
    assert torch.equal(torch.cat([per_group[d][0] for d in range(D)]), x)
    with pytest.raises(ValueError, match="not divisible by clip=3"):
        parallel.clip_layout(0, world, 3)


def test_clip_parallel_state_refuses_what_it_cannot_train():
    """A single-frame model has no clip to split, and without a process
    group there is no clip group: both raise."""
    for kw, msg in ((SINGLE, "single-frame model"),
                    (VIDEO_CLIP, "needs a process group")):
        cfg = Config(model=ModelConfig(**kw), train=TrainConfig(**TRAIN))
        model = build_model(cfg, device="cpu")[0]
        with pytest.raises(ValueError, match=msg):
            create_train_state(model, cfg, steps_per_epoch=1, clip=2)


def test_gather_rows_backward_sums_over_the_group(ranks):
    """``gather_rows`` forwards as ``all_gather_rows``; each rank weighs
    the 4 gathered rows with ``arange(12) * (rank + 1)``, so the gradient
    of a rank's 2 rows is its rows of ``arange(12) * 3`` (f32, and bf16
    through gloo's f32 sum). ``reduce_scatter_rows`` gives each rank its
    rows of the sum."""
    res, _ = ranks
    w = torch.arange(12.0).reshape(4, 3) * 3
    for r in range(2):
        h = res[r]["helpers"]
        for dtype in (torch.float32, torch.bfloat16):
            y, grad = h[f"gather_grad_{dtype}"]
            assert y.dtype == grad.dtype == dtype
            assert torch.equal(y.float(), torch.tensor(
                [0.0, 0.0, 1.0, 1.0])[:, None].expand(4, 3))
            assert torch.equal(grad.float(), w[2 * r:2 * r + 2])
        want = torch.arange(8.0).reshape(4, 2) * 3
        assert torch.equal(h["reduce_scatter"], want[2 * r:2 * r + 2])


def test_resume_restores_each_ranks_dropout_state(ranks):
    """Dropout 0.1 over 2 ranks: a step, ``save_checkpoint``, a fresh
    state from another seed, ``load_checkpoint(weights_only=False)`` and a
    step equal two steps in a row, bitwise on every rank: the parameters
    and the generator's next draws (each rank's own state comes back, not
    rank 0's)."""
    res, _ = ranks
    draws = []
    for r in range(2):
        got = res[r]["resume"]
        assert got["resumed"]["step"] == got["unbroken"]["step"] == 2
        assert torch.equal(got["resumed"]["draw"], got["unbroken"]["draw"])
        for k, v in got["unbroken"]["params"].items():
            assert torch.equal(got["resumed"]["params"][k], v), (r, k)
        draws.append(got["unbroken"]["draw"])
    assert not torch.equal(draws[0], draws[1])


def test_a_checkpoint_of_another_world_reseeds_dropout(ranks, capsys):
    """The 2 ranks' checkpoint holds both dropout states; one process
    loading it re-seeds from ``seed + 0``, as a run starts, and says so.
    The weights load all the same."""
    res, tmp = ranks
    saved = torch.load(tmp / "resume" / "checkpoint0000.pth",
                       weights_only=True)
    assert len(saved["generators"]) == 2
    assert torch.equal(saved["generators"][0], saved["generator"])
    cfg = Config(model=ModelConfig(**dict(SINGLE, dropout=0.1)),
                 train=TrainConfig(**dict(TRAIN, seed=9)))
    model = build_model(cfg, device="cpu")[0]
    state = create_train_state(model, cfg, steps_per_epoch=2)
    torch.rand(5, generator=state.generator)
    load_checkpoint(str(tmp / "resume"), state, weights_only=False)
    assert "dropout states of 2 processes, this run has 1" in \
        capsys.readouterr().out
    assert torch.equal(state.generator.get_state(),
                       torch.Generator().manual_seed(9).get_state())
    for k, v in saved["model"].items():
        assert torch.equal(model.state_dict()[k], v), k


def test_clip_parallel_step_equals_the_one_process_step(ranks, refs):
    """TransVOD++ with the trunk trained, one 4-frame clip, both ranks one
    clip group (each trunk 2 frames), against the port's one-process step
    on the clip: metrics within 1e-6 relative, every gradient within 1e-5
    of its tensor's largest entry plus 1e-9 (the trunk's gradients too,
    which come out half as large if the gather's backward does not sum
    over the group), the DFormer BN statistics (global over the clip's 4
    frames) within 1e-6; both ranks hold the same parameters. A parameter
    the one-process step leaves without a gradient (the trunk's last class
    head, read only through the top-k) is without one here too, or zero:
    DDP finds it reachable from the key frame's single-frame outputs,
    which now pass through the gather, and fills zeros."""
    res, _ = ranks
    pm, pstate, pgrads = refs["port_video_clip"]
    got = res[0]["clip"][0.0]
    assert got["rows"] == F_VIDEO and got["trunk_rows"] == [2]
    assert got["clip_group"] == [0, 1] and got["head_seed"] == 42
    for k in pm:
        np.testing.assert_allclose(got["metrics"][k], pm[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    trunk = 0
    for k, g in pgrads.items():
        if g is None:
            assert got["grads"][k] is None or not got["grads"][k].any(), k
            continue
        scale = float(g.abs().max())
        assert_close(got["grads"][k], g.numpy(), 1e-5 * scale + 1e-9, 0,
                     err_msg=k)
        trunk += k.startswith("detr.") and scale > 0
    assert trunk > 50, trunk
    running = [k for k in pstate if "running" in k]
    assert running
    for k in running:
        assert_close(got["state"][k], pstate[k].numpy(), 1e-6, 1e-6,
                     err_msg=k)
    for k, v in got["state"].items():
        assert torch.equal(v, res[1]["clip"][0.0]["state"][k]), k


def test_clip_parallel_step_equals_jax(ranks, refs):
    """The same step against ``make_train_step(frames=4)`` on the clip,
    the trunk trained: loss, components and grad_norm within atol 1e-4 /
    rtol 1e-3; each tensor's update over the entries whose Adam step is
    decided within relative L2 3e-2 (the video gates), the trunk's
    included; the BN statistics within atol 1e-5 / rtol 1e-4."""
    res, _ = ranks
    jm, jparams, jstats, init = refs["jax_video_clip"]
    pgrads = refs["port_video_clip"][2]
    got = res[0]["clip"][0.0]
    for k in jm:
        np.testing.assert_allclose(got["metrics"][k], jm[k], **TOL,
                                   err_msg=k)
    init = flat_params(init["params"])
    checked = trunk = 0
    for k, g in pgrads.items():
        if g is None:
            continue
        decided = (g.abs() > 1e-6).numpy()
        if decided.any():
            rel = rel_l2((got["state"][k].numpy() - init[k])[decided],
                         (jparams[k] - init[k])[decided])
            assert rel <= UPDATE_L2, (k, rel)
            checked += 1
            trunk += k.startswith("detr.")
    assert checked > 100 and trunk > 50, (checked, trunk)
    for k, v in jstats.items():
        assert_close(got["state"][k], v, 1e-5, 1e-4, err_msg=k)


def test_clip_parallel_dropout_is_one_model_on_the_clip_group(ranks):
    """Dropout 0.1: the temporal heads draw from ``seed + d``, the same
    masks on both ranks of the clip group, so each rank's own loss and
    temporal outputs are bitwise the other's, finite, and differ from the
    dropout-0 step's; the parameters stay equal."""
    res, _ = ranks
    a, b = res[0]["clip"][0.1], res[1]["clip"][0.1]
    assert torch.equal(a["loss"], b["loss"])
    assert torch.isfinite(a["loss"])
    assert a["metrics"] == b["metrics"]
    for k in ("pred_logits", "pred_boxes"):
        assert torch.equal(a["out"][k], b["out"][k]), k
    assert not torch.equal(a["out"]["pred_logits"],
                           res[0]["clip"][0.0]["out"]["pred_logits"])
    for k, v in a["state"].items():
        assert torch.equal(v, b["state"][k]), k
