"""One rank of the port's 2-process data-parallel checks on the CPU
(started by ``tests/test_torch_parallel.py``; not collected by pytest).

    python tests/torch_parallel_worker.py RANK WORLD INIT_FILE INPUTS OUT_DIR

The ranks meet through ``file://INIT_FILE`` in a gloo group whose
rendezvous and collectives time out after ``GROUP_TIMEOUT_S``. From the
pickled ``INPUTS`` (flax variables as numpy, numpy batches, a COCO
dataset dict) each rank runs, in one group:

1. the helpers: ``reduce_mean``, ``all_gather_rows`` (f32 and bf16),
   ``make_groups`` for clip 1 and 2, a single-frame ``Server`` given the
   group;
2. the single-frame step (LateFusion, DFormer BNs synchronised): its rows
   of the batch through ``create_train_state`` (DDP) + ``train_step``;
3. the TransVOD++ step, one clip per rank;
4. the evaluation merge: ``evaluate`` over its shard of the images
   (``shard_indices``, wrapped), with an oracle and a noisy detector; the
   detections each rank held before the merge are kept too;
5. clip-parallel serving: ``Server(group=...)`` on a clip whose frames
   straddle the ranks, with the rows each rank's trunk ran;
6. ``save_checkpoint`` from both ranks, with the ``torch.save`` calls
   each rank made;
7. auto-resume with dropout 0.1: two single-frame steps in a row, against
   one step, ``save_checkpoint``, a fresh state from another seed,
   ``load_checkpoint(weights_only=False)`` and one step: the parameters
   and the next draw of each rank's dropout generator;
8. clip-parallel TransVOD++ training, the trunk trained: both ranks one
   clip group (``create_train_state(clip=2)``), each passing the whole
   4-frame clip, its trunk running 2 frames; then a step with dropout 0.1,
   with each rank's own loss and temporal outputs.

It writes ``OUT_DIR/rank{RANK}.pt`` and prints ``TORCH_PARALLEL_OK``.
"""
import copy
import os
import pickle
import sys

import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from dfvod_tpu_torch import parallel  # noqa: E402
from dfvod_tpu_torch.data import coco_eval  # noqa: E402
from dfvod_tpu_torch.data.coco import COCO  # noqa: E402
from dfvod_tpu_torch.data.loader import shard_indices  # noqa: E402
from dfvod_tpu_torch.models import build_model  # noqa: E402
from dfvod_tpu_torch.serve import Server  # noqa: E402
from dfvod_tpu_torch.train.engine import (  # noqa: E402
    create_train_state,
    train_step,
)
from dfvod_tpu_torch.train.evaluate import evaluate  # noqa: E402
from dfvod_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from dfvod_tpu_torch.utils.config import (  # noqa: E402
    Config,
    ModelConfig,
    TrainConfig,
)
from dfvod_tpu_torch.utils.convert import load_jax_variables  # noqa: E402

GROUP_TIMEOUT_S = 60


def helpers(rank, world):
    """What the helpers give on this rank."""
    out = {"reduce_mean": {k: float(v) for k, v in parallel.reduce_mean(
        {"a": torch.tensor(rank + 1.0), "b": torch.tensor(10.0 * rank)}
    ).items()}}
    rows = torch.full((2, 3), float(rank))
    out["gather_f32"] = parallel.all_gather_rows(rows)
    out["gather_bf16"] = parallel.all_gather_rows(
        (rows + 0.5).to(torch.bfloat16))
    for clip in (1, 2):
        cg, dg = parallel.make_groups(clip)
        out[f"groups_clip{clip}"] = (dist.get_process_group_ranks(cg),
                                     dist.get_process_group_ranks(dg))
    try:
        Server(Config(), device="cpu", group=dist.group.WORLD)
    except ValueError as e:
        out["single_frame_server"] = str(e)
    # the differentiable gather: each rank weighs the gathered rows with
    # its own weights, so the backward must sum both ranks' weights
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.full((2, 3), float(rank), dtype=dtype, requires_grad=True)
        y = parallel.gather_rows(x)
        w = torch.arange(12, dtype=dtype).reshape(4, 3) * (rank + 1)
        (y * w).sum().backward()
        out[f"gather_grad_{dtype}"] = (y.detach(), x.grad)
    out["reduce_scatter"] = parallel.reduce_scatter_rows(
        torch.arange(8.0).reshape(4, 2) * (rank + 1))
    return out


def train_case(case, rank, world):
    """One data-parallel step on this rank's rows of ``case["batch"]``."""
    cfg = Config(model=ModelConfig(**case["model"]),
                 train=TrainConfig(**case["train"]))
    model, criterion, _ = build_model(cfg, device="cpu")
    load_jax_variables(model, copy.deepcopy(case["variables"]))
    state = create_train_state(model, cfg, steps_per_epoch=1)
    batch = {k: parallel.shard_rows(v, rank, world)
             for k, v in case["batch"].items()}
    metrics = train_step(state, criterion, batch)
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "rows": int(batch["images"].shape[0]),
        "ddp": type(state.ddp).__name__,
        "find_unused": state.ddp.find_unused_parameters,
        "state": {k: v.detach().clone()
                  for k, v in model.state_dict().items()},
        # the averaged gradients, clipped
        "grads": {k: None if p.grad is None else p.grad.clone()
                  for k, p in model.named_parameters()},
    }


def clip_case(case, rank, world):
    """Clip-parallel training, the world one clip group: every rank
    passes its clip group's rows (here the whole clip). A step in f32 with
    dropout 0 as the case says, then one of dropout 0.1 on a fresh state,
    with this rank's loss before the ranks' mean and the temporal heads'
    outputs."""
    res = {}
    for dropout in (case["model"]["dropout"], 0.1):
        cfg = Config(model=ModelConfig(**dict(case["model"],
                                              dropout=dropout)),
                     train=TrainConfig(**case["train"]))
        model, criterion, _ = build_model(cfg, device="cpu")
        load_jax_variables(model, copy.deepcopy(case["variables"]))
        state = create_train_state(model, cfg, steps_per_epoch=1, clip=2)
        batch = {k: parallel.clip_group_rows(v, 2)
                 for k, v in case["batch"].items()}
        rows, seen = [], {}
        trunk = model.detr.forward

        def counting(images, mask):
            rows.append(int(images.shape[0]))
            return trunk(images, mask)

        model.detr.forward = counting

        def recording(out, targets):
            seen["out"] = {k: out[k].detach().clone()
                           for k in ("pred_logits", "pred_boxes")}
            loss, parts = criterion(out, targets)
            seen["loss"] = loss.detach().clone()
            return loss, parts

        metrics = train_step(state, recording, batch)
        res[dropout] = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "rows": int(batch["images"].shape[0]), "trunk_rows": rows,
            "clip_group": dist.get_process_group_ranks(model.trunk_group),
            "head_seed": state.head_seed, **seen,
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "grads": {k: None if p.grad is None else p.grad.clone()
                      for k, p in model.named_parameters()},
        }
    return res


def resume_case(case, rank, world, out_dir):
    """Dropout 0.1: two steps in a row against a step, a checkpoint, a
    fresh state from another seed restored from it and a step. Each
    returns the parameters and the next 64 draws of its generator."""
    cfg = Config(model=ModelConfig(**dict(case["model"], dropout=0.1)),
                 train=TrainConfig(**case["train"]))

    def state_for(seed):
        c = Config(model=cfg.model, train=TrainConfig(**dict(
            case["train"], seed=seed)))
        model, criterion, _ = build_model(c, device="cpu")
        load_jax_variables(model, copy.deepcopy(case["variables"]))
        return create_train_state(model, c, steps_per_epoch=2), criterion

    halves = [{k: parallel.shard_rows(v, rank, world)
               for k, v in b.items()} for b in case["resume_batches"]]

    def result(state):
        return {"params": {k: v.detach().clone() for k, v in
                           state.model.state_dict().items()},
                "draw": torch.rand(64, generator=state.generator),
                "step": state.step}

    state, criterion = state_for(42)
    for b in halves:
        train_step(state, criterion, b)
    unbroken = result(state)
    state, criterion = state_for(42)
    train_step(state, criterion, halves[0])
    path = os.path.join(out_dir, "resume")
    ckpt.save_checkpoint(path, state, 0)
    fresh, criterion = state_for(7)
    ckpt.load_checkpoint(path, fresh, weights_only=False)
    train_step(fresh, criterion, halves[1])
    return {"unbroken": unbroken, "resumed": result(fresh)}


def eval_case(case, rank, world):
    """``evaluate`` over this rank's shard, for the oracle and the noisy
    detector: the merged stats and the detections held before the merge."""
    from chip_smoke import OracleDetector, eval_batches, noisy_oracle
    coco = COCO(dataset=case["dataset"])
    ids = coco.getImgIds()
    shard = [ids[i] for i in shard_indices(len(ids), rank, world,
                                           shuffle=False, seed=0, epoch=0)]
    held = []
    merge = coco_eval.COCOEvaluator.synchronize_between_processes

    def recording_merge(ev):
        held.append((copy.deepcopy(ev.detections), sorted(ev._seen)))
        merge(ev)

    coco_eval.COCOEvaluator.synchronize_between_processes = recording_merge
    out = {"shard": shard}
    try:
        for name, det in (("oracle", OracleDetector(coco)),
                          ("noisy", noisy_oracle(coco))):
            batches = list(eval_batches(coco, img_ids=shard, batch=2,
                                        size=(64, 96), content=(60, 75)))
            stats = evaluate(det, batches, coco, print_freq=0)
            out[name] = {"stats": stats, "held": held.pop()}
    finally:
        coco_eval.COCOEvaluator.synchronize_between_processes = merge
    return out


def serve_case(case):
    """The clip-parallel forward of ``Server(group=WORLD)`` in f32 and the
    rows each call of this rank's trunk ran."""
    cfg = Config(model=ModelConfig(**case["model"]))
    server = Server(cfg, variables=copy.deepcopy(case["variables"]),
                    device="cpu", dtype=torch.float32,
                    group=dist.group.WORLD)
    rows = []
    trunk = server.model.detr.forward

    def counting(images, mask):
        rows.append(int(images.shape[0]))
        return trunk(images, mask)

    server.model.detr.forward = counting
    out = server.forward(case["images"], case["sizes"])
    dets = server(case["images"], case["sizes"])
    return {"rows": rows,
            "out": {k: out[k] for k in ("pred_logits", "pred_boxes")},
            "aux": [{k: a[k] for k in ("pred_logits", "pred_boxes")}
                    for a in out["aux_outputs"]],
            "single_frame": {k: out["_single_frame"][k]
                             for k in ("pred_logits", "pred_boxes")},
            "dets": dets}


def ckpt_case(case, out_dir):
    """``save_checkpoint`` of a DDP state from every rank; the files this
    rank's ``torch.save`` wrote."""
    cfg = Config(model=ModelConfig(**case["model"]),
                 train=TrainConfig(**case["train"]))
    model = build_model(cfg, device="cpu")[0]
    load_jax_variables(model, copy.deepcopy(case["variables"]))
    state = create_train_state(model, cfg, steps_per_epoch=1)
    saves = []
    save = torch.save

    def recording_save(obj, f, *a, **kw):
        saves.append(os.path.basename(str(f)))
        return save(obj, f, *a, **kw)

    torch.save = recording_save
    try:
        path = ckpt.save_checkpoint(os.path.join(out_dir, "ckpt"), state, 0)
        exists = os.path.exists(path)     # after the barrier, every rank
    finally:
        torch.save = save
    return {"saves": saves, "exists": exists}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, inputs, out_dir = sys.argv[3:6]
    torch.set_num_threads(2)
    parallel.init_distributed(rank, world, init_method="file://" + init_file,
                              device="cpu", timeout_s=GROUP_TIMEOUT_S)
    assert dist.get_backend() == "gloo"
    with open(inputs, "rb") as f:
        cases = pickle.load(f)
    res = {"helpers": helpers(rank, world),
           "single_frame": train_case(cases["single_frame"], rank, world),
           "video": train_case(cases["video"], rank, world),
           "eval": eval_case(cases["eval"], rank, world),
           "serve": serve_case(cases["serve"]),
           "ckpt": ckpt_case(cases["single_frame"], out_dir),
           "resume": resume_case(cases["single_frame"], rank, world,
                                 out_dir),
           "clip": clip_case(cases["video_clip"], rank, world)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    print("TORCH_PARALLEL_OK", flush=True)


if __name__ == "__main__":
    main()
