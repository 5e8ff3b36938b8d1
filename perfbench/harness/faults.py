"""Faults planted underneath the timed path, for the checks' own tests
and for reading each fault's numbers at a cell's size. Each takes the
program as ``cell.run`` builds it and breaks it in place. A loop of ranks
plants a rank fault (``RANK_FAULTS``) on the ranks that it names, each in
its own process."""
from __future__ import annotations

import torch


def serve_altered_answer(prog):
    """One detection's box moved by 8 pixels where it is produced."""
    post = prog.server.postprocess

    def altered(*args, **kwargs):
        out = post(*args, **kwargs)
        out["boxes"][0, 0] += 8.0
        return out
    prog.server.postprocess = altered


def serve_half_batch(prog):
    """The model runs on the first half of the request's clips and hands
    their outputs to the rest."""
    forward = prog.model.forward

    def half(images, mask):
        F = prog.frames
        n = images.shape[0] // F
        k = max(n // 2, 1) * F
        out = forward(images[:k], mask[:k])
        rep = -(-n // (k // F))

        def fill(x):
            if torch.is_tensor(x) and x.dim() and x.shape[0] == k // F:
                return x.repeat(rep, *[1] * (x.dim() - 1))[:n]
            if isinstance(x, dict):
                return {a: fill(b) for a, b in x.items()}
            if isinstance(x, list):
                return [fill(b) for b in x]
            return x
        return fill(out)
    prog.model.forward = half


def serve_decoder_layer_dropped(prog):
    """The trunk's middle decoder layer hands its input on unchanged."""
    detr = prog.model.detr if hasattr(prog.model, "detr") else prog.model
    t = detr.transformer
    layer = getattr(t, f"decoder_layers_{t.num_decoder_layers // 2}")
    layer.forward = lambda tgt, *a, **k: tgt


def serve_temporal_skipped(prog):
    """The answer is the trunk's key-frame outputs: the temporal head's
    rounds are left out (clips only)."""
    forward = prog.model.forward

    def skipped(images, mask):
        out = forward(images, mask)
        return {**out, **out["_single_frame"]}
    prog.model.forward = skipped


def train_half_batch(prog):
    """Every step sees the first half of its rows; the loss is the mean
    over them."""
    call = prog.__class__.__call__

    def half(self, batch):
        n = batch["images"].shape[0] // 2
        return call(self, {k: v[:n] for k, v in batch.items()})
    prog.__class__ = type("HalfBatch", (prog.__class__,),
                          {"__call__": half})


def train_unchanged(prog):
    """The optimizer's step leaves the parameters as they are."""
    prog.state.optimizer.step = lambda *a, **k: None


def rank_keeps_own_gradient(rank):
    """The rank sends its share to the gradient all-reduce but steps on
    its own gradient: its exchange is left out."""
    import torch.distributed as dist
    world = dist.get_world_size()

    def hook(state, bucket):
        own = bucket.buffer().clone()
        fut = dist.all_reduce(bucket.buffer().div_(world),
                              async_op=True).get_future()
        return fut.then(lambda f: own)
    rank.state.ddp.register_comm_hook(None, hook)


def rank_local_batch_stats(rank):
    """The DFormer BatchNorms take the statistics of the rank's own rows,
    not the global batch's."""
    from dfvod_tpu_torch.models.backbone_dformer import set_batchnorm_group
    set_batchnorm_group(rank.model, None)


def rank_rows_of_rank0(rank):
    """The rank steps on rank 0's rows of each global batch."""
    rank.rows_of = 0


def rank_half_rows(rank):
    """The rank steps on the first half of its rows; the loss is the mean
    over them."""
    rank.half = True


RANK_FAULTS = {"keeps_own_gradient": rank_keeps_own_gradient,
               "local_batch_stats": rank_local_batch_stats,
               "rows_of_rank0": rank_rows_of_rank0,
               "half_rows": rank_half_rows,
               "unchanged": train_unchanged}


def on_ranks(name, ranks=None):
    """A fault that plants the rank fault ``name`` on ``ranks`` (every
    rank by default) of a loop of ranks."""
    def plant(prog):
        prog.plant(name, ranks)
    plant.__doc__ = RANK_FAULTS[name].__doc__
    return plant


FAULTS = {"serve": {"altered_answer": serve_altered_answer,
                    "half_batch": serve_half_batch,
                    "decoder_layer_dropped": serve_decoder_layer_dropped,
                    "temporal_skipped": serve_temporal_skipped},
          "train": {"half_batch": train_half_batch,
                    "unchanged": train_unchanged},
          "train_ddp": {"rank1_skips_allreduce": on_ranks(
                            "keeps_own_gradient", (1,)),
                        "bn_per_rank": on_ranks("local_batch_stats"),
                        "rank1_on_rank0_rows": on_ranks("rows_of_rank0",
                                                        (1,)),
                        "half_batch": on_ranks("half_rows"),
                        "unchanged": on_ranks("unchanged")}}
