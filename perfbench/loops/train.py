"""The training loop through ``dfvod_tpu_torch.train.engine.train_step``,
and its check against the plain reference.

Set-up builds one train state (model, AdamW state, dropout generator) from
the seed and drives it through its first steps with the window's own call
and feed, on distinct batches; those steps are what the reference
follows. The window then goes on with the same object. Every step reads
its loss to the host, as the CLI's train loop does. The reference it
checks against is the cell's (``spec.reference``), which gives the train
step's functions named in ``perfbench/README.md``.
"""
from __future__ import annotations

import math
import time
import types

import torch

from perfbench.harness import weights
from perfbench.harness.inputs import sub_seed
from perfbench.loops.serve import MEMORY_STRIDE, draw_weights


def train_seed(seed):
    """The seed of the dropout masks, the same on both sides."""
    return sub_seed(seed, 3) % (2 ** 31)


class Program:
    """The port's train state for a cell, with the run's weights (drawn
    from the shapes of ``ref``, the configuration's reference module).
    ``join``: called before the train state is made (a rank joins its
    process group there)."""

    def __init__(self, config, seed, device, ref, join=None):
        from dfvod_tpu_torch.models import build_model
        from dfvod_tpu_torch.train.engine import create_train_state
        from dfvod_tpu_torch.utils.config import Config
        self.reference = ref
        self.cfg = Config.from_flat(**config["config"], seed=train_seed(seed))
        model, self.criterion, _ = build_model(self.cfg, device=device,
                                               seed=seed)
        weights.load(model, draw_weights(config, seed, device,
                                         self.reference))
        if join is not None:
            join()
        self.state = create_train_state(model, self.cfg)
        self.model = model

    def __call__(self, batch):
        from dfvod_tpu_torch.train.engine import train_step
        return train_step(self.state, self.criterion, batch)

    def trainable(self):
        return {n: p for n, p in self.model.named_parameters()
                if p.requires_grad}


def first_steps(prog, pool, n):
    """Drive ``prog`` through its first ``n`` steps; what the check needs
    of them: each step's loss, each leaf's first gradient (from AdamW's
    state after step 1) and its change after step ``n``."""
    ref = prog.reference
    start = {k: p.detach().clone() for k, p in prog.trainable().items()}
    losses, grads, out1 = [], None, {}

    def keep(mod, args, out):
        if not out1:
            out1.update({k: out[k].detach().float()
                         for k in ("pred_logits", "pred_boxes")})
            out1["memory"] = out["_trunk"]["memory"][
                :, ::MEMORY_STRIDE].detach().float()
    hook = prog.model.register_forward_hook(keep)
    for i in range(n):
        losses.append(float(prog(pool[i % len(pool)])["loss"]))
        if i == 0:
            hook.remove()
            grads = ref.leaf_norms(ref.first_moment_grads(
                prog.state.optimizer, prog.trainable().items()))
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in prog.trainable().items()}
    return {"losses": losses, "grads": grads, "change": change,
            "out1": out1}


KIND = "train"
CHIPS = (1,)


def build(cell, seed, device):
    return Program(cell.config, seed, device, ref=cell.reference)


def warm_up(prog, pool, traffic, seed):
    """The first ``check_steps`` steps, which the check follows."""
    return first_steps(prog, pool, traffic["check_steps"])


def trace_events(prog):
    return optimizer_events(prog.state.optimizer)


def window(prog, pool, traffic, seconds, spans=None):
    """Steps for ``seconds`` after the first ``check_steps``: their count,
    frames, the window's seconds and the end-to-end metric."""
    frames_per_step, first = traffic["frames_per_request"], \
        traffic["check_steps"]
    steps, losses, ends = 0, [], []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        batch = pool[(first + steps) % len(pool)]
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.train.step"):
            metrics = prog(batch)
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench.train.read"):
            losses.append(float(metrics["loss"]))
        t2 = time.perf_counter()
        ends.append(t2)
        if spans is not None:
            spans.setdefault("dispatch", []).append(t1 - t0)
        steps += 1
        if t2 >= deadline:
            break
    win = t2 - t_start
    frames = steps * frames_per_step
    return types.SimpleNamespace(
        calls=steps, frames=frames, seconds=win, key_frames=frames_per_step,
        failed=sum(1 for x in losses if not math.isfinite(x)),
        metrics={"train_frames_per_s": {"value": frames / win,
                                        "unit": "frames/s"}},
        summary=f"{steps} steps in {win:.3f} s; " + step_quantiles(
            t_start, ends))


def step_quantiles(t_start, ends):
    """The window's step times in ms (each from the end of the one
    before): p10, median, p90, max, and their sum beyond 1.5x the median,
    on standard error only, to tell a uniformly slow run from one that
    stalled."""
    import statistics
    ms = [1e3 * (b - a) for a, b in zip([t_start] + ends[:-1], ends)]
    if len(ms) < 2:
        return "step ms: too few steps"
    q = statistics.quantiles(ms, n=10)
    med = statistics.median(ms)
    slow = sum(x - med for x in ms if x > 1.5 * med)
    return (f"step ms p10 {q[0]:.2f} median {med:.2f} p90 {q[-1]:.2f} "
            f"max {max(ms):.2f}, beyond 1.5x median {slow:.1f}")


def traced_call(prog, batch):
    """One whole step with its loss read, for the profiler stretch."""
    with torch.profiler.record_function("bench.train.step"):
        m = prog(batch)
    with torch.profiler.record_function("bench.train.read"):
        float(m["loss"])


def hand_over(prog, first, w):
    return first


def check_numbers(cell, seed, pool, first, device):
    """The reference's first steps in f32 and with bf16 operands, and the
    program's gaps to the f32 one in units of the bf16 one's."""
    from perfbench.harness.cell import free
    from perfbench.harness.lowprec import bf16
    n = cell.traffic["check_steps"]
    ref = reference_steps(cell.config, seed, pool, n, device,
                          cell.reference)
    free(device != "cpu")
    emu = reference_steps(cell.config, seed, pool, n, device,
                          cell.reference, lowprec=bf16)
    return ratios(first, emu, ref, cell.reference)


def reference_steps(config, seed, pool, n, device, ref_mod, lowprec=None,
                    ranks=1):
    """The reference module ``ref_mod``'s first ``n`` steps (f32, TF32
    off), or with ``lowprec`` a context that lowers its precision (the
    control); with ``ranks`` > 1 its ``DataParallelStep`` over that many
    ranks' rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ref_mod.build(config["config"]).to(device)
    weights.load(ref, draw_weights(config, seed, device, ref_mod))
    c = config["config"]
    step = (ref_mod.TrainStep(ref, c, c, train_seed(seed)) if ranks == 1
            else ref_mod.DataParallelStep(ref, c, c, train_seed(seed),
                                          ranks))
    named = [(k, p) for k, p in ref.named_parameters() if p.requires_grad]
    start = {k: p.detach().clone() for k, p in named}
    losses, grads, out1 = [], None, None
    for i in range(n):
        batch = {k: v.to(device) for k, v in pool[i % len(pool)].items()}
        if lowprec is not None:
            with lowprec():
                losses.append(step(batch))
        else:
            losses.append(step(batch))
        if i == 0:
            grads = ref_mod.leaf_norms(ref_mod.first_moment_grads(
                step.opt, named))
            out1 = step.last_out
    change = {k: float((p.detach() - start[k]).norm()) for k, p in named}
    return {"losses": losses, "grads": grads, "change": change,
            "out1": out1}


def ratios(prog, emu, ref, ref_mod):
    """The numbers the check holds, each in units of the model's
    sensitivity to bf16: the program's gaps to the f32 reference
    (``compare``) over those of the reference with bf16 operands."""
    p, e = compare(prog, ref, ref_mod), compare(emu, ref, ref_mod)
    out = {}
    for k, key in (("memory", "memory"), ("logit", "pred_logits"),
                   ("box", "pred_boxes")):
        r = ref["out1"][key]
        pk = prog["out1"].get(key)
        if pk is None or pk.shape != r.shape:
            out[f"fwd_{k}_ratio"] = float("inf")
            continue
        d_p = float((pk.float() - r).square().sum())
        d_e = float((emu["out1"][key] - r).square().sum())
        out[f"fwd_{k}_ratio"] = (d_p / max(d_e, 1e-30)) ** 0.5
    out.update({f"{k}_ratio": p[k] / max(e[k], 1e-30)
                for k in ("loss_rms", "grad_median_gap",
                          "change_median_gap")})
    out.update({k: v for k, v in p.items() if not k.startswith("_")})
    # the bf16 reference's own worst leaves, and beside each of the
    # program's three worst leaves the bf16 reference's gap on that leaf
    for name in ("grad", "change"):
        out[f"emu_{name}_gap"] = e.get(f"{name}_gap", float("inf"))
        gp, ge = p.get(f"_{name}_gaps", {}), e.get(f"_{name}_gaps", {})
        for k in sorted(gp, key=gp.get)[-3:]:
            out[f"_{name}_leaf {k}"] = {"program": gp[k], "bf16_ref":
                                        ge.get(k)}
    return out


def compare(prog, ref, ref_mod):
    """The numbers the check holds: the worst step's relative loss gap,
    and the worst leaf's gap of first-gradient norms and of change norms
    (against max(the leaf's reference norm, the median leaf's)). Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone and are left out of both."""
    import numpy as np
    rel = [abs(a - b) / max(abs(b), 1e-12)
           for a, b in zip(prog["losses"], ref["losses"])]
    loss_gap = max(rel)
    loss_rms = (sum(r * r for r in rel) / len(rel)) ** 0.5
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = loss_rms = float("inf")
    g = ref["grads"]
    if set(prog["grads"]) != set(g) or set(prog["change"]) != set(
            ref["change"]):
        return {"loss_gap": loss_gap, "loss_rms": loss_rms,
                "grad_gap": float("inf"),
                "change_gap": float("inf"), "grad_median_gap": float("inf"),
                "change_median_gap": float("inf"), "leaves_skipped": 0.0}
    med = float(np.median(list(g.values())))
    skip = {k for k, v in g.items() if v < 1e-3 * med}
    out = {"loss_gap": loss_gap, "loss_rms": loss_rms,
           "leaves_skipped": float(len(skip))}
    for name, p, r in (("grad", prog["grads"], g),
                       ("change", prog["change"], ref["change"])):
        gaps = ref_mod.leaf_gaps(p, r, skip)
        out[f"{name}_gap"] = max(gaps.values())
        out[f"{name}_median_gap"] = float(np.median(list(gaps.values())))
        out[f"_{name}_gaps"] = gaps
    return out


def optimizer_events(optimizer):
    """A CUDA event pair around every optimizer step."""
    pairs = {"optimizer": []}

    def pre(opt, args, kwargs):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pairs["optimizer"].append([ev, None])

    def post(opt, args, kwargs):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        pairs["optimizer"][-1][1] = ev
    return pairs, [optimizer.register_step_pre_hook(pre),
                   optimizer.register_step_post_hook(post)]
