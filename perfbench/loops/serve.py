"""The serving loop: one client through
``dfvod_tpu_torch.serve.Server.__call__``, and its check against the plain
reference.

A request is one batch of the pool, sent in turn from pinned host memory;
it ends when its top-100 scores, labels and boxes are on the host. The
client is closed-loop (the next request goes when the last is answered),
or with the mix's ``arrival_rate_per_s`` open-loop: request i arrives at
i / rate seconds into the window and waits for the one before it, and its
latency runs from its arrival. The window runs requests until ``seconds``
have passed and ends with the last one's answer: every request started is
finished and counted.

A loop module (``perfbench/harness/spec.py::loop_module``) gives the
harness: ``KIND``, ``CHIPS``, ``build``, ``warm_up``, ``trace_events``,
``window``, ``traced_call``, ``hand_over`` and ``check_numbers``. The
reference it checks against is the cell's (``spec.reference``).
"""
from __future__ import annotations

import statistics
import time
import types

import numpy as np
import torch

from perfbench.harness import trace, weights


class Program:
    """The port's server for a cell, with the run's weights (drawn from
    the shapes of ``ref``, the configuration's reference module) loaded."""

    def __init__(self, config, seed, device, ref, dtype=torch.bfloat16):
        from dfvod_tpu_torch.serve import Server
        from dfvod_tpu_torch.utils.config import Config
        self.cfg = Config.from_flat(**config["config"])
        self.server = Server(self.cfg, device=device, dtype=dtype, seed=seed)
        self.frames = self.server.frames
        self.model = self.server.model
        w = draw_weights(config, seed, device, ref)
        weights.load(self.model, w)
        del w
        self.calls = 0
        self.sample(seed, 0)
        for name, mod in probes(self.model).items():
            mod.register_forward_hook(self._keeper(name))

    def sample(self, seed, k):
        """From now on keep, of the requests to come, a uniform sample of
        ``k`` drawn from ``seed`` (reservoir sampling: request i replaces a
        kept one with probability k / (i + 1)), counting from 0."""
        self.calls, self.k = 0, k
        self.rng = np.random.default_rng(seed % (2 ** 32))
        self.slots = {}
        self._slot = None

    def _keeper(self, name):
        def keep(mod, args, out):
            """A kept request's values at a probe, copied."""
            if self._slot is not None:
                self.slots[self._slot].update(
                    _copy(probe_values(name, args, out)))
        return keep

    @property
    def kept(self):
        """{request index: its kept values}."""
        return {r["index"]: r for r in self.slots.values()}

    def __call__(self, batch):
        i = self.calls
        slot = i if i < self.k else int(self.rng.integers(0, i + 1))
        self._slot = slot if slot < self.k else None
        if self._slot is not None:
            self.slots[self._slot] = {"index": i}
        out = self.server(batch["images"], batch["sizes"])
        self.calls += 1
        return out


def _copy(x):
    if torch.is_tensor(x):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _copy(v) for k, v in x.items()}
    return tuple(_copy(v) for v in x)


def probes(model):
    """{name: module} whose values the check reads: the ResNet (its
    stage-4 map), the single-frame trunk (the encoder's memory, the
    decoder's state and outputs), for clips the temporal head's last head
    (its input, the last round's queries), and the whole model (its
    answer's raw outputs). The port and the reference name these modules
    alike."""
    detr = model.detr if hasattr(model, "detr") else model
    out = {"backbone": detr.backbone, "trunk": detr, "model": model}
    if hasattr(model, "temp_head_2"):
        out["temporal"] = model.temp_head_2
    return out


# every 16th token of every frame's memory: the encoder over the whole
# batch at a 16th of the bytes
MEMORY_STRIDE = 16
# the trunk's state that the temporal head reads, beside its outputs
STATE = ("memory", "hs_last", "last_reference", "last_deltas")


def probe_values(name, args, out):
    """The values the check reads at a probe, from the port's or the
    reference's input and output there: the first frame's stage-4 map;
    every frame's memory at a stride, the trunk's state and its last
    layer's logits and boxes; the last temporal round's queries; the
    model's raw outputs."""
    if name == "temporal":
        return {"temporal_hs": args[0]}
    if name == "backbone":
        x = out[4] if isinstance(out, dict) else out
        return {"features": x[0]}
    if name == "trunk":
        t = out["_trunk"]
        return {"memory": t["memory"][:, ::MEMORY_STRIDE],
                "state": {k: t[k] for k in STATE},
                "trunk": (out["pred_logits"], out["pred_boxes"])}
    return {"final": (out["pred_logits"], out["pred_boxes"])}


def draw_weights(config, seed, device, ref):
    """The run's weights for the floating state of the reference module
    ``ref``'s model (the cell's ``reference``)."""
    from perfbench.harness.inputs import sub_seed
    with torch.device("meta"):
        model = ref.build(config["config"])
    return weights.draw(weights.floating_shapes(model), sub_seed(seed, 0),
                        config["config"], device, ref,
                        weights.offset_levels(model))


def host(out):
    return {k: out[k].cpu() for k in ("scores", "labels", "boxes")}


KIND = "serve"
CHIPS = (1,)


def build(cell, seed, device):
    return Program(cell.config, seed, device, ref=cell.reference)


def warm_up(prog, pool, traffic, seed):
    """The cell's one shape, ``warmup`` requests; then keep a seeded
    sample of the window's requests for the check."""
    for i in range(traffic["warmup"]):
        host(prog(pool[i % len(pool)]))
    prog.sample(seed, traffic["check_requests"])


def trace_events(prog):
    return layer_groups(prog.model)


def window(prog, pool, traffic, seconds, spans=None):
    """Requests for ``seconds``: their count, frames (a clip counts its key
    frame), the window's seconds, the answers, and the end-to-end
    metrics."""
    key_frames = traffic["frames_per_request"] // prog.frames
    rate = traffic.get("arrival_rate_per_s")
    lat, answers = [], {}
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = 0
    while True:
        batch = pool[i % len(pool)]
        t0 = time.perf_counter()
        if rate:
            arrival = t_start + i / rate
            if arrival > t0:
                time.sleep(arrival - t0)
            t0 = arrival
        t_call = time.perf_counter()
        with torch.profiler.record_function("bench.serve.call"):
            out = prog(batch)
        t1 = time.perf_counter()
        with torch.profiler.record_function("bench.serve.read"):
            answers[i] = host(out)
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        if spans is not None:
            spans.setdefault("dispatch", []).append(t1 - t_call)
        i += 1
        if t2 >= deadline:
            break
    prog.k = 0                          # the check reads the window's
    win = t2 - t_start
    lat_ms = [x * 1e3 for x in lat]
    p95 = float(np.percentile(lat_ms, 95))
    return types.SimpleNamespace(
        calls=i, frames=i * key_frames, seconds=win, key_frames=key_frames,
        answers=answers,
        failed=sum(1 for a in answers.values()
                   if not all(torch.isfinite(v.float()).all()
                              for v in a.values())),
        metrics={"serve_frames_per_s": {"value": i * key_frames / win,
                                        "unit": "frames/s"},
                 "serve_p95_ms": {"value": p95, "unit": "ms"}},
        summary=(f"{i} requests in {win:.3f} s; latency median "
                 f"{statistics.median(lat_ms):.3f} ms, p95 {p95:.3f} ms "
                 f"over {len(lat_ms)} requests"))


def traced_call(prog, batch):
    """One whole request, for the profiler stretch."""
    with torch.profiler.record_function("bench.serve.call"):
        out = prog(batch)
    with torch.profiler.record_function("bench.serve.read"):
        host(out)


def hand_over(prog, first, w):
    """What the check needs of the run, before the program is freed."""
    return {"kept": {i: r for i, r in prog.kept.items() if i in w.answers},
            "answers": w.answers, "frames": prog.frames}


def check_numbers(cell, seed, pool, held, device):
    return check(cell.config, cell.traffic, seed, pool, held["kept"],
                 held["answers"], device, held["frames"], cell.reference)


def consistent_topk(raw_logits, raw_boxes, sizes, ans):
    """How many of the program's detections the program's own raw outputs
    do not explain. The detections of an image are matched one to one to
    (query, class) candidates of the same class (an assignment, closest
    boxes first); a match holds where the candidate's sigmoid score and
    its box in pixels equal the detection's to the rounding of the raw
    outputs' dtype. Unmatched detections count, and so does every
    candidate left out that scores above the lowest one kept."""
    from scipy.optimize import linear_sum_assignment
    lg = raw_logits.float()
    B, Q, K = lg.shape
    Ke = K - 1 if K == 3 else K
    # the raw dtype's epsilon, relative: twice the rounding of one step
    rel = torch.finfo(raw_logits.dtype).eps
    prob = torch.sigmoid(lg[..., :Ke]).cpu().numpy()       # (B, Q, Ke)
    h, w = sizes[:, 0].float(), sizes[:, 1].float()
    scale = torch.stack([w, h, w, h], 1)[:, None]
    cx, cy, bw, bh = raw_boxes.float().cpu().unbind(-1)
    xyxy = (torch.stack([cx - 0.5 * bw, cy - 0.5 * bh, cx + 0.5 * bw,
                         cy + 0.5 * bh], dim=-1) * scale).numpy()  # (B, Q, 4)
    scale = scale.numpy()
    s = ans["scores"].float().numpy()
    lab = ans["labels"].long().numpy()
    bx = ans["boxes"].float().numpy()
    if s.shape[0] != B or lab.shape != s.shape or bx.shape[:2] != s.shape:
        return B * 100
    bad = 0
    for b in range(B):
        if not ((lab[b] >= 0) & (lab[b] < Ke)).all():
            bad += s.shape[1]
            continue
        p = prob[b][:, lab[b]]                             # (Q, k)
        ok_s = np.abs(p - s[b][None]) <= rel * s[b][None] + 1e-7
        diff = np.abs(xyxy[b][:, None, :] - bx[b][None])    # (Q, k, 4)
        ok_b = (diff <= rel * (np.abs(bx[b])[None] + scale[b, 0]) + 1e-6
                ).all(-1)
        ok = ok_s & ok_b
        # candidates are (query, class); a detection may take only its
        # own class, so one cost matrix per class
        for c in range(Ke):
            cols = np.flatnonzero(lab[b] == c)
            if not len(cols):
                continue
            cost = np.where(ok[:, cols], diff[:, cols].max(-1), 1e9)
            rows, picked = linear_sum_assignment(cost.T)
            bad += len(cols) - int((cost.T[rows, picked] < 1e9).sum())
        above = int((prob[b] > s[b].min() * (1 + rel) + 1e-7).sum())
        bad += max(0, above - s.shape[1])
    return bad


def _cat(parts):
    if torch.is_tensor(parts[0]):
        return torch.cat(parts)
    if isinstance(parts[0], dict):
        return {k: _cat([p[k] for p in parts]) for k in parts[0]}
    return tuple(_cat(list(p)) for p in zip(*parts))


def forward_kept(ref, images, sizes, block, normalize):
    """The reference's own forward over one request, ``block`` frames at
    a time (``normalize`` the reference module's), in the form the
    program's probes keep: the first frame's stage-4 map, and over every
    frame the memory at a stride, the trunk's state and outputs, and the
    raw outputs."""
    vals = []
    hooks = [mod.register_forward_hook(
        lambda mod_, a, o, name=name: vals[-1].update(
            probe_values(name, a, o)))
        for name, mod in probes(ref).items()]
    try:
        for a in range(0, images.shape[0], block):
            vals.append({})
            ref(*normalize(images[a:a + block], sizes[a:a + block]))
    finally:
        for h in hooks:
            h.remove()
    res = {k: _cat([v[k] for v in vals]) for k in vals[0]
           if k != "features"}
    res["features"] = vals[0]["features"]
    return res


def stage_outputs(ref, images, sizes, block, kept, frames, normalize):
    """The reference's decoder, and for clips its temporal head, each run
    from the state that the program kept, ``block`` frames at a time: the
    decoder and its heads over the program's memory (its last layer's
    logits and boxes, every frame), the temporal head over the program's
    trunk state and logits (the key frames' final logits and boxes)."""
    detr = ref.detr if hasattr(ref, "detr") else ref
    out = {}
    for a in range(0, images.shape[0], block):
        _, mask = normalize(images[a:a + block], sizes[a:a + block])
        st = {k: v[a:a + block].float() for k, v in kept["state"].items()}
        t = detr.decode_from(st["memory"], mask)
        res = {"decoder_hs": t["hs_last"], "decoder_logit": t["classes"][-1],
               "decoder_box": t["coords"][-1]}
        if frames > 1:
            o = ref.temporal_head(
                {**st, "pos_flat": t["pos_flat"],
                 "valid_ratios": t["valid_ratios"]},
                kept["trunk"][0][a:a + block].float(), mask)
            res["temporal_hs"] = o["hs"]
            res["temporal_logit"] = o["pred_logits"]
            res["temporal_box"] = o["pred_boxes"]
        for k, v in res.items():
            out.setdefault(k, []).append(v)
    return {k: torch.cat(v) for k, v in out.items()}


def program_values(kept):
    """The program's values that the check compares, by name."""
    (tl, tb), (fl, fb) = kept["trunk"], kept["final"]
    return {"features": kept["features"], "memory": kept["memory"],
            "decoder_hs": kept["state"]["hs_last"], "decoder_logit": tl,
            "decoder_box": tb, "temporal_hs": kept.get("temporal_hs"),
            "temporal_logit": fl, "temporal_box": fb}


def _whole(kept, n, frames):
    """Whether the program kept every value the check reads, with a row
    for each of the request's ``n`` frames (the answer: each clip)."""
    if any(k not in kept for k in ("features", "memory", "state", "trunk",
                                   "final")):
        return False
    if frames > 1 and kept.get("temporal_hs") is None:
        return False
    rows = [kept["memory"], *kept["state"].values(), *kept["trunk"]]
    return (all(v.shape[0] == n for v in rows)
            and all(v.shape[0] == n // frames for v in kept["final"]))


@torch.no_grad()
def check(config, traffic, seed, pool, kept, answers, device, frames,
          ref_mod):
    """Compare the kept requests with the plain reference (f32, TF32 off)
    stage by stage. From the request's frames: the first frame's ResNet
    map and every frame's memory at a stride. From the program's own
    kept state: its decoder and heads (every frame's last-layer logits
    and boxes, from its memory) and, for clips, its temporal head (the
    final logits and boxes, from its trunk's state and logits). Each gap
    is measured in units of the model's sensitivity to bf16: the program's
    root-mean-square (or median) gap to the f32 reference over that of
    the same reference with its operands rounded to bf16
    (``lowprec.bf16``) on the same inputs, pooled over the kept requests.
    The answers must be what the program's raw outputs give
    (``post_mismatch``). ``ref_mod``: the cell's reference module. Returns {number: value}."""
    from perfbench.harness.lowprec import bf16
    norm = ref_mod.normalize
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ref_mod.build(config["config"]).to(device)
    weights.load(ref, draw_weights(config, seed, device, ref_mod))
    parts = ("features", "memory", "decoder_hs", "decoder_logit",
             "decoder_box") + (("temporal_hs", "temporal_logit",
                                "temporal_box") if frames > 1 else ())
    sse = {p: [0.0, 0.0, 0.0] for p in parts}   # program, bf16 reference,
    # and the bf16 reference with its values stored as the program's are
    absd = {p: ([], []) for p in parts}
    mismatch, checked, bad_shape = 0, 0, False
    block = traffic["check_block"]

    for i, kept_i in sorted(kept.items()):
        batch = pool[i % len(pool)]
        if not _whole(kept_i, batch["images"].shape[0], frames):
            bad_shape = True
            continue
        images = batch["images"].to(device)
        sizes = batch["sizes"].to(device)
        ref_out = forward_kept(ref, images, sizes, block, norm)
        ref_out.update(stage_outputs(ref, images, sizes, block, kept_i,
                                     frames, norm))
        with bf16():
            emu_out = forward_kept(ref, images, sizes, block, norm)
            emu_out.update(stage_outputs(ref, images, sizes, block, kept_i,
                                         frames, norm))
        prog = program_values(kept_i)
        for p in parts:
            if prog[p].shape != ref_out[p].shape:
                bad_shape = True
                continue
            dp = (prog[p].float() - ref_out[p]).flatten()
            de = (emu_out[p] - ref_out[p]).flatten()
            ds = (emu_out[p].to(prog[p].dtype).float()
                  - ref_out[p]).flatten()
            sse[p][0] += float(dp.square().sum())
            sse[p][1] += float(de.square().sum())
            sse[p][2] += float(ds.square().sum())
            absd[p][0].append(dp.abs().cpu())
            absd[p][1].append(de.abs().cpu())
        mismatch += consistent_topk(*kept_i["final"],
                                    batch["sizes"][::frames], answers[i])
        checked += 1
    del ref
    out = {}
    for p in parts:
        if bad_shape or not checked:
            out[f"{p}_ratio"] = out[f"{p}_median_ratio"] = \
                out[f"{p}_stored_ratio"] = float("inf")
            continue
        out[f"{p}_ratio"] = (sse[p][0] / max(sse[p][1], 1e-30)) ** 0.5
        out[f"{p}_stored_ratio"] = (sse[p][0] / max(sse[p][2], 1e-30)) ** 0.5
        mp = float(torch.cat(absd[p][0]).median())
        me = float(torch.cat(absd[p][1]).median())
        out[f"{p}_median_ratio"] = mp / max(me, 1e-30)
    out["post_mismatch"] = float(mismatch) if checked else float("inf")
    out["requests_checked"] = float(checked)
    return out


def layer_groups(model):
    """The hooked module groups of a traced serve run."""
    detr = model.detr if hasattr(model, "detr") else model
    t = detr.transformer
    groups = {
        "backbone": [detr.backbone, detr.depth_backbone],
        "transformer": [t.depth_encoder_layer]
        + [getattr(t, f"encoder_layers_{i}")
           for i in range(t.num_encoder_layers)]
        + [getattr(t, f"decoder_layers_{i}")
           for i in range(t.num_decoder_layers)],
    }
    pairs, handles = trace.hook_events(groups)
    if hasattr(model, "detr"):
        p2, h2 = trace.span_events(model.detr, model, "temporal")
        pairs.update(p2)
        handles += h2
    return pairs, handles
