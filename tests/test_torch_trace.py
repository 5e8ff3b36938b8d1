"""The port's spans and counters (``dfvod_tpu_torch/utils/trace.py``).

Off, a span enters no profiler range. Under ``torch.profiler`` a serving
request and a train step give their spans in the layers' order and
nesting. A device sync under a root span is counted under the innermost
span: on the CPU through the warning the sync debug mode turns it into,
on the card (``-m cuda``) from a real sync.
"""
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dfvod_tpu_torch.models import build_model
from dfvod_tpu_torch.serve import Server
from dfvod_tpu_torch.train.engine import create_train_state, train_step
from dfvod_tpu_torch.utils import trace
from dfvod_tpu_torch.utils.config import Config, ModelConfig

SMALL = dict(fusion_type="LateFusion", num_classes=3, num_queries=12,
             hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2,
             dim_feedforward=128, dropout=0.0)
H, W = 64, 96


def frames(n=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (n, H, W, 4), generator=gen,
                           dtype=torch.uint8)
    sizes = torch.tensor([[H, W], [48, 80]] * (n // 2))
    return images, sizes


def train_batch(T=8):
    images, sizes = frames()
    gen = torch.Generator().manual_seed(1)
    B = images.shape[0]
    return {"images": images, "sizes": sizes,
            "labels": torch.randint(0, 2, (B, T), generator=gen),
            "boxes": torch.cat([torch.rand((B, T, 2), generator=gen) * 0.6
                                + 0.2, torch.rand((B, T, 2), generator=gen)
                                * 0.3 + 0.05], -1),
            "valid": torch.arange(T)[None] < torch.tensor([[3], [5]])}


def span_events(prof):
    return [e for e in prof.events() if e.name.startswith("dfvod.")]


def span_parent(e):
    """The innermost span around ``e``, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("dfvod."):
        p = p.cpu_parent
    return p


def children(events, parent):
    return [e.name[len("dfvod."):] for e in
            sorted((e for e in events if span_parent(e) is parent),
                   key=lambda e: e.time_range.start)]


def test_off_enters_no_range(monkeypatch):
    """Without a profiler a span is one shared null context, and neither a
    request nor a step opens a ``dfvod.`` range."""
    opened = []

    class Spy(torch.profiler.record_function):
        def __init__(self, name, *args):
            opened.append(name)
            super().__init__(name, *args)
    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    assert trace.span("serve.request") is trace.span("train.step")
    cfg = Config(model=ModelConfig(**SMALL))
    Server(cfg, device="cpu", dtype=torch.float32)(*frames())
    model, criterion, _ = build_model(cfg, device="cpu", seed=0)
    train_step(create_train_state(model, cfg), criterion, train_batch())
    assert not [n for n in opened if n.startswith("dfvod.")]


def test_serve_request_spans_nest():
    """Each request is one ``serve.request`` with normalize, model and
    postprocess in turn; the backbones and the trunk sit under the
    model."""
    server = Server(Config(model=ModelConfig(**SMALL)), device="cpu",
                    dtype=torch.float32)
    images, sizes = frames()
    server(images, sizes)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            server(images, sizes)
    events = span_events(prof)
    roots = [e for e in events if e.name == "dfvod.serve.request"]
    assert len(roots) == 2
    for root in roots:
        assert span_parent(root) is None
        assert children(events, root) == ["serve.normalize", "serve.model",
                                          "serve.postprocess"]
        [model] = [e for e in events if span_parent(e) is root
                   and e.name == "dfvod.serve.model"]
        assert children(events, model) == ["backbone", "depth_backbone",
                                           "trunk.encoder", "trunk.decoder"]


def test_train_step_phases_in_order():
    """A step is one ``train.step`` whose four phases follow each other
    without overlap, the matcher inside the criterion."""
    cfg = Config(model=ModelConfig(**SMALL))
    model, criterion, _ = build_model(cfg, device="cpu", seed=0)
    state = create_train_state(model, cfg)
    batch = train_batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(state, criterion, batch)
    events = span_events(prof)
    [root] = [e for e in events if e.name == "dfvod.train.step"]
    phases = sorted((e for e in events if span_parent(e) is root),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in phases] == [
        "dfvod.train.forward", "dfvod.train.criterion",
        "dfvod.train.backward", "dfvod.train.update"]
    for a, b in zip(phases, phases[1:]):
        assert a.time_range.end <= b.time_range.start
    assert children(events, phases[0])[:2] == ["backbone", "depth_backbone"]
    assert children(events, phases[1]) == ["matcher"]


def test_sync_warnings_count_under_the_innermost_span(monkeypatch):
    """A root span with CUDA up sets the sync debug mode to "warn", counts
    each sync warning as ``sync.<innermost span>``, passes other warnings
    on, and restores the mode it found."""
    modes = ["error"]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    before = trace.counter("sync.matcher")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with profile(activities=[ProfilerActivity.CPU]):
            with trace.span("train.step"):
                assert modes[-1] == "warn"
                with trace.span("train.criterion"), trace.span("matcher"):
                    for _ in range(2):
                        warnings.warn(trace.SYNC_WARNING
                                      + " (Triggered internally)")
                    warnings.warn("another warning")
    assert modes == ["error", "warn", "error"]
    assert trace.counter("sync.matcher") == before + 2
    assert [str(w.message) for w in seen] == ["another warning"]
    counts = trace.counters()
    counts["sync.matcher"] += 1
    assert trace.counter("sync.matcher") == before + 2


def test_counts_from_many_threads_add_up():
    """Threads counting at once (autograd's beside the caller) lose no
    count, with the interpreter switching threads as often as it can."""
    import sys
    import threading
    before = trace.counter("stress")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            trace.count("stress") for _ in range(500)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert trace.counter("stress") == before + 16 * 500


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the syncs and the kernels of the "
                    "step exist only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_syncs_counted_on_the_card(cuda_device):
    """One ``.item()`` inside a span counts one ``sync.<span>``; the
    detection step's criterion does not sync; the sync debug mode is the
    one set before."""
    x = torch.ones(4, device=cuda_device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        before = trace.counter("sync.serve.model")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            with trace.span("serve.request"), trace.span("serve.model"):
                x.sum().item()
            assert torch.cuda.get_sync_debug_mode() == 2
        assert trace.counter("sync.serve.model") == before + 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cfg = Config(model=ModelConfig(**SMALL))
    model, criterion, _ = build_model(cfg, device=cuda_device, seed=0)
    state = create_train_state(model, cfg)
    batch = {k: v.to(cuda_device) for k, v in train_batch().items()}
    train_step(state, criterion, batch)
    before = trace.counter("sync.train.criterion")
    matcher = trace.counter("sync.matcher")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        train_step(state, criterion, batch)
    assert trace.counter("sync.train.criterion") == before
    assert trace.counter("sync.matcher") == matcher
    assert torch.cuda.get_sync_debug_mode() == 0
