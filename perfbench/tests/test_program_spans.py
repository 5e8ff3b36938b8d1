"""The readers of the program's spans and counters, found by name as the
harness finds them, on a hand-built profiler stretch: nested ``dfvod.*``
ranges, and runtime calls inside and outside the root spans."""
import types

import pytest
from torch.autograd import DeviceType

from perfbench.harness import spec, trace

SERVE = ("model_host_ms.serve", "syncs.serve", "sync_wait_ms.serve",
         "launches.serve")
TRAIN = ("forward_host_ms.train", "criterion_host_ms.train",
         "backward_host_ms.train", "update_host_ms.train", "syncs.train",
         "sync_wait_ms.train", "launches.train")


class Evt:
    def __init__(self, name, a, b, device="CPU"):
        self.name = name
        self.time_range = types.SimpleNamespace(start=a, end=b)
        self.device_type = getattr(DeviceType, device)
        self.is_user_annotation = name.startswith("dfvod.")


def serve_stretch():
    """Two requests of 1000 us; the second one's model half as long; the
    read after each holds a sync and a copy outside the root span."""
    events = []
    for t in (0, 2000):
        events += [
            Evt("bench.serve.call", t, t + 1000),
            Evt("dfvod.serve.request", t + 10, t + 990),
            Evt("dfvod.serve.normalize", t + 10, t + 110),
            Evt("cudaMemcpyAsync", t + 20, t + 30),
            Evt("cudaStreamSynchronize", t + 30, t + 90),
            Evt("dfvod.serve.model", t + 110, t + (810 if t else 510)),
            Evt("dfvod.backbone", t + 120, t + 300),
            Evt("cudaLaunchKernel", t + 130, t + 135),
            Evt("cuLaunchKernelEx", t + 140, t + 145),
            Evt("cudaLaunchKernelExC", t + 150, t + 155),
            Evt("cudaLaunchHostFunc", t + 160, t + 165),
            Evt("dfvod.serve.postprocess", t + 900, t + 980),
            Evt("cudaGraphLaunch", t + 910, t + 915),
            Evt("bench.serve.read", t + 1000, t + 1500),
            Evt("cudaLaunchKernel", t + 1010, t + 1015),
            Evt("cudaStreamSynchronize", t + 1020, t + 1400),
            Evt("k", t + 130, t + 600, "CUDA")]
    return events


def train_stretch():
    """One step: four phases, a launch from autograd's thread inside the
    backward, an event sync in the update, a launch and a sync after the
    step (the loss read)."""
    return [Evt("bench.train.step", 0, 10000),
            Evt("dfvod.train.step", 0, 9900),
            Evt("dfvod.train.forward", 100, 3100),
            Evt("cudaLaunchKernel", 200, 210),
            Evt("dfvod.train.criterion", 3100, 4100),
            Evt("dfvod.matcher", 3500, 3900),
            Evt("cuLaunchKernel", 3600, 3610),
            Evt("dfvod.train.backward", 4100, 8100),
            Evt("cudaLaunchKernel", 5000, 5010),
            Evt("dfvod.train.update", 8100, 9600),
            Evt("cudaEventSynchronize", 9000, 9250),
            Evt("cudaLaunchKernel", 9950, 9960),
            Evt("cudaStreamSynchronize", 9960, 9990),
            Evt("k", 200, 9000, "CUDA")]


def read(name, events, calls, monkeypatch=None, counts=None):
    if monkeypatch is not None:
        from dfvod_tpu_torch.utils import trace as program_trace
        monkeypatch.setattr(program_trace, "counters", lambda: dict(counts))
    profile = trace.Profile(events, calls=calls, wall_s=1.0)
    return spec.metric_reader(name)(types.SimpleNamespace(profile=profile))


def test_serve_readers(monkeypatch):
    events = serve_stretch()
    assert read("model_host_ms.serve", events, 2) == pytest.approx(0.55)
    assert read("launches.serve", events, 2) == 4
    assert read("sync_wait_ms.serve", events, 2) == pytest.approx(0.06)
    counts = {"sync.serve.normalize": 2, "sync.serve.model": 4,
              "lapjv": 9}
    assert read("syncs.serve", events, 2, monkeypatch, counts) == 3


def test_train_readers(monkeypatch):
    events = train_stretch()
    want = {"forward_host_ms.train": 3.0, "criterion_host_ms.train": 1.0,
            "backward_host_ms.train": 4.0, "update_host_ms.train": 1.5,
            "launches.train": 3, "sync_wait_ms.train": 0.25}
    for name, value in want.items():
        assert read(name, events, 1) == pytest.approx(value), name
    counts = {"sync.train.update": 1, "msda_fwd": 13}
    assert read("syncs.train", events, 1, monkeypatch, counts) == 1


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_silent_without_program_spans(name):
    """Against a port that opens no ``dfvod.*`` range (the parent of the
    tracing module), or with no profiler stretch, every reader gives
    None."""
    events = [e for e in serve_stretch() + train_stretch()
              if not e.name.startswith("dfvod.")]
    assert read(name, events, 2) is None
    assert spec.metric_reader(name)(types.SimpleNamespace(
        profile=None)) is None


def test_entries_name_their_cells():
    bench = spec.load_json(spec.ROOT + "/BENCHMARK.json")
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for names, cells, moves in (
            (SERVE, ["latefusion.serve.b32", "transvodpp.serve.c8x5"],
             "serve_frames_per_s"),
            (TRAIN, ["latefusion.train.b32"], "train_frames_per_s")):
        for name in names:
            assert by_name[name]["workloads"] == cells, name
            assert by_name[name]["moves"] == moves, name
