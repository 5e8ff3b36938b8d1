"""The traced run's readings: CUDA-event spans and the profiler's
device intervals."""
from torch import nn

from perfbench.harness import trace


def test_span_events_merge_into_another_dict():
    """The temporal span's list exists before its first call, so the
    traced run's merged dict sees what the hooks record."""
    a, b = nn.Identity(), nn.Identity()
    pairs, handles = trace.span_events(a, b, "temporal")
    merged = {"backbone": []}
    merged.update(pairs)
    assert merged["temporal"] is pairs["temporal"]
    for h in handles:
        h.remove()


def test_busy_is_the_union_and_gaps_are_named():
    """Two overlapping kernels count once; an idle gap is named by the
    marked call and the host op around its middle."""

    class Evt:
        def __init__(self, name, a, b, device):
            from torch.autograd import DeviceType
            self.name = name
            self.time_range = type("R", (), {"start": a, "end": b})()
            self.device_type = getattr(DeviceType, device)
            self.is_user_annotation = False
    events = [Evt("bench.serve.call", 0, 100, "CPU"),
              Evt("aten::copy_", 40, 60, "CPU"),
              Evt("void k1<float>(float*)", 0, 30, "CUDA"),
              Evt("void k2<float>(float*)", 20, 35, "CUDA"),
              Evt("void k1<float>(float*)", 70, 100, "CUDA")]
    p = trace.Profile(events, calls=1, wall_s=1e-4)
    assert p.busy_us == 65 and p.window_us == 100
    b = p.breakdown()
    name, seconds = b["device_ops"][0]
    assert name == "k1<float>" and abs(seconds - 60e-6) < 1e-12
    [(gap, seconds)] = b["idle_gaps"]
    assert gap == "bench.serve.call / aten::copy_"
    assert abs(seconds - 35e-6) < 1e-12
