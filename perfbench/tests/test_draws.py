"""What the seed draws: targets with a mix's own label classes, and each
deformable attention's ring of sampling offsets with its own level count.
Without those, the draws are bit for bit what they were; so are the
frames, which are now made a chunk at a time."""
import pytest
import torch
import torch.nn.functional as F

from perfbench.harness import inputs, spec, weights
from perfbench.reference import model as ref_model
from perfbench.tests import tiny


def targets_before(n, slots, min_boxes, max_boxes, seed):
    """``inputs.targets`` as it drew before a mix could name its label
    classes."""
    gen = torch.Generator().manual_seed(inputs.sub_seed(seed, 2))
    count = torch.randint(min_boxes, max_boxes + 1, (n,), generator=gen)
    valid = torch.arange(slots)[None] < count[:, None]
    labels = torch.randint(0, 2, (n, slots), generator=gen) * valid
    cxcy = torch.rand((n, slots, 2), generator=gen) * 0.6 + 0.2
    wh = torch.rand((n, slots, 2), generator=gen) * 0.3 + 0.05
    boxes = torch.cat([cxcy, wh], -1) * valid[..., None]
    return {"labels": labels, "boxes": boxes, "valid": valid}


def frames_before(n, height, width, content_sizes, seed):
    """``inputs.frames`` on the CPU as it made the whole pool at once."""
    gen = torch.Generator().manual_seed(inputs.sub_seed(seed, 1))
    low = torch.rand((n, 4, max(height // 16, 1), max(width // 16, 1)),
                     generator=gen)
    x = F.interpolate(low, size=(height, width), mode="bilinear",
                      align_corners=False)
    x = x + 0.1 * torch.rand((n, 4, height, width), generator=gen)
    x = (x.clamp(0, 1) * 255).to(torch.uint8).permute(0, 2, 3, 1)
    start = int(torch.randint(len(content_sizes), (1,), generator=gen))
    sizes = torch.tensor([content_sizes[(start + i) % len(content_sizes)]
                          for i in range(n)], dtype=torch.int64)
    h = torch.arange(height)[None, :, None]
    w = torch.arange(width)[None, None, :]
    pad = (h >= sizes[:, 0, None, None]) | (w >= sizes[:, 1, None, None])
    return x.masked_fill(pad[..., None], 0).contiguous(), sizes


@pytest.mark.parametrize("n", [5, inputs.CHUNK, 2 * inputs.CHUNK + 5])
def test_frames_made_in_chunks_are_unchanged(n):
    sizes = [(64, 96), (48, 96), (64, 80)]
    got = inputs.frames(n, 64, 96, sizes, 2 ** 31 + 99, "cpu")
    want = frames_before(n, 64, 96, sizes, 2 ** 31 + 99)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and g.stride() == x.stride()
        assert torch.equal(g, x)


def test_targets_without_label_classes_are_unchanged():
    got = inputs.targets(40, 64, 1, 20, 2 ** 31 + 7)
    want = targets_before(40, 64, 1, 20, 2 ** 31 + 7)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k


def test_label_classes_from_the_mix():
    traffic = {"loop": "train", "frames_per_request": 8, "pool": 2,
               "height": 32, "width": 48, "content_sizes": [[32, 48]],
               "target_slots": 16, "min_boxes": 1, "max_boxes": 16,
               "label_classes": [3, 5, 90]}
    pool = inputs.pool(traffic, 9, "cpu", kind="train")
    labels = torch.cat([b["labels"][b["valid"]] for b in pool])
    assert set(labels.tolist()) == {3, 5, 90}
    assert (torch.cat([b["labels"][~b["valid"]] for b in pool]) == 0).all()


def _cfg(name):
    cfg = spec.load_json(f"{spec.PERFBENCH}/configs/{name}.json")
    cfg["config"].update(tiny.TINY_MODEL)
    return cfg


def test_one_level_weights_are_unchanged():
    ref = spec.reference({})
    for name in ("latefusion_r50_dformer",
                 "transvodpp_latefusion_r50_dformer"):
        c = _cfg(name)["config"]
        with torch.device("meta"):
            model = ref.build(c)
        levels = weights.offset_levels(model)
        assert levels and set(levels.values()) == {1}
        shapes = weights.floating_shapes(model)
        got = weights.draw(shapes, 17, c, "cpu", ref, levels)
        # no level counts, one level each: how the rings were drawn before
        want = weights.draw(shapes, 17, c, "cpu", ref, {})
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_a_four_level_ring():
    ref = spec.reference({})
    attn = torch.nn.ModuleDict({"a": ref_model.MSDeformAttn(
        32, n_levels=4, n_heads=8, n_points=4)})
    levels = weights.offset_levels(attn)
    assert levels == {"a.sampling_offsets.bias": 4}
    shapes = weights.floating_shapes(attn)
    w = weights.draw(shapes, 3, {"nheads": 8}, "cpu", ref, levels)
    one = weights.draw(shapes, 3, {"nheads": 8}, "cpu", ref, {})
    name = "a.sampling_offsets.bias"
    # the same noise around the ring of four levels, not of one level
    # with four times the points
    assert torch.allclose(w[name] - ref_model.ring_bias(8, 4, 4),
                          one[name] - ref_model.ring_bias(8, 1, 16),
                          atol=1e-5)
    assert not torch.equal(w[name], one[name])
