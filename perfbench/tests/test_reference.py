"""The plain reference agrees with dfvod_tpu_torch on the CPU, in f32, at
a tiny configuration: the single-frame and TransVOD++ forwards, the
postprocess, and three train steps (losses, first gradients, changes)."""
import pytest
import torch

from perfbench.harness import inputs, spec, weights
from perfbench.loops import serve, train
from perfbench.reference import model as ref_model
from perfbench.tests import tiny


def tiny_config(name, **over):
    cfg = spec.load_json(f"{spec.PERFBENCH}/configs/{name}.json")
    cfg["config"].update(tiny.TINY_MODEL, **over)
    return cfg


@pytest.mark.parametrize("name", ["latefusion_r50_dformer",
                                  "transvodpp_latefusion_r50_dformer"])
def test_forward_and_postprocess_agree(name):
    torch.manual_seed(0)
    cfg = tiny_config(name)
    ref_mod = spec.reference(cfg)
    prog = serve.Program(cfg, 7, "cpu", ref_mod, dtype=torch.float32)
    x, s = inputs.frames(2 * prog.frames, 64, 96,
                         tiny.TINY_FRAME["content_sizes"], 7, "cpu")
    prog.sample(7, 1)
    ans = serve.host(prog({"images": x, "sizes": s}))
    ref = ref_model.build(cfg["config"])
    weights.load(ref, serve.draw_weights(cfg, 7, "cpu", ref_mod))
    block = x.shape[0]
    with torch.no_grad():
        out = serve.forward_kept(ref, x, s, block, ref_model.normalize)
        stages = serve.stage_outputs(ref, x, s, block, prog.kept[0],
                                     prog.frames, ref_model.normalize)
    kept = prog.kept[0]
    for part in ("trunk", "final"):
        for got, want, tol in zip(kept[part], out[part], (1e-4, 1e-5)):
            assert got.shape == want.shape
            assert (got - want).abs().max() < tol
    for k, v in kept["state"].items():
        assert (v - out["state"][k]).abs().max() < 1e-4 * max(
            1.0, float(out["state"][k].abs().max())), k
    assert (kept["features"] - out["features"]).abs().max() < 1e-3 * \
        out["features"].abs().max()
    # the reference's stages run from the program's state give what its
    # own forward gives
    prog_vals = serve.program_values(kept)
    for k, v in stages.items():
        assert (v - prog_vals[k]).abs().max() < 1e-4, k
    scores, labels, boxes = ref_model.postprocess(
        *out["final"], s[::prog.frames])
    assert (ans["scores"] - scores).abs().max() < 1e-5
    assert serve.consistent_topk(*kept["final"], s[::prog.frames], ans) == 0


def test_train_steps_agree():
    cfg = tiny_config("latefusion_r50_dformer", train_dtype="float32")
    traffic = {"loop": "train", "frames_per_request": 2, "pool": 3,
               "height": 64, "width": 96,
               "content_sizes": tiny.TINY_FRAME["content_sizes"],
               "target_slots": 8, "min_boxes": 1, "max_boxes": 4}
    pool = inputs.pool(traffic, 5, "cpu", "train")
    ref_mod = spec.reference(cfg)
    prog = train.first_steps(train.Program(cfg, 5, "cpu", ref_mod), pool, 3)
    ref = train.reference_steps(cfg, 5, pool, 3, "cpu", ref_mod)
    c = train.compare(prog, ref, ref_mod)
    assert c["loss_gap"] < 1e-5
    assert c["grad_gap"] < 1e-3
    assert c["change_gap"] < 1e-2
    assert c["grad_median_gap"] < 1e-4
