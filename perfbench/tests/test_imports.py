"""No module that a benchmark run loads has the top-level name jax,
jaxlib, flax, optax or dfvod_tpu (compared whole: dfvod_tpu_torch is the
port), and the reference loads nothing of dfvod_tpu_torch."""
import json
import subprocess
import sys

from perfbench.harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dfvod_tpu")


def loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=spec.ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": spec.ROOT})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_the_ports_paths_load_no_jax():
    tops = loaded_after(
        "import perfbench.harness.cli, perfbench.harness.cell, "
        "perfbench.harness.ranks, perfbench.loops.serve, "
        "perfbench.loops.train, perfbench.loops.train_ddp, "
        "perfbench.control\n"
        "import dfvod_tpu_torch.serve, dfvod_tpu_torch.models.temporal, "
        "dfvod_tpu_torch.train.engine, dfvod_tpu_torch.ops.quant\n"
        "import perfbench.reference.model, perfbench.reference.train, "
        "perfbench.reference.latefusion")
    assert "dfvod_tpu_torch" in tops
    assert not tops & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_port():
    tops = loaded_after("import perfbench.reference.model, "
                        "perfbench.reference.train, "
                        "perfbench.reference.latefusion")
    assert "dfvod_tpu_torch" not in tops
    assert not tops & set(FORBIDDEN)


def test_the_run_guard_compares_whole_names():
    from perfbench.harness import cell
    sys.modules["dfvod_tpu_torch_like"] = sys
    try:
        assert cell.forbidden_modules() == []
        sys.modules["dfvod_tpu.fake"] = sys
        assert cell.forbidden_modules() == ["dfvod_tpu.fake"]
    finally:
        sys.modules.pop("dfvod_tpu_torch_like", None)
        sys.modules.pop("dfvod_tpu.fake", None)
