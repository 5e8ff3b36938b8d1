"""perfbench/run.py refuses to print a result without a card, and in a
checkout that holds only BENCHMARK.json and perfbench/."""
import os
import shutil
import subprocess
import sys

from perfbench.harness import spec

ARGS = ["--workload", "latefusion.serve.b32", "--seed", "3000000000",
        "--seconds", "1", "--trace", "0"]


def run(cwd, env_extra=None):
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True, env=env)


def test_no_card_no_result():
    r = run(spec.ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.PERFBENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = run(tmp_path)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
