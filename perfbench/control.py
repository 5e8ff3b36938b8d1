"""The readings that set each cell's limits: the program on many seeds,
its lower-precision control and its planted faults, in one process.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--control int8|fp8] [--fault NAME] \
        [--train-dtype float32]

Without ``--control`` or ``--fault`` each seed is one short run of the
cell as the benchmark makes it (its check numbers). ``--control int8`` reads
the port's own int8 serving path (``ops/quant.int8_mode`` around warm-up
and window); ``--control fp8`` the reference computed in fp8 in the
program's place (a train cell's only control). ``--fault`` plants
one of ``harness/faults.py``'s faults in the program; ``--train-dtype
float32`` runs a train cell's program in f32 (TF32 off), a second witness
beside the reference. Prints one JSON
line of numbers per seed. The benchmark's own runs run none of this.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench.harness import cell as cell_mod  # noqa: E402
from perfbench.harness import faults, inputs, lowprec, spec  # noqa: E402


@torch.no_grad()
def serve_fp8_control(cell, seed, device):
    """The f32 reference computed in fp8 in the program's place: what it
    keeps and answers on the first ``check_requests`` requests of the
    pool, judged by the cell's check."""
    from perfbench.harness import weights
    from perfbench.loops import serve
    traffic, config, ref_mod = cell.traffic, cell.config, cell.reference
    pool = inputs.pool(traffic, seed, device, kind=cell.kind)
    ref = ref_mod.build(config["config"]).to(device)
    weights.load(ref, serve.draw_weights(config, seed, device, ref_mod))
    frames = ref.cfg["num_ref_frames"] + 1 if hasattr(ref, "detr") else 1
    kept, answers = {}, {}
    for i in range(traffic["check_requests"]):
        images = pool[i]["images"].to(device)
        sizes = pool[i]["sizes"].to(device)
        with lowprec.fp8():
            kept[i] = serve.forward_kept(ref, images, sizes,
                                         traffic["check_block"],
                                         ref_mod.normalize)
        sc, lab, bx = ref_mod.postprocess(*kept[i]["final"],
                                          sizes[::frames])
        answers[i] = {"scores": sc.cpu(), "labels": lab.cpu(),
                      "boxes": bx.cpu()}
    del ref
    cell_mod.free(device != "cpu")
    return serve.check(config, traffic, seed, pool, kept, answers, device,
                       frames, ref_mod)


def train_control(cell, seed, device):
    """The fp8 reference in the program's place, against the f32 one
    (over the cell's ranks' rows where its loop has several)."""
    from perfbench.loops import train
    pool = inputs.pool(cell.traffic, seed, device, kind=cell.kind)
    n = cell.traffic["check_steps"]
    args = (cell.config, seed, pool, n, device, cell.reference)
    low = train.reference_steps(*args, lowprec=lowprec.fp8,
                                ranks=cell.chips)
    cell_mod.free(device != "cpu")
    ref = train.reference_steps(*args, ranks=cell.chips)
    cell_mod.free(device != "cpu")
    emu = train.reference_steps(*args, lowprec=lowprec.bf16,
                                ranks=cell.chips)
    return train.ratios(low, emu, ref, cell.reference)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", choices=("int8", "fp8"), default=None)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--train-dtype", default=None)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    if args.train_dtype:
        # a second witness: the program at another precision (float32,
        # TF32 off, as the reference runs)
        cell.config["config"]["train_dtype"] = args.train_dtype
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    loop = cell.traffic["loop"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if args.control and cell.kind == "train":
            numbers = train_control(cell, seed, "cuda")
        elif args.control == "fp8":
            numbers = serve_fp8_control(cell, seed, "cuda")
        else:
            around = contextlib.nullcontext
            if args.control:
                from dfvod_tpu_torch.ops import quant
                around = quant.int8_mode
            fault = faults.FAULTS[loop][args.fault] if args.fault else None
            with around():
                r = cell_mod.run(cell, seed, args.seconds, False,
                                 device="cuda", faults=fault)
            numbers = {k: v["value"] for k, v in r["checks"].items()}
            numbers["correct"] = r["correct"]
        cell_mod.free(True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "train_dtype": args.train_dtype,
                          "seconds": time.perf_counter() - t0,
                          "numbers": {k: v for k, v in numbers.items()
                                      if not k.startswith("_")}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
