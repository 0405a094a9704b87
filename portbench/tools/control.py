#!/usr/bin/env python3
"""The readings that set a cell's limits, on the card at the cell's own
size (the benchmark's own runs never run this):

    python portbench/tools/control.py --workload <cell> --seeds 1 2 3
    python portbench/tools/control.py --workload <cell> --seeds 1 ... 12 --sound

control: the plain reference put in the program's place, computed in the
  precision below the configuration's (TF32 on, against float32 with TF32
  off), and held to the reference as a run holds the program;
faults: planted in the program under a short run of the cell: a decode
  cell's wavefront decode with one latent symbol altered; a training
  cell's step that returns its state unchanged (it reads 1 by the
  measure, and is run all the same) and, with more than one slot, a loss
  that leaves out half of the batch and takes the mean over the rest;
sound (--sound): the program's own readings, a short run of the cell a
  seed in one process.
Prints one JSON line per (seed, reading).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import faults, harness, inputs, yardstick  # noqa: E402
from portbench.kinds import decode as kdec  # noqa: E402
from portbench.kinds import train as ktrain  # noqa: E402
from portbench.reference import decode as rdec  # noqa: E402


def decode_control(run) -> dict:
    pool = [str(inputs.DATA / p) for p in inputs.pool(run.spec["pool"])]
    files = next(kdec.call_files(pool, run.spec["batch"], run.seed))
    datas = [open(f, "rb").read() for f in files]
    f32 = rdec.decode_files(datas, device=run.device)
    tf32 = rdec.decode_files(datas, device=run.device, tf32=True)
    return kdec.compare(tf32, f32)


def train_control(run) -> dict:
    import torch

    x = ktrain.make_inputs(run)
    G, n_check, phase = x["G"], run.spec["check_steps"], x["phase"]
    noise = ktrain.SeedNoise(run.seed + 1, run.device, keep=1 + n_check)
    level = torch.full((G,), x["noise0"], dtype=torch.float32, device=run.device)
    for _ in range(1 + n_check):
        noise("step", x["fcfg"], G, phase["quantizer_noise_type"], level, True)
    pf = phase["precondition_frequency"]
    f32 = ktrain.reference_runs(x, noise.kept, n_check, pf)
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = ktrain.reference_runs(x, noise.kept, n_check, pf)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    prog = {"losses": [[r["losses"][0] for r in tf32]],
            "first": {p: [r["first_grad"][p] for r in tf32] for p in tf32[0]["first_grad"]},
            "change": {p: [r["change"][p] for r in tf32] for p in tf32[0]["change"]}}
    return ktrain.readings(prog, f32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sound", action="store_true",
                    help="instead: the program's own readings, a run of the cell a seed")
    args = ap.parse_args()
    if args.sound:
        for seed in args.seeds:
            res = harness.run_cell(args.workload, seed, args.seconds, False, "cuda:0")
            print(json.dumps({"seed": seed, "reading": "sound", "correct": res["correct"],
                              **{k: c["value"] for k, c in res["checks"].items()}}), flush=True)
        return 0
    bench = harness.benchmark()
    cell = harness.cell_entry(bench, args.workload)
    spec = json.loads((harness.PB / "workloads" / f"{args.workload}.json").read_text())
    kind = spec["kind"]
    planted = ([("altered_symbol", faults.altered_symbol)] if kind == "decode" else
               [("state_unchanged", faults.state_unchanged)]
               + ([("half_batch", faults.half_batch)] if spec["batch"] > 1 else []))
    print(json.dumps({"card": yardstick.card_line()}), flush=True)
    for seed in args.seeds:
        run = harness.Run(spec=spec, config=yardstick.load_config(cell["config"]), seed=seed,
                          seconds=args.seconds, trace=False, device="cuda:0")
        got = decode_control(run) if kind == "decode" else train_control(run)
        print(json.dumps({"seed": seed, "reading": "control_tf32", **got}), flush=True)
        for name, fault in planted:
            with fault():
                res = harness.run_cell(args.workload, seed, args.seconds, False, "cuda:0")
            print(json.dumps({"seed": seed, "reading": name, "correct": res["correct"],
                              **{k: c["value"] for k, c in res["checks"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
