"""Readings for a cell's correctness limits: the program's on many seeds,
and the control's (the reference at 4-bit weights and activations in the
program's place) on the same samples.

    python3 benchmark/calibrate.py --workload large-job-long --seeds 1,2,3 --seconds 3 --control-seeds 1,2,3

Each seed builds its cell anew (weights, tokenizer, engine) without the
warm-up, runs a short window at the cell's own load and sizes, and prints
one JSON line: the numbers compared and, on a control seed, the control's.
The lower reading of a number is the largest the program gives, the upper
the smallest the control gives (``compare.py``).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload, os.getcwd())
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(cell, seed, args.seconds, False, torch.device("cuda"), warm=False,
                          control=seed in controls)
        line = {"seed": seed, "correct": out["correct"], "attempted": out["attempted"],
                "program": {k: c["value"] for k, c in out["checks"].items()}, "control": out.get("control")}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
