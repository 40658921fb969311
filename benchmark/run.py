"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload large-job-long --seed 7 --seconds 40 --trace 0

from the root of a checkout (it reads ``BENCHMARK.json`` there). It builds
everything from the seed, warms up, measures for ``--seconds``, checks what
the window produced against the plain reference, and prints as the last
line of its standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``checks``, each number compared with its limit (also the last lines
of standard error). It exits non-zero, printing no result, without a CUDA
card, when JAX or the JAX package was loaded, or on any failure.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload, os.getcwd())
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("run.py: no CUDA card", file=sys.stderr)
        return 2
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
