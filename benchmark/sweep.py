"""Find a serving cell's knee: its traffic at a ladder of offered rates,
one window each, in one process with one set-up.

    python3 benchmark/sweep.py --workload base-serve-steady --seed 7 --seconds 15 --rates 20,40,60

Prints one JSON line per rate: requests/s and texts/s offered and answered
within the window, p50/p95 (nearest rank, from each request's due time;
a failed request counts as missing), failures and how late the sends ran.
The knee is the highest rate at which the answered texts/s equal the offered
and p95 stays flat; the cell's traffic file carries 0.8 of it.
"""

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="requests/s, comma-separated")
    args = ap.parse_args()

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload, os.getcwd())
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    with tempfile.TemporaryDirectory(prefix="gliclass-sweep-") as workdir:
        st = harness.prepare(cell, args.seed, args.seconds, torch.device("cuda"), workdir, log)
        try:
            for k, rate in enumerate(float(r) for r in args.rates.split(",")):
                traffic = dict(cell.traffic, rate_rps=rate)
                reqs = harness.make_requests(st.maker, traffic, args.seed, args.seconds, 100 + k)
                w = harness.serve_window(st.prog, st.gen, reqs, args.seconds, float(traffic["answer_timeout_s"]))
                lat = w.work["latencies_s"]
                print(json.dumps({
                    "rate_rps": rate, "requests": w.work["requests"], "failed": w.work["failed"],
                    "texts_offered_per_s": w.work["texts_sent"] / args.seconds,
                    "texts_answered_per_s": w.work["texts_done"] / args.seconds,
                    "p50_ms": harness.nearest_rank(lat, 0.5) * 1e3, "p95_ms": harness.nearest_rank(lat, 0.95) * 1e3,
                    "late_max_ms": w.work["late"]["late_max_s"] * 1e3,
                }), flush=True)
        finally:
            st.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
