"""One benchmark cell with the program's span recorder on: its traced run
read by ``benchmark/program_trace.py``, and the recorder's cost.

    python3 scripts/trace_layers.py --workload large-job-long --seed 7 --seconds 51 --trace 1 --cost 3

from the root of a checkout, on a CUDA card. The cell is built from the seed
as ``benchmark/run.py`` builds it (``benchmark/harness.py``), then:

* ``--cost N``: 2N untraced windows in turns, the recorder off, on, on, off,
  off, on, ... (the profiler off throughout); each job window runs jobs of
  its own (the tokenizer's caches stay as cold as in one benchmark run).
  Prints each window's ``job_texts_per_s`` or serving p95;
* ``--trace 1``: one window traced as a ``--trace 1`` run traces it
  (``tracing.Instruments`` and ``tracing.profile_window``), with the
  recorder on. Prints the benchmark's per-layer metrics of the cell, the
  six metrics of ``program_trace.METRICS`` that read the cell's kind, the
  checks of the reduction (forward spans and their real rows against the
  ``Instruments`` records, the two clock anchors, the kernels mapped to a
  launch, K1 and K2 launched only inside forwards), the idle gaps and
  device time by program span, and ``fwd_host_ms`` split by whether a
  ``tokenize`` span was open on another thread.

The last line of standard output is the result as one JSON object; it is
also written to ``benchmark_out/<workload>.trace_layers.json``, beside the
trace.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _log(s: str) -> None:
    print(s, file=sys.stderr, flush=True)


def window(st, cell, seed: int, seconds: float, k: int):
    """Window ``k`` of the run: fresh jobs (``k`` > 0) or a schedule of its own."""
    from benchmark import harness

    traffic = cell.traffic
    if traffic["kind"] == "job":
        jobs = st.jobs if k == 0 else [harness.make_job(st.maker, traffic, seed, 10 ** 4 * k + j)
                                       for j in range(16)]  # more than a window of large-job-long runs
        return harness.job_window(st.prog, jobs, seconds, seed, int(traffic["check_per_job"]))
    reqs = st.requests if k == 0 else harness.make_requests(st.maker, traffic, seed, seconds, 1 + k)
    return harness.serve_window(st.prog, st.gen, reqs, seconds, float(traffic["answer_timeout_s"]))


def reading(cell, win) -> float:
    from benchmark import harness

    if cell.traffic["kind"] == "job":
        return win.work["texts"] / win.seconds
    return 1e3 * harness.nearest_rank(win.work["latencies_s"], 0.95)


def cost(st, cell, seed: int, seconds: float, n: int) -> dict:
    """``n`` windows each with the recorder off and on, in turns."""
    from gliclass.c_tpu_torch.utils import metrics

    out: dict = {"off": [], "on": [], "spans_per_window": []}
    for k in range(2 * n):
        on = (k % 4) in (1, 2)
        if on:
            metrics.start()
        win = window(st, cell, seed, seconds, k + 1)
        if on:
            out["spans_per_window"].append(len(metrics.stop().spans))
        out["on" if on else "off"].append(reading(cell, win))
        _log(f"cost: window {k} recorder {'on' if on else 'off'}: {out['on' if on else 'off'][-1]:.3f}")
    out["unit"] = "texts/s" if cell.traffic["kind"] == "job" else "p95 ms"
    out["median_off"], out["median_on"] = statistics.median(out["off"]), statistics.median(out["on"])
    return out


def traced(st, cell, seed: int, seconds: float, device) -> dict:
    from benchmark import harness, program_trace, tracing
    from benchmark.peaks import peaks_for
    from gliclass.c_tpu_torch.utils import metrics

    import torch

    kind = cell.traffic["kind"]
    path = os.path.join(harness.OUT_DIR, f"{cell.name}.program.trace.json")
    os.makedirs(harness.OUT_DIR, exist_ok=True)
    metrics.start()
    inst = tracing.Instruments()
    inst.install(st.prog.engine, st.prog.pipeline, st.prog.server)
    try:
        with tracing.profile_window(device, path) as tinfo:
            win = window(st, cell, seed, seconds, 0)
    finally:
        inst.remove()
        rec = metrics.stop()
    t = time.perf_counter()
    red = tracing.reduce_trace(path, tinfo["markers"], inst.spans)
    pred = program_trace.reduce_program(path, tinfo["markers"], rec.spans, rec.threads, rec.clock)
    _log(f"trace: {len(rec.spans)} program spans; read in {time.perf_counter() - t:.1f} s")
    peaks = peaks_for(torch.cuda.get_device_name(0))
    rrec = harness.RunRecord(kind, cell.config["model"], win.seconds, win.work, inst.forwards, red, peaks)
    out: dict = {"benchmark": {m["name"]: harness._reader(cell.metric_dir, m["name"])(rrec) for m in cell.per_layer},
                 "busy_s": red["busy_s"] if red else None, "window_s": red["window_s"] if red else None}
    if not pred or "forwards" not in pred:
        out["program"] = pred
        _log(f"trace: the reduction found {pred}: no runtime calls or no marker launch in the device trace")
        return out
    out["metrics"] = {name: fn(pred, peaks) for name, (kinds, fn) in program_trace.METRICS.items() if kind in kinds}
    fw = pred["forwards"]
    split = {}
    for key, sel in (("tokenize_open", True), ("tokenize_closed", False)):
        hs = [f["host_s"] for f in fw if f["tokenize_open"] == sel]
        split[key] = [len(hs), 1e3 * sum(hs) / len(hs) if hs else None]
    out["fwd_host_ms_by_tokenize"] = split
    out["checks"] = {
        "forwards": [len(fw), len(inst.forwards)],
        "real_rows": [sum(f["real_rows"] for f in fw), sum(f["real_rows"] for f in inst.forwards)],
        "offsets_us": pred["offsets_us"], "drift_us": pred["drift_us"],
        "wallclock_offset_us": pred["wallclock_offset_us"],
        "kernels_mapped": [pred["kernels_mapped"], pred["kernels"]],
        "k1_k2_outside_forward": [pred["forward_kernels_outside"], pred["forward_kernels"]],
        "runtime_calls": pred["runtime_calls"], "calls_off_span_threads": pred["calls_off_span_threads"],
        "threads_matched_by_time": pred["threads_matched_by_time"],
        "forward_threads": {n: rec.threads[n] & 0xFFFFFFFF for n in {s.tid for s in rec.spans if s.name == "forward"}},
        "w8a8_spans_with_kernels": [pred["w8a8"]["with_kernels"], len(pred["w8a8"]["shapes"])],
    }
    out["syncs_s_per_fwd"] = sum(f["sync_s"] for f in fw) / len(fw) if fw else None
    out["idle_by_span"] = sorted(pred["idle_by_span"].items(), key=lambda kv: -kv[1])[:12]
    out["device_by_span"] = sorted(pred["device_by_span"].items(), key=lambda kv: -kv[1])[:12]
    _log("trace: idle by program span " + "; ".join(f"{n} {s:.3f} s" for n, s in out["idle_by_span"]))
    _log(f"trace: fwd_host_ms with a tokenize span open elsewhere {split['tokenize_open']}, "
         f"with none {split['tokenize_closed']} ([forwards, ms])")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--cost", type=int, default=0, help="windows each with the recorder off and on")
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        _log("trace_layers.py: no CUDA card")
        return 2
    device = torch.device("cuda")
    cell = harness.load_cell(args.workload, ROOT)
    result: dict = {"workload": cell.name, "seed": args.seed, "device": torch.cuda.get_device_name(0)}
    with tempfile.TemporaryDirectory(prefix="gliclass-trace-") as workdir:
        st = harness.prepare(cell, args.seed, args.seconds, device, workdir, _log)
        try:
            if args.cost:
                result["cost"] = cost(st, cell, args.seed, args.seconds, args.cost)
            if args.trace:
                result["trace"] = traced(st, cell, args.seed, args.seconds, device)
        finally:
            st.close()
    line = json.dumps(result)
    os.makedirs(harness.OUT_DIR, exist_ok=True)
    out = os.path.join(harness.OUT_DIR, f"{cell.name}.trace_layers.json")
    with open(out, "w") as f:
        f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
