"""One run of one cell: set-up from the seed, the measured window, the check
of what the window produced, and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``. Everything that
belongs to it is found by name: its configuration's file (``configs/``),
its traffic mix (``traffic/<traffic>.json``), the limits of its correctness
check (``limits/<workload>.json``) and a reader for each of its per-layer
metrics (``metrics/<metric>.py``, a ``read(run)`` that returns a number or
None). Two kinds of traffic exist: ``job`` (``classify_job`` on jobs back to
back) and ``serve`` (``GLiClassServer`` under an open-loop HTTP load from
its own process, ``loadgen.py``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import compare, textgen, tracing, weights
from .peaks import peaks_for

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT_DIR = os.path.join(ROOT, "benchmark_out")

FORBIDDEN = ("jax", "jaxlib", "flax")


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules of JAX or of the JAX package: a top-level name in
    :data:`FORBIDDEN`, or first two parts exactly ``gliclass.c_tpu`` (whole
    names: ``gliclass.c_tpu_torch`` is the program)."""
    out = []
    for name in (sys.modules if names is None else names):
        parts = name.split(".")
        if parts[0] in FORBIDDEN or parts[:2] == ["gliclass", "c_tpu"]:
            out.append(name)
    return sorted(out)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    metric_dir: str = os.path.join(HERE, "metrics")


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    wl = [w for w in spec["workloads"] if w["name"] == name]
    if not wl:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    wl = wl[0]
    entry = [c for c in spec["configs"] if c["name"] == wl["config"]][0]
    bench = os.path.join(root, "benchmark")
    config = _read_json(os.path.join(root, entry["file"]))
    traffic = _read_json(os.path.join(bench, "traffic", wl["traffic"] + ".json"))
    limits = _read_json(os.path.join(bench, "limits", name + ".json"))
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if ((name in m["workloads"]) if "workloads" in m else (m["moves"] in e2e_names))]
    return Cell(name, config, traffic, limits, e2e, per_layer, os.path.join(bench, "metrics"))


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# --------------------------------------------------------------- the program
@dataclass
class Program:
    """The system under test, built from the seed."""

    engine: object
    tokenizer: object
    runtime: object
    pipeline: object = None
    server: object = None
    tokenizer_path: str = ""
    checksum: float = 0.0
    lexicon: textgen.Lexicon | None = None


def runtime_config(config: dict):
    from gliclass.c_tpu_torch.config import RuntimeConfig

    rt = dict(config["runtime"])
    rt["seq_buckets"] = tuple(rt["seq_buckets"])
    return RuntimeConfig(**rt)


def build_program(cell: Cell, seed: int, device: torch.device, workdir: str, log) -> Program:
    from gliclass.c_tpu_torch.config import GLiClassConfig
    from gliclass.c_tpu_torch.engine import InferenceEngine
    from gliclass.c_tpu_torch.ops.quant import quantize_tree
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    t = time.perf_counter()
    lex = textgen.Lexicon(seed, cell.config["tokenizer"])
    tok_path = os.path.join(workdir, "tokenizer.json")
    sha = textgen.write_tokenizer(lex, tok_path)
    log(f"tokenizer.json sha256 {sha} (made in {time.perf_counter() - t:.2f} s)")
    t = time.perf_counter()
    tok = PromptTokenizer.from_file(tok_path)
    log(f"set-up: the program read tokenizer.json in {time.perf_counter() - t:.2f} s")
    model = dict(cell.config["model"], class_token_index=tok.label_token_id, text_token_index=tok.sep_token_id)
    cfg = GLiClassConfig.from_dict(model)
    rt = runtime_config(cell.config)
    t = time.perf_counter()
    raw = weights.make_weights(cell.config["model"], cell.config["init"], seed, device)
    check = weights.checksum(raw)
    host = _to_numpy(raw)
    del raw
    log(f"set-up: weights made on {device.type} in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    params = quantize_tree(host) if rt.quant_mode in ("int8", "int8-dynamic") else host
    del host
    log(f"set-up: the program quantized them in {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    engine = InferenceEngine(cfg, params, rt, device=device)
    del params
    log(f"set-up: the engine took them in {time.perf_counter() - t:.2f} s")
    return Program(engine, tok, rt, tokenizer_path=tok_path, checksum=check, lexicon=lex)


def _to_numpy(tree):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in tree.items()}


def warm_buckets(cell: Cell, rt, label_counts) -> tuple[list[int], list[int]]:
    """The (seq buckets, label buckets) the cell's traffic can reach."""
    words = cell.traffic["words"]
    least = 2 + 2 * min(label_counts) + 1 + int(words["min"])
    lo = rt.bucket_for_seq(min(least, rt.max_length))
    seqs = [b for b in rt.seq_buckets if b >= lo]
    return seqs, sorted({rt.bucket_for_labels(n) for n in label_counts})


# ------------------------------------------------------------------- traffic
def make_job(maker: textgen.TextMaker, traffic: dict, seed: int, k: int):
    """Job ``k`` of the seed: ``texts_per_job`` texts under one shared label
    set of ``labels_per_job`` labels."""
    from gliclass.c_tpu_torch.data import ClassificationJob

    rng = textgen.rng_for(seed, 10, k)
    n = int(traffic["texts_per_job"])
    texts = maker.texts(rng, textgen.stratified(traffic["words"], n, rng))
    labels = (tuple(maker.labels(textgen.rng_for(seed, 11, k), int(traffic["labels_per_job"]))),)
    return ClassificationJob(tuple(texts), labels, True, traffic["classification_type"])


def make_requests(maker: textgen.TextMaker, traffic: dict, seed: int, seconds: float, tag: int):
    """The open-loop schedule: [(due_s, {"texts", "labels", ...})], with
    ``rate_rps * seconds`` requests. Gaps, request sizes, label-set choices
    and words per text are stratified draws in the order of the traffic's
    fixed ``schedule_seed`` (the tail of a queue depends on the order of its
    arrivals, and every seed gets the same); the words and labels are the
    run's seed's."""
    rate = float(traffic["rate_rps"])
    n = max(1, int(round(rate * seconds)))
    sched = textgen.rng_for(int(traffic["schedule_seed"]), 20, tag)
    u = (np.arange(n) + 0.5) / n
    gaps = sched.permutation(-np.log1p(-u) / rate)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    sizes = textgen.stratified(traffic["texts_per_request"], n, sched)
    shares = np.asarray(traffic["label_set_shares"], dtype=float)
    per_set = np.floor(shares / shares.sum() * n).astype(int)
    per_set[0] += n - per_set.sum()
    which = sched.permutation(np.repeat(np.arange(len(per_set)), per_set))
    words = textgen.stratified(traffic["words"], int(sizes.sum()), sched)
    set_rng = textgen.rng_for(seed, 21)
    label_sets = [maker.labels(set_rng, int(m)) for m in traffic["label_sets"]]
    texts = maker.texts(textgen.rng_for(seed, 20, tag), words)
    out, pos = [], 0
    for i in range(n):
        body = {"texts": texts[pos:pos + sizes[i]], "labels": label_sets[which[i]],
                "classification_type": traffic["classification_type"], "threshold": traffic["threshold"]}
        pos += int(sizes[i])
        out.append((float(due[i]), body))
    return out


# ------------------------------------------------------------------- windows
@dataclass
class Window:
    seconds: float = 0.0
    work: dict = field(default_factory=dict)
    # What the check compares: jobs, (text, labels, p, decided, echo ok) of
    # each job's sampled texts; serving, ((due, body), record) a request.
    answers: list = field(default_factory=list)


def job_window(prog: Program, jobs: list, seconds: float, seed: int, per_job: int, log=None) -> Window:
    """Jobs back to back until ``seconds`` have passed, each to its end.
    Of each job only what the check reads is kept (its longest text and
    ``per_job`` more drawn from the seed), so the window's heap stays flat.
    A job of the pool run a second time (the program outran the traffic
    file's ``pool_jobs``) is counted in ``reused_jobs``: its words would
    meet the tokenizer's caches warm, so the check fails the run."""
    t0 = time.perf_counter()
    kept, timings, texts, failed, k = [], [], 0, 0, 0
    while True:
        job = jobs[k % len(jobs)]
        t = time.perf_counter()
        out = prog.pipeline.classify_job(job)
        if log:
            log(f"window: job {k} of {job.num_texts} texts in {time.perf_counter() - t:.3f} s")
        texts += job.num_texts
        failed += len(out.failed_indices)
        timings.append(out.timings)
        longest = max(range(job.num_texts), key=lambda i: len(job.texts[i]))
        pick = textgen.rng_for(seed, 31, k).choice(job.num_texts, size=min(per_job, job.num_texts), replace=False)
        for i in [longest] + [int(i) for i in pick if i != longest]:
            r = out.results[i]
            labels = list(job.labels_for(i))
            kept.append((job.texts[i], labels, out.probs[i, :len(labels)].astype(np.float64),
                         {d.index for d in r.decisions}, r.text_index == i and r.text == job.texts[i]))
        del out
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    w = Window(seconds=time.perf_counter() - t0)
    w.work = {"jobs": k, "texts": texts, "failed": failed, "reused_jobs": max(0, k - len(jobs)), "timings": timings}
    w.answers = kept
    return w


class LoadGen:
    """The load generator's process (``loadgen.py``)."""

    def __init__(self):
        self.proc = subprocess.Popen([sys.executable, os.path.join(HERE, "loadgen.py")],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def run(self, port: int, requests: list, timeout_s: float, lead_s: float = 0.5) -> tuple[float, dict]:
        start = time.monotonic() + lead_s
        bodies = [(d, json.dumps(b).encode()) for d, b in requests]
        pickle.dump({"host": "127.0.0.1", "port": port, "start": start, "requests": bodies,
                     "timeout_s": timeout_s}, self.proc.stdin)
        self.proc.stdin.flush()
        return start, pickle.load(self.proc.stdout)

    def close(self) -> None:
        self.proc.stdin.close()
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def serve_window(prog: Program, gen: LoadGen, requests: list, seconds: float, timeout_s: float) -> Window:
    start, reply = gen.run(prog.server.port, requests, timeout_s)
    recs = reply["records"]
    end = start + seconds
    # A request that failed or got no answer counts as answered at the
    # generator's deadline: later than any answer that came.
    deadline = start + max(d for d, _ in requests) + timeout_s
    lat, texts_done, failed = [], 0, 0
    for (due, sent, done, status, _), (_, body) in zip(recs, requests):
        if status == 200 and done is not None:
            lat.append(done - due)
            if done <= end:
                texts_done += len(body["texts"])
        else:
            lat.append(deadline - due)
            failed += 1
    w = Window(seconds=seconds)
    w.work = {"requests": len(recs), "failed": failed, "texts_done": texts_done,
              "texts_sent": sum(len(b["texts"]) for _, b in requests),
              "latencies_s": lat, "late": reply["late"]}
    w.answers = list(zip(requests, recs))
    return w


def nearest_rank(values: list, p: float) -> float:
    v = sorted(values)
    return v[max(0, min(len(v) - 1, math.ceil(p * len(v)) - 1))]


# ----------------------------------------------------------------- the run
@dataclass
class Setup:
    """A built and warmed program with the traffic of one run."""

    prog: Program
    maker: textgen.TextMaker
    jobs: list = field(default_factory=list)
    requests: list = field(default_factory=list)
    gen: LoadGen | None = None

    def close(self) -> None:
        if self.gen is not None:
            self.gen.close()
        if self.prog.server is not None:
            self.prog.server.close()


def prepare(cell: Cell, seed: int, seconds: float, device, workdir: str, log, warm: bool = True,
            fault=None) -> Setup:
    """Build the program from the seed, make the run's traffic and warm up
    the shapes it uses (``fault``: a function applied to the built program,
    for the tests that break it on purpose)."""
    prog = build_program(cell, seed, device, workdir, log)
    st = Setup(prog, textgen.TextMaker(prog.lexicon, cell.traffic, seed))
    try:
        if cell.traffic["kind"] == "job":
            from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline

            prog.pipeline = ZeroShotClassificationPipeline(prog.engine, prog.tokenizer, prog.runtime)
            label_counts = [int(cell.traffic["labels_per_job"])]
            st.jobs = [make_job(st.maker, cell.traffic, seed, k) for k in range(int(cell.traffic["pool_jobs"]))]
        else:
            from gliclass.c_tpu_torch.serving import GLiClassServer

            prog.server = GLiClassServer(prog.engine, prog.tokenizer, prog.runtime, port=0)
            prog.server.start()
            label_counts = list(cell.traffic["label_sets"])
            st.requests = make_requests(st.maker, cell.traffic, seed, seconds, 0)
            st.gen = LoadGen()
        if fault is not None:
            fault(prog)
        if warm:
            seqs, labs = warm_buckets(cell, prog.runtime, label_counts)
            t = time.perf_counter()
            steps = prog.engine.warmup(seq_buckets=seqs, label_buckets=labs)
            log(f"warm-up: {steps} engine steps over seq buckets {seqs}, label buckets {labs} "
                f"in {time.perf_counter() - t:.2f} s")
            t = time.perf_counter()
            if st.gen is None:
                prog.pipeline.classify_job(make_job(st.maker, cell.traffic, seed, 10 ** 6))
            else:
                warm_reqs = make_requests(st.maker, cell.traffic, seed, float(cell.traffic["warmup_s"]), 1)
                st.gen.run(prog.server.port, warm_reqs, timeout_s=60.0)
            log(f"warm-up: traffic in {time.perf_counter() - t:.2f} s")
    except BaseException:
        st.close()
        raise
    return st


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device | None = None,
        t_start: float | None = None, log=None, warm: bool = True, control: bool = False,
        fault=None) -> dict:
    """One run; returns the result line's object (``warm``: warm up first;
    ``control``: add the control's readings; ``fault``: as :func:`prepare`)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    device = device or torch.device("cuda")
    cuda = device.type == "cuda"
    kind = cell.traffic["kind"]
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="gliclass-bench-") as workdir:
        st = prepare(cell, seed, seconds, device, workdir, log, warm=warm, fault=fault)
        try:
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            setup_s = time.perf_counter() - t_start
            inst = red = None
            if trace:
                inst = tracing.Instruments()
                inst.install(st.prog.engine, st.prog.pipeline, st.prog.server)
                trace_path = os.path.join(OUT_DIR, f"{cell.name}.trace.json")
                with tracing.profile_window(device, trace_path) as tinfo:
                    win = _window(st, seconds, cell, seed, log)
                inst.remove()
                t = time.perf_counter()
                red = tracing.reduce_trace(trace_path, tinfo["markers"], inst.spans)
                log(f"trace: written in {tinfo['export_s']:.1f} s, read in {time.perf_counter() - t:.1f} s")
            else:
                win = _window(st, seconds, cell, seed, log)
            peak = torch.cuda.max_memory_allocated() if cuda else 0
            if kind == "serve":
                late = win.work["late"]
                log(f"loadgen: {win.work['requests']} requests in {seconds} s, sends late by at most "
                    f"{late['late_max_s'] * 1e3:.3f} ms (p99 {late['late_p99_s'] * 1e3:.3f} ms); "
                    f"p95 {nearest_rank(win.work['latencies_s'], 0.95) * 1e3:.3f} ms")
        finally:
            st.close()
        tok_path, fingerprint = st.prog.tokenizer_path, st.prog.checksum
        st = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks, readings, compared = compare.check(cell, seed, win, tok_path, fingerprint, device, control)
        log(f"check: {compared} (text, label) logits compared against the reference")
    result = _result(cell, kind, win, setup_s, trace, red, inst, peak, device, checks)
    if control:
        result["control"] = readings
    return result


def _window(st: Setup, seconds: float, cell: Cell, seed: int, log) -> Window:
    if st.gen is None:
        return job_window(st.prog, st.jobs, seconds, seed, int(cell.traffic["check_per_job"]), log)
    return serve_window(st.prog, st.gen, st.requests, seconds, float(cell.traffic["answer_timeout_s"]))


@dataclass
class RunRecord:
    """What a per-layer metric's reader reads."""

    kind: str
    model: dict
    window_s: float
    work: dict
    forwards: list
    trace: dict | None
    peaks: dict | None


def _result(cell, kind, win, setup_s, trace, red, inst, peak, device, checks) -> dict:
    cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    metrics: dict = {}
    if not trace:
        values = {"setup_s": setup_s}
        if kind == "job":
            values["job_texts_per_s"] = win.work["texts"] / win.seconds
        else:
            values["serve_p95_ms"] = nearest_rank(win.work["latencies_s"], 0.95) * 1e3
            values["serve_texts_per_s"] = win.work["texts_done"] / win.seconds
        for m in cell.end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        rec = RunRecord(kind, cell.config["model"], win.seconds, win.work,
                        inst.forwards if inst else [], red, peaks_for(name))
        for m in cell.per_layer:
            v = _reader(cell.metric_dir, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = win.work["texts"] if kind == "job" else win.work["requests"]
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": 1 if cuda else 0,
           "memory_peak_bytes": int(peak)}
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": attempted, "failed": win.work["failed"], "metrics": metrics, "device": dev}
    if trace and red is not None:
        dev["busy_s"], dev["window_s"] = red["busy_s"], red["window_s"]
        out["breakdown"] = tracing.breakdown(red)
    out["checks"] = checks
    return out


def _reader(metric_dir: str, name: str):
    path = os.path.join(metric_dir, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
