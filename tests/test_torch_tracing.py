"""The port's span recorder (``utils.metrics``) on the CPU: off it records
nothing; on, a tiny w8a8 ``classify_job`` gives the span tree job → stages
→ forward → w8a8_linear (and the producer thread's tokenize spans under the
job's stage) with the shapes and counts of what ran; a request through a
tiny ``GLiClassServer`` gives request, parse, queue and respond spans under
one request id and its round's spans under the round id its queue spans
name; ``/metrics`` times a request by its span; and ``utils.metrics.trace``
puts the program's forward around the profiler's ops of that forward."""

import json
import math
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from gliclass.c_tpu_torch.config import BackboneConfig, GLiClassConfig, RuntimeConfig
from gliclass.c_tpu_torch.data import ClassificationJob
from gliclass.c_tpu_torch.engine import InferenceEngine
from gliclass.c_tpu_torch.models.gliclass import init_gliclass_params
from gliclass.c_tpu_torch.ops import layers
from gliclass.c_tpu_torch.ops.quant import quantize_tree
from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline
from gliclass.c_tpu_torch.serving import GLiClassServer
from gliclass.c_tpu_torch.tokenization import PromptTokenizer
from gliclass.c_tpu_torch.utils import metrics

RT = dict(batch_size=4, max_length=64, compute_dtype="bfloat16", quant_mode="int8-dynamic",
          seq_buckets=(16, 32, 64), label_buckets=(2, 4, 8))
BB = dict(model_type="deberta-v2", vocab_size=600, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=64, max_position_embeddings=64,
          position_buckets=16, norm_rel_ebd="layer_norm", share_att_key=True,
          position_biased_input=False)
WORDS = "market team vote virus film rain city price game law".split()


@pytest.fixture(scope="module")
def model(tiny_tokenizer_file):
    """(port tokenizer, a w8a8 bf16 engine on the CPU)."""
    tok = PromptTokenizer.from_file(tiny_tokenizer_file)
    cfg = GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                         text_token_index=tok.sep_token_id, prompt_first=True,
                         backbone=BackboneConfig(**BB))
    params = init_gliclass_params(torch.Generator().manual_seed(0), cfg)
    params = quantize_tree(_numpy(params))
    return tok, InferenceEngine(cfg, params, RuntimeConfig(**RT), device="cpu")


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _texts(n, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(" ".join(rng.choice(WORDS, size=int(rng.integers(3, 30)))) for _ in range(n))


@pytest.fixture
def recorder():
    rec = metrics.start()
    try:
        yield rec
    finally:
        metrics.stop()


def _post(port, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/classify", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _wait_requests(srv, n):
    """The handler records a request after its response is written: wait
    until ``n`` are recorded."""
    deadline = time.monotonic() + 30
    while srv.metrics.requests < n:
        assert time.monotonic() < deadline, "the server never recorded the requests"
        time.sleep(0.01)


def test_recorder_off_records_nothing(model, monkeypatch):
    tok, engine = model
    made = []

    class Counted(metrics.Span):
        __slots__ = ()

        def __init__(self, *a):
            made.append(a[0])
            super().__init__(*a)

    monkeypatch.setattr(metrics, "Span", Counted)
    assert metrics.RECORDER is None
    pipe = ZeroShotClassificationPipeline(engine, tok)
    out = pipe.classify_job(ClassificationJob(_texts(6), (("sport", "politics"),), True, "multi-label"))
    assert out.probs.shape == (6, 2) and out.timings["total_s"] > 0
    srv = GLiClassServer(engine, tok, host="127.0.0.1", port=0)
    srv.start()
    try:
        _post(srv.port, {"texts": list(_texts(2)), "labels": ["a", "b"]})
        _wait_requests(srv, 1)
    finally:
        srv.close()
    assert made == [] and metrics.RECORDER is None


def test_job_spans_parents_and_counts(model, recorder, monkeypatch):
    tok, engine = model
    steps, products = [], []
    step = engine._step

    def counted_step(ids, mask, max_labels, dev_inputs=None):
        steps.append(np.asarray(mask).copy())
        return step(ids, mask, max_labels, dev_inputs)

    w8a8 = layers._linear_w8a8

    def counted_w8a8(p, x, group=None):
        products.append((x.numel() // x.shape[-1], x.shape[-1], p["w_q"].shape[1]))
        return w8a8(p, x, group)

    monkeypatch.setattr(engine, "_step", counted_step)
    monkeypatch.setattr(layers, "_linear_w8a8", counted_w8a8)
    texts = _texts(11, seed=1)
    out = ZeroShotClassificationPipeline(engine, tok).classify_job(
        ClassificationJob(texts, (("sport", "politics", "weather"),), True, "multi-label"))
    spans = list(recorder.spans)
    by_id = {s.sid: s for s in spans}
    (job,) = [s for s in spans if s.name == "job"]
    assert job.attrs == {"texts": 11} and set(job.ids) == {"job"} and job.parent == 0

    def parent(s):
        return by_id[s.parent]

    stage = {s.name: s for s in spans if s.name in ("tokenize_device", "decide")}
    assert {parent(s).name for s in stage.values()} == {"job"}
    for name in ("h_tokenize", "h_dispatch", "h_drain"):
        assert {parent(s).sid for s in spans if s.name == name} == {stage["tokenize_device"].sid}
    tokenize = [s for s in spans if s.name == "tokenize"]
    assert tokenize and {parent(s).sid for s in tokenize} == {stage["tokenize_device"].sid}
    assert {s.tid for s in tokenize} != {job.tid}  # the producer thread
    assert sum(s.attrs["texts"] for s in tokenize) == 11
    forwards = [s for s in spans if s.name == "forward"]
    assert len(forwards) == len(steps) > 0
    assert {parent(s).name for s in forwards} == {"h_dispatch"}
    per_row = [m.sum(axis=1) for m in steps]
    assert sum(s.attrs["real_rows"] for s in forwards) == sum(int((r > 1).sum()) for r in per_row) == 11
    assert sorted(s.attrs["real_tokens"] for s in forwards) == sorted(int(r[r > 1].sum()) for r in per_row)
    assert sorted((s.attrs["rows"], s.attrs["seq"]) for s in forwards) == sorted(m.shape for m in steps)
    assert sum(s.attrs["tokens"] for s in tokenize) == sum(s.attrs["real_tokens"] for s in forwards)
    assert all(s.attrs["k1"] == 0 and s.attrs["k2"] == 0 for s in forwards)  # no kernel on the CPU
    linears = [s for s in spans if s.name == "w8a8_linear"]
    assert [(s.attrs["m"], s.attrs["k"], s.attrs["n"]) for s in sorted(linears, key=lambda s: s.t0)] == products
    assert products and {parent(s).name for s in linears} == {"forward"}
    assert all(s.ids == job.ids for s in forwards + linears + tokenize)
    stages = ("tokenize_device", "h_tokenize", "h_dispatch", "h_drain", "decide")
    assert {k for k in out.timings if k.endswith("_s")} == {f"{n}_s" for n in stages} | {"total_s", "texts_per_s"}
    for name in stages:  # to_dict rounds to the µs
        got = sum(s.t1 - s.t0 for s in spans if s.name == name) / 1e9
        assert math.isclose(out.timings[f"{name}_s"], got, abs_tol=1e-6), name


def test_server_request_spans_share_ids(model, recorder):
    tok, engine = model
    srv = GLiClassServer(engine, tok, host="127.0.0.1", port=0)
    srv.start()
    try:
        bodies = [{"texts": list(_texts(n, seed=n)), "labels": ["a", "b", "c"]} for n in (1, 3, 2)]
        threads = [threading.Thread(target=_post, args=(srv.port, b)) for b in bodies]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        assert not any(t.is_alive() for t in threads)
        _wait_requests(srv, 3)
    finally:
        srv.close()
    spans = list(recorder.spans)
    requests = [s for s in spans if s.name == "request"]
    assert sorted(s.attrs["texts"] for s in requests) == [1, 2, 3]
    assert {s.attrs["status"] for s in requests} == {200}
    rounds = set()
    for req in requests:
        rid = req.ids["request"]
        mine = [s for s in spans if s.ids.get("request") == rid and s is not req]
        assert sorted(s.name for s in mine if s.name != "queue") == ["parse", "respond"]
        assert {s.parent for s in mine} == {req.sid}
        queue = [s for s in mine if s.name == "queue"]
        assert len(queue) == req.attrs["texts"] and {s.tid for s in queue} == {0}
        assert all(req.t0 <= s.t0 <= s.t1 <= req.t1 for s in mine)
        rounds |= {s.ids["round"] for s in queue}
    for rnd in rounds:
        named = {s.name for s in spans if s.ids.get("round") == rnd and "request" not in s.ids}
        assert {"round_tokenize", "dispatch", "drain", "forward", "w8a8_linear"} <= named
        (dispatch,) = [s for s in spans if s.name == "dispatch" and s.ids["round"] == rnd]
        fwd = [s for s in spans if s.name == "forward" and s.ids.get("round") == rnd]
        assert len(fwd) == dispatch.attrs["forwards"] and {s.parent for s in fwd} == {dispatch.sid}


def test_metrics_latency_is_the_request_span(model, recorder):
    tok, engine = model
    srv = GLiClassServer(engine, tok, host="127.0.0.1", port=0)
    srv.start()
    try:
        _post(srv.port, {"texts": list(_texts(2)), "labels": ["a", "b"]})
        _wait_requests(srv, 1)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=10) as r:
            lat = json.loads(r.read())["latency"]
    finally:
        srv.close()
    (req,) = [s for s in recorder.spans if s.name == "request"]
    assert lat["count"] == 1 and lat["p50_ms"] == round((req.t1 - req.t0) / 1e6, 3)


def test_trace_puts_forward_around_its_ops(model, tmp_path):
    tok, engine = model
    ids = np.full((4, 16), tok.pad_token_id, dtype=np.int32)
    mask = np.zeros((4, 16), dtype=np.int32)
    mask[:, :5] = 1
    engine._step(ids, mask, 2)  # the first call's one-time work stays out of the trace
    with metrics.trace(str(tmp_path)):
        torch.ones(3).add(1)
        engine._step(ids, mask, 2)
        torch.ones(3).mul(2)
    assert metrics.RECORDER is None
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (fwd,) = [e for e in events if e.get("cat") == "gliclass" and e["name"] == "forward"]
    ops = sorted((e for e in events if e.get("cat") == "cpu_op" and e.get("tid") == fwd["tid"]),
                 key=lambda e: e["ts"])
    # The block's first add ends before the forward, its last ones starts after it.
    before = [e["ts"] + e["dur"] for e in ops if e["name"] == "aten::add"][0]
    after = [e["ts"] for e in ops if e["name"] == "aten::ones"][-1]
    inside = [e for e in ops if before <= e["ts"] and e["ts"] + e["dur"] <= after]
    assert any(e["name"] == "aten::_int_mm" for e in inside)
    assert before <= fwd["ts"] and fwd["ts"] + fwd["dur"] <= after
    assert all(fwd["ts"] <= e["ts"] and e["ts"] + e["dur"] <= fwd["ts"] + fwd["dur"] for e in inside)
    assert any(e.get("cat") == "gliclass" and e["name"] == "w8a8_linear" for e in events)


def test_recorder_under_many_threads(recorder):
    """More threads than cores open nested spans at a short switch
    interval: every span is kept once, with a unique id, its own thread's
    native id and its parent on that thread."""
    import sys

    n_threads, n_spans = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with recorder.span("outer"):
                    with recorder.span("inner", k=1):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        [t.start() for t in threads]
        [t.join(timeout=60) for t in threads]
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = list(recorder.spans)
    by_id = {s.sid: s for s in spans}
    assert len(spans) == len(by_id) == 2 * n_threads * n_spans
    assert len({s.tid for s in spans}) == n_threads == len(recorder.threads)
    for s in spans:
        if s.name == "inner":
            outer = by_id[s.parent]
            assert outer.name == "outer" and outer.tid == s.tid and outer.t0 <= s.t0 <= s.t1 <= outer.t1
        else:
            assert s.parent == 0
