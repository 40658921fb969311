"""The port's HTTP server and streaming scheduler, on CPU: the contracts of
tests/test_serving.py held against ``gliclass.c_tpu_torch``, its scores
against the JAX server's on the same parameters (fp32 1e-5), and the three
repairs the port carries (a cancelled future, LRU eviction of the affix
encoders; the SIGTERM shutdown is in tests/test_torch_cli.py).

Every HTTP call and thread join has its own timeout."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from gliclass.c_tpu import config as jcfg
from gliclass.c_tpu.engine import InferenceEngine as JEngine
from gliclass.c_tpu.models.gliclass import init_gliclass_params
from gliclass.c_tpu.serving import GLiClassServer as JServer
from gliclass.c_tpu.tokenization import PromptTokenizer as JTokenizer
from gliclass.c_tpu_torch import tokenization as tkz
from gliclass.c_tpu_torch.config import BackboneConfig, GLiClassConfig, RuntimeConfig
from gliclass.c_tpu_torch.engine import InferenceEngine
from gliclass.c_tpu_torch.parallel.scheduler import SchedulerClosed, StreamingScheduler
from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline
from gliclass.c_tpu_torch.serving import MAX_BODY_BYTES, GLiClassServer, ServingMetrics
from gliclass.c_tpu_torch.tokenization import PromptTokenizer

RT = dict(batch_size=4, max_length=64, compute_dtype="float32",
          seq_buckets=(16, 32, 64), label_buckets=(2, 4, 8))
BB = dict(model_type="deberta-v2", vocab_size=600, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=64, max_position_embeddings=64,
          position_buckets=16, norm_rel_ebd="layer_norm", share_att_key=True,
          position_biased_input=False)


def _cfg(pkg_cfg, tok):
    return pkg_cfg.GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                                  text_token_index=tok.sep_token_id, prompt_first=True,
                                  backbone=pkg_cfg.BackboneConfig(**BB))


@pytest.fixture(scope="module")
def model(tiny_tokenizer_file):
    """(numpy params, port tokenizer, port engine on the CPU)."""
    tok = PromptTokenizer.from_file(tiny_tokenizer_file)
    jc = _cfg(jcfg, tok)
    params = jax.tree.map(np.asarray, init_gliclass_params(jax.random.key(0), jc))
    cfg = GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                         text_token_index=tok.sep_token_id, prompt_first=True,
                         backbone=BackboneConfig(**BB))
    return params, tok, InferenceEngine(cfg, params, RuntimeConfig(**RT), device="cpu")


@pytest.fixture(scope="module")
def server(model):
    _, tok, engine = model
    srv = GLiClassServer(engine, tok, RuntimeConfig(**RT), host="127.0.0.1", port=0)
    srv.start()
    yield srv, ZeroShotClassificationPipeline(engine, tok, RuntimeConfig(**RT))
    srv.close()


def _post(port, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/classify", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return json.loads(r.read())


def _scores(result):
    return {d["label"]: d["score"] for d in result["decisions"]}


def test_healthz(server):
    assert _get(server[0].port, "/healthz")["status"] == "ok"


def test_classify_matches_pipeline(server):
    srv, pipe = server
    texts = ["the quick brown fox", "open source model", "running dog races"]
    labels = ["science", "sports", "format", "question"]
    out = _post(srv.port, {"texts": texts, "labels": labels,
                           "classification_type": "multi-label", "threshold": 0.0})
    ref = pipe(texts, labels, "multi-label", threshold=0.0)
    assert len(out["results"]) == len(texts)
    for got, want in zip(out["results"], ref):
        w = want.to_dict()
        assert got["text"] == w["text"]
        gs, ws = _scores(got), _scores(w)
        assert set(gs) == set(ws)
        np.testing.assert_allclose([gs[l] for l in ws], list(ws.values()), atol=1e-5)


def test_classify_matches_jax_server(model, tiny_tokenizer_file):
    """The port's server and the JAX package's, on the same parameters, give
    the same decisions and scores (fp32 1e-5)."""
    params, tok, engine = model
    jtok = JTokenizer.from_file(tiny_tokenizer_file)
    jengine = JEngine(_cfg(jcfg, jtok), params, jcfg.RuntimeConfig(**RT))
    jsrv = JServer(jengine, jtok, jcfg.RuntimeConfig(**RT), host="127.0.0.1", port=0)
    tsrv = GLiClassServer(engine, tok, RuntimeConfig(**RT), host="127.0.0.1", port=0)
    jsrv.start()
    tsrv.start()
    try:
        for body in (
            {"texts": ["the quick brown fox", "why are you running", "support ukraine"],
             "labels": ["science", "sports", "format", "question"], "threshold": 0.0},
            {"texts": ["alpha beta", "gamma delta"], "labels": [["a", "b"], ["c", "d", "e"]],
             "classification_type": "single-label"},
        ):
            want, got = _post(jsrv.port, body), _post(tsrv.port, body)
            assert len(got["results"]) == len(want["results"])
            for g, w in zip(got["results"], want["results"]):
                assert (g["text_index"], g["text"]) == (w["text_index"], w["text"])
                assert [(d["label"], d["index"]) for d in g["decisions"]] == [
                    (d["label"], d["index"]) for d in w["decisions"]]
                np.testing.assert_allclose([d["score"] for d in g["decisions"]],
                                           [d["score"] for d in w["decisions"]], atol=1e-5, rtol=1e-5)
    finally:
        tsrv.close()
        jsrv.close()


def test_single_text_and_single_label_mode(server):
    out = _post(server[0].port, {"text": "the quick brown fox", "labels": ["science", "sports"],
                                 "classification_type": "single-label"})
    assert len(out["results"]) == 1
    assert len(out["results"][0]["decisions"]) == 1


def test_per_text_labels(server):
    out = _post(server[0].port, {"texts": ["alpha beta", "gamma delta"],
                                 "labels": [["a", "b"], ["c", "d", "e"]], "threshold": 0.0})
    assert [len(r["decisions"]) for r in out["results"]] == [2, 3]


def test_concurrent_requests_each_answered_once(server):
    srv, _ = server
    results = [None] * 8

    def worker(i):
        results[i] = _post(srv.port, {"texts": [f"text number {i}"], "labels": ["a", "b", "c"],
                                      "threshold": 0.0})

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    [t.start() for t in threads]
    [t.join(timeout=120) for t in threads]
    assert not any(t.is_alive() for t in threads)
    for i, r in enumerate(results):
        assert r is not None and len(r["results"]) == 1
        assert r["results"][0]["text"] == f"text number {i}"


def test_burst_of_simultaneous_connections_all_answered(server):
    """64 clients connect at the same instant: every one is answered (the
    listen backlog holds the burst instead of resetting connections)."""
    srv, _ = server
    assert srv.httpd.request_queue_size >= 64
    codes, barrier = [], threading.Barrier(64)

    def client():
        barrier.wait(timeout=30)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz", timeout=30) as r:
            codes.append(r.status)

    threads = [threading.Thread(target=client) for _ in range(64)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert not any(t.is_alive() for t in threads)
    assert codes == [200] * 64


@pytest.mark.parametrize("payload", [
    {"labels": ["a"]},                                   # no texts
    {"texts": ["x"], "labels": []},                      # empty labels
    {"texts": ["x", "y"], "labels": [["a"]]},            # count mismatch
    {"texts": ["x"], "labels": ["a"], "classification_type": "nope"},
    {"texts": ["x"], "labels": [f"label{i}" for i in range(26)]},  # beyond max_num_classes
])
def test_bad_requests_400(server, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server[0].port, payload)
    assert e.value.code == 400
    assert "error" in json.loads(e.value.read())


def test_oversized_body_rejected_413(server):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server[0].port}/classify", data=b"x",
        headers={"Content-Type": "application/json", "Content-Length": str(MAX_BODY_BYTES + 1)},
        method="POST",
    )
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 413


def test_metrics(server):
    srv, _ = server
    _post(srv.port, {"texts": ["x"], "labels": ["a", "b"]})
    with pytest.raises(urllib.error.HTTPError):
        _post(srv.port, {"labels": ["a"]})
    m = _get(srv.port, "/metrics")
    assert m["requests"] > 0 and m["texts"] > 0 and m["errors"] >= 1
    lat = m["latency"]
    assert lat["count"] > 0
    assert 0 < lat["p50_ms"] <= lat["p95_ms"] <= lat["p99_ms"]
    assert m["queue_depth"] >= 0


def test_metrics_percentiles_nearest_rank():
    m = ServingMetrics()
    m.record(texts=1, latency_s=0.010)
    m.record(texts=1, latency_s=0.100)
    lat = m.to_dict()["latency"]
    assert (lat["count"], lat["p50_ms"], lat["p99_ms"]) == (2, 10.0, 100.0)
    m.record(texts=1, latency_s=0.050)
    assert m.to_dict()["latency"]["p50_ms"] == 50.0


def test_load_no_request_lost_or_doubled_under_pressure(model):
    """N threads x M requests against a tiny bounded queue: every request
    gets exactly one terminal answer (200 with its own text, or 429/503)
    and none hangs."""
    _, tok, engine = model
    srv = GLiClassServer(engine, tok, RuntimeConfig(**RT), host="127.0.0.1", port=0,
                         max_pending=8, result_timeout_s=60)
    srv.start()
    N, M = 6, 5
    outcomes = {}
    lock = threading.Lock()

    def worker(t):
        for m in range(M):
            key = f"req {t} {m}"
            try:
                r = _post(srv.port, {"texts": [key], "labels": ["a", "b"], "threshold": 0.0})
                code = 200 if (len(r["results"]) == 1 and r["results"][0]["text"] == key) else -1
            except urllib.error.HTTPError as e:
                code = e.code
            with lock:
                assert key not in outcomes, f"double answer for {key}"
                outcomes[key] = code

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(N)]
    [t.start() for t in threads]
    [t.join(timeout=120) for t in threads]
    assert not any(t.is_alive() for t in threads), "a request hung"
    m = _get(srv.port, "/metrics")
    srv.close()
    assert len(outcomes) == N * M
    assert all(c in (200, 429, 503) for c in outcomes.values()), outcomes
    served = sum(c == 200 for c in outcomes.values())
    assert served >= 1 and m["latency"]["count"] >= 1
    assert m["latency"]["p95_ms"] >= m["latency"]["p50_ms"] > 0


def test_close_wakes_blocked_callers_fast(model):
    _, tok, engine = model
    sched = StreamingScheduler(engine, tok, RuntimeConfig(**RT), max_wait_ms=2000.0)
    futs = [sched.submit(f"text {i}", ["a", "b"], True) for i in range(12)]
    t0 = time.monotonic()
    sched.close()
    for f in futs:
        try:
            f.result(timeout=30)  # computed before close, or failed by it
        except SchedulerClosed:
            pass
    assert time.monotonic() - t0 < 30
    with pytest.raises(SchedulerClosed):
        sched.submit("late", ["a"], True)


def test_streaming_affix_groups_match_packed(model, monkeypatch):
    """Mixed label sets in one round give the pipeline's probabilities, on
    the affix path and with every group forced onto the packed path."""
    _, tok, engine = model
    pipe = ZeroShotClassificationPipeline(engine, tok, RuntimeConfig(**RT))
    texts = [f"fox number {i} jumps" for i in range(12)]
    label_sets = [["science", "sports"], ["format", "tool", "question"]]

    def run():
        sched = StreamingScheduler(engine, tok, RuntimeConfig(**RT), max_wait_ms=200.0)
        try:
            futs = [sched.submit(t, label_sets[i % 2], True) for i, t in enumerate(texts)]
            return [f.result(timeout=60) for f in futs], sched
        finally:
            sched.close()

    got, sched = run()
    assert all(enc.exact for enc in sched._affix_cache.values())
    for i, t in enumerate(texts):
        ref = pipe.predict_probs([t], [label_sets[i % 2]], True)[0, : len(label_sets[i % 2])]
        np.testing.assert_allclose(got[i], ref, atol=1e-5, rtol=1e-5)

    orig_init = tkz.AffixEncoder.__init__

    def inexact_init(self, *a, **k):
        orig_init(self, *a, **k)
        self.exact = False

    monkeypatch.setattr(tkz.AffixEncoder, "__init__", inexact_init)
    got2, _ = run()
    for a, b in zip(got, got2):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_submit_validates_types_and_group_faults_isolated(model, monkeypatch):
    """A malformed request fails its caller at submit(); an encode fault in
    one label-set group fails only that group's requests."""
    _, tok, engine = model
    sched = StreamingScheduler(engine, tok, RuntimeConfig(**RT), max_wait_ms=200.0)
    try:
        with pytest.raises(ValueError, match="labels"):
            sched.submit("ok text", ["a", 3], True)
        with pytest.raises(ValueError, match="text"):
            sched.submit(None, ["a"], True)
        with pytest.raises(ValueError, match="labels"):
            sched.submit("ok text", [], True)

        orig = tkz.AffixEncoder.for_labels.__func__

        def boom(cls, tokenizer, labels, pf, max_length, sample_text=None):
            if "BOOM" in labels:
                raise RuntimeError("injected tokenize fault")
            return orig(cls, tokenizer, labels, pf, max_length, sample_text)

        monkeypatch.setattr(tkz.AffixEncoder, "for_labels", classmethod(boom))
        good = [sched.submit(f"text {i}", ["science", "sports"], True) for i in range(4)]
        bad = [sched.submit(f"text {i}", ["BOOM", "sports"], True) for i in range(3)]
        for f in good:
            assert f.result(timeout=60) is not None
        for f in bad:
            with pytest.raises(RuntimeError, match="injected tokenize fault"):
                f.result(timeout=60)
    finally:
        sched.close()


def test_cancelled_future_does_not_fail_its_round(model):
    """Repair: a client that cancels its Future before the round drains must
    not fail the other requests of that round (setting a result on a
    cancelled Future raises; the JAX drainer then failed the rest)."""
    _, tok, engine = model
    sched = StreamingScheduler(engine, tok, RuntimeConfig(**RT), max_wait_ms=300.0)
    try:
        futs = [sched.submit(f"text {i}", ["a", "b"], True) for i in range(6)]
        assert futs[0].cancel()  # still queued: the round is collecting
        for f in futs[1:]:
            p = f.result(timeout=60)
            assert p.shape == (2,) and np.isfinite(p).all()
        assert futs[0].cancelled()
    finally:
        sched.close()


def test_affix_cache_evicts_least_recently_used(model, monkeypatch):
    """Repair: beyond the cache bound the least recently used label set goes,
    not the whole cache."""
    _, tok, engine = model
    monkeypatch.setattr(StreamingScheduler, "_AFFIX_CACHE_MAX", 3)
    sched = StreamingScheduler(engine, tok, RuntimeConfig(**RT), max_wait_ms=1.0)
    try:
        sets = [("a",), ("b",), ("c",), ("a",), ("d",)]  # "a" used again before "d" arrives
        for labels in sets:
            sched.submit("some text", labels, True).result(timeout=60)
        assert [k[0] for k in sched._affix_cache] == [("c",), ("a",), ("d",)]
    finally:
        sched.close()
