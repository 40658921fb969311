"""HTTP serving endpoint over the continuous-batching scheduler.

A stdlib ``ThreadingHTTPServer`` front end: every request's texts are
submitted to the :class:`~.parallel.scheduler.StreamingScheduler`, which
micro-batches concurrent requests into shape-bucketed device steps and
answers each exactly once. The JSON contract is the JAX package's
(``gliclass.c_tpu.serving``):

    POST /classify   {"texts": [...] | "text": str,
                      "labels": ["l1", ...] | [["per", "text"], ...],
                      "classification_type": "multi-label" | "single-label",
                      "threshold": float (optional)}
                  -> {"results": [{text_index, text, decisions: [
                       {label, score, index}, ...]}, ...]}
    GET  /healthz -> {"status": "ok", "model": ...}
    GET  /metrics -> {"requests", "texts", "errors", "uptime_s",
                      "latency": {count, p50_ms, p95_ms, p99_ms},
                      "queue_depth"}

Guards: bodies above MAX_BODY_BYTES get 413; a full scheduler queue
(``max_pending``) gets 429; malformed requests and label lists beyond the
bundle's ``max_num_classes`` get 400; requests caught by shutdown get 503;
an engine failure gets 500 and the server keeps serving. The listener binds
127.0.0.1 by default; for TLS, auth or public exposure put it behind a
reverse proxy.

Over a multi-rank mesh the server runs on the leading rank
(``InferenceEngine.lead``); :meth:`GLiClassServer.close` stops the
followers after the scheduler's last round.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .config import RuntimeConfig
from .engine import InferenceEngine
from .parallel.scheduler import SchedulerClosed, SchedulerOverloaded, StreamingScheduler
from .postprocess import decide_batch
from .tokenization import PromptTokenizer
from .utils import metrics

# A single oversized Content-Length must not allocate unbounded memory.
MAX_BODY_BYTES = 8 << 20


class _HTTPServer(ThreadingHTTPServer):
    # The listen backlog. With socketserver's default of 5 the kernel may
    # reset connections when more clients than that connect at once (16
    # simultaneous clients saw resets); a burst up to this many waits.
    request_queue_size = 1024


class ServingMetrics:
    """Counters and request-latency percentiles over a ring of recent
    requests. A request's latency is that of its ``request`` span: from the
    handler's entry to the response written (body read and parse, the
    scheduler, the decision and the JSON written), with the same two
    timestamps the recorder keeps when it is on."""

    _RING = 2048

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = 0
        self.texts = 0
        self.errors = 0
        self.started = time.time()
        self._lat_s: deque[float] = deque(maxlen=self._RING)

    def record(self, texts: int = 0, error: bool = False, latency_s: float | None = None):
        with self._lock:
            self.requests += 1
            self.texts += texts
            self.errors += int(error)
            if latency_s is not None:
                self._lat_s.append(latency_s)

    def _percentiles(self) -> dict:
        lat = sorted(self._lat_s)
        if not lat:
            return {"count": 0, "p50_ms": None, "p95_ms": None, "p99_ms": None}

        def pct(p: float) -> float:
            # nearest rank, ceil(p*n)-1: the p50 of two samples is the smaller
            i = min(len(lat) - 1, max(0, math.ceil(p * len(lat)) - 1))
            return round(lat[i] * 1e3, 3)

        return {"count": len(lat), "p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99)}

    def to_dict(self, queue_depth: int | None = None) -> dict:
        with self._lock:
            d = {
                "requests": self.requests,
                "texts": self.texts,
                "errors": self.errors,
                "uptime_s": round(time.time() - self.started, 1),
                "latency": self._percentiles(),
            }
        if queue_depth is not None:
            d["queue_depth"] = queue_depth
        return d


def _parse_classify(body: dict) -> tuple[list[str], list[list[str]], bool, str, float | None]:
    texts = body.get("texts")
    if texts is None and "text" in body:
        texts = [body["text"]]
    if not isinstance(texts, list) or not texts:
        raise ValueError("'texts' must be a non-empty list (or pass 'text')")
    labels = body.get("labels")
    if not isinstance(labels, list) or not labels:
        raise ValueError("'labels' must be a non-empty list")
    same_labels = isinstance(labels[0], str)
    if same_labels:
        labels = [list(labels)]
    elif len(labels) != len(texts):
        raise ValueError("per-text 'labels' must have one list per text")
    ctype = body.get("classification_type", "multi-label")
    if ctype not in ("multi-label", "single-label"):
        raise ValueError(f"unsupported classification_type: {ctype!r}")
    threshold = body.get("threshold")
    if threshold is not None:
        threshold = float(threshold)
    return texts, labels, same_labels, ctype, threshold


class GLiClassServer:
    """Owns the scheduler and the HTTP listener.

    ``port=0`` binds an ephemeral port; ``.port`` reports the bound one."""

    def __init__(
        self,
        engine: InferenceEngine,
        tokenizer: PromptTokenizer,
        runtime: RuntimeConfig | None = None,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_wait_ms: float = 5.0,
        max_pending: int = 4096,
        result_timeout_s: float = 120.0,
        pipeline_depth: int = 4,
        round_requests: int | None = None,
    ):
        self.runtime = runtime or engine.runtime
        self.engine = engine
        self.scheduler = StreamingScheduler(
            engine, tokenizer, self.runtime, max_wait_ms=max_wait_ms, max_pending=max_pending,
            pipeline_depth=pipeline_depth, round_requests=round_requests,
        )
        self.metrics = ServingMetrics()
        self.model_name = engine.cfg.original_model_name
        self.prompt_first = engine.cfg.prompt_first
        self.default_threshold = self.runtime.threshold
        self.max_num_classes = engine.cfg.max_num_classes
        self.result_timeout_s = result_timeout_s
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # /metrics replaces access lines
                pass

            def _send(self, code: int, payload: dict):
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"status": "ok", "model": server.model_name})
                elif self.path == "/metrics":
                    self._send(200, server.metrics.to_dict(queue_depth=server.scheduler.pending()))
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/classify":
                    self._send(404, {"error": "not found"})
                    return
                t0 = time.perf_counter_ns()
                rec = metrics.RECORDER
                sp = None if rec is None else rec.open("request", {"request": rec.new_id()}, t0=t0)
                code, payload = self._classify(rec)
                texts = len(payload["results"]) if code == 200 else 0
                try:
                    resp = None if rec is None else rec.open("respond")
                    self._send(code, payload)
                finally:
                    if sp is not None:
                        rec.close(resp)
                        rec.close(sp, status=code, texts=texts)
                    t1 = time.perf_counter_ns() if sp is None else sp.t1
                    server.metrics.record(texts=texts, error=code != 200,
                                          latency_s=(t1 - t0) / 1e9 if code == 200 else None)

            def _classify(self, rec) -> tuple[int, dict]:
                """The status and answer of a POST /classify; never raises."""
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > MAX_BODY_BYTES:
                        return 413, {"error": f"body exceeds {MAX_BODY_BYTES} bytes"}
                    sp = None if rec is None else rec.open("parse")
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                    finally:
                        if sp is not None:
                            rec.close(sp)
                    return 200, server.classify(body)
                except SchedulerOverloaded as e:  # backpressure: shed load
                    return 429, {"error": str(e)}
                except SchedulerClosed:
                    return 503, {"error": "server shutting down"}
                except ValueError as e:
                    return 400, {"error": str(e)}
                except Exception as e:  # engine failure: 500, keep serving
                    return 500, {"error": f"{type(e).__name__}: {e}"}

        self.httpd = _HTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def classify(self, body: dict) -> dict:
        texts, labels, same_labels, ctype, threshold = _parse_classify(body)
        counts = [len(labels[0]) if same_labels else len(labels[i]) for i in range(len(texts))]
        if max(counts) > self.max_num_classes:
            raise ValueError(
                f"{max(counts)} labels exceeds the model's max_num_classes "
                f"({self.max_num_classes}); split the label set across requests"
            )
        futs = [
            self.scheduler.submit(t, labels[0] if same_labels else labels[i], self.prompt_first)
            for i, t in enumerate(texts)
        ]
        probs = np.zeros((len(texts), max(counts)), dtype=np.float32)
        for i, f in enumerate(futs):
            p = f.result(timeout=self.result_timeout_s)
            probs[i, : len(p)] = p
        results = decide_batch(
            probs, texts, labels, same_labels, ctype,
            self.default_threshold if threshold is None else threshold,
            num_valid=counts, use_native=self.runtime.use_native_host_ops,
        )
        return {"results": [r.to_dict() for r in results]}

    # ------------------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def serve_forever(self):
        self.httpd.serve_forever()

    def close(self):
        """Stop accepting connections first, then close the scheduler, which
        fails every still-queued request (SchedulerClosed) so handler threads
        blocked in classify() wake at once instead of at result_timeout_s;
        then, as a mesh's leader, stop the followers."""
        self.httpd.shutdown()
        self.scheduler.close()
        self.engine.stop_followers()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.httpd.server_close()
