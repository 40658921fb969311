"""Batch planning and the overlapped batch plane.

Replaces the reference's three barrier phases (all preprocess, then all
inference, then all postprocess; reference main.c:116-155) over fixed batches
with:

  * shape-bucketed batch assembly: prompts are grouped by (seq bucket, label
    bucket), so every device step has one of a few shapes;
  * software pipelining: tokenization of the next chunk overlaps device
    execution of the dispatched batches (asynchronous CUDA launches);
  * one retry per failed batch, then a recorded :class:`BatchFailure` for its
    texts while the rest of the job completes (on a multi-rank mesh no
    retry: see :func:`_retry_batch`);
  * for serving, :class:`StreamingScheduler`: continuous batching of
    requests from many threads over the same planning and dispatch.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..config import RuntimeConfig
from ..engine import InferenceEngine
from ..prompting import pack_prompt
from ..tokenization import POOL_MIN_TEXTS, AffixEncoder, EncodeTask, PromptTokenizer, TokenizedBatch
from ..utils import metrics
from ..utils.metrics import StageTimer


@dataclass
class PlannedBatch:
    indices: list[int]  # positions in the original request order
    batch: TokenizedBatch
    max_labels: int


def plan_batches(
    tokenizer: PromptTokenizer,
    prompts: Sequence[str],
    label_counts: Sequence[int],
    runtime: RuntimeConfig,
) -> list[PlannedBatch]:
    """Tokenize all prompts and group them into shape-bucketed batches of at
    most ``runtime.batch_size``; each batch carries its original indices."""
    enc = tokenizer.encode_batch_parallel(
        prompts, max_length=runtime.max_length, pad_to=None,
        chunk_size=128, workers=runtime.effective_tokenizer_workers(),
    )
    return plan_from_encoded(tokenizer, enc, label_counts, runtime)


def plan_from_encoded(
    tokenizer: PromptTokenizer,
    enc: TokenizedBatch,
    label_counts: Sequence[int],
    runtime: RuntimeConfig,
) -> list[PlannedBatch]:
    """Bucket/assembly half of :func:`plan_batches` for encoded prompts."""
    n = len(label_counts)
    buckets: dict[tuple[int, int], list[int]] = {}
    for i in range(n):
        sb = runtime.bucket_for_seq(int(enc.lengths[i]))
        lb = runtime.bucket_for_labels(label_counts[i])
        buckets.setdefault((sb, lb), []).append(i)

    planned: list[PlannedBatch] = []
    for (sb, lb), idxs in sorted(buckets.items()):
        for k in range(0, len(idxs), runtime.batch_size):
            chunk = idxs[k : k + runtime.batch_size]
            ids = np.full((len(chunk), sb), tokenizer.pad_token_id, dtype=np.int32)
            mask = np.zeros((len(chunk), sb), dtype=np.int32)
            lens = np.zeros((len(chunk),), dtype=np.int32)
            for row, i in enumerate(chunk):
                L = min(int(enc.lengths[i]), sb)
                ids[row, :L] = enc.input_ids[i, :L]
                mask[row, :L] = 1
                lens[row] = L
            planned.append(PlannedBatch(chunk, TokenizedBatch(ids, mask, lens), lb))
    return planned


@dataclass
class BatchFailure:
    """One planned batch that failed after its retry: its texts' probability
    rows stay 0 and the rest of the job is valid."""

    indices: list[int]  # original request positions
    error: str

    def to_dict(self) -> dict:
        return {"indices": list(self.indices), "error": self.error}


# At most this many same-shape batches go into one stacked launch.
_MAX_STACK = 16


def run_planned(
    engine: InferenceEngine,
    planned: Sequence[PlannedBatch],
    num_requests: int,
    max_label_count: int,
    failures: list[BatchFailure] | None = None,
) -> np.ndarray:
    """Execute planned batches asynchronously; demux into request order.

    Returns probs [num_requests, max_label_count] (f32); slots beyond each
    request's label count are 0. A launch that fails is decomposed and each
    of its batches retried once alone; if the retry fails too, a
    :class:`BatchFailure` is appended to ``failures`` (or, with
    ``failures=None``, the error propagates)."""
    out = np.zeros((num_requests, max_label_count), dtype=np.float32)
    in_flight = dispatch_planned(engine, planned, out, max_label_count, failures)
    _drain_in_flight(engine, in_flight, out, max_label_count, failures)
    return out


def dispatch_planned(
    engine: InferenceEngine,
    planned: Sequence[PlannedBatch],
    out: np.ndarray,
    max_label_count: int,
    failures: list[BatchFailure] | None,
) -> "list[_InFlight]":
    """Dispatch phase of :func:`run_planned`: stack-grouped launches, no
    waiting. Only batches of identical row count stack (padding a tail batch
    to a full one would cost a whole extra step)."""
    in_flight: list[_InFlight] = []
    groups: dict[tuple[int, int, int], list[PlannedBatch]] = {}
    for pb in planned:
        key = (pb.batch.seq_length, pb.max_labels, pb.batch.batch_size)
        groups.setdefault(key, []).append(pb)
    for (_, max_labels, _), pbs in sorted(groups.items()):
        for c0 in range(0, len(pbs), _MAX_STACK):
            _dispatch_launch(
                engine, pbs[c0 : c0 + _MAX_STACK], max_labels, out,
                max_label_count, failures, in_flight,
            )
    return in_flight


def _dispatch_launch(
    engine: InferenceEngine,
    pbs: list[PlannedBatch],
    max_labels: int,
    out: np.ndarray,
    max_label_count: int,
    failures: list[BatchFailure] | None,
    in_flight: "list[_InFlight]",
) -> None:
    """Dispatch 1..n same-shape batches as one launch (stacked when n > 1).
    A failed dispatch gives each batch the one-retry treatment."""
    if len(pbs) == 1:
        pb = pbs[0]
        try:
            dev, n = engine.run_async(pb.batch, pb.max_labels)
        except Exception as e:
            _retry_batch(engine, pb, e, out, max_label_count, failures)
            return
        in_flight.append(_InFlight([pb], dev, [n]))
        return
    ids, mask, rows = engine.stack_batches([pb.batch for pb in pbs])
    try:
        dev = engine.run_stacked_async(ids, mask, max_labels)
    except Exception as e:
        for pb in pbs:
            _retry_batch(engine, pb, e, out, max_label_count, failures)
        return
    in_flight.append(_InFlight(pbs, dev, rows))


def _scatter(pb: PlannedBatch, probs: np.ndarray, out: np.ndarray, max_label_count: int) -> None:
    width = min(pb.max_labels, max_label_count)
    out[np.asarray(pb.indices), :width] = probs[:, :width]


def _retry_batch(
    engine: InferenceEngine,
    pb: PlannedBatch,
    first_error: Exception,
    out: np.ndarray,
    max_label_count: int,
    failures: list[BatchFailure] | None,
) -> None:
    """One synchronous retry; on a second failure record a BatchFailure (or
    re-raise when there is no failure list).

    On a multi-rank mesh a failed batch is not retried: its texts get the
    error at once. A retry is a forward of its own, and the streaming
    scheduler would issue it from the drainer thread while the dispatcher
    issues the next round's: every rank must run the mesh's forwards, and
    their collectives, in one order, so only the dispatcher issues any."""
    if engine.mesh.size > 1:
        if failures is None:
            raise first_error
        failures.append(BatchFailure(
            pb.indices, f"{type(first_error).__name__}: {first_error} (no retry on a {engine.mesh.size}-rank mesh)"))
        return
    try:
        _scatter(pb, engine.run(pb.batch, pb.max_labels), out, max_label_count)
    except Exception as retry_error:
        if failures is None:
            raise
        failures.append(
            BatchFailure(
                pb.indices,
                f"{type(first_error).__name__}: {first_error} "
                f"(retry: {type(retry_error).__name__}: {retry_error})",
            )
        )


@dataclass
class _InFlight:
    """One dispatched launch: a single batch (dev [B, L]) or a stacked group
    (dev [nb, B0, L]); ``rows`` holds each batch's valid row count."""

    pbs: list[PlannedBatch]
    dev: Any
    rows: list[int]

    @property
    def stacked(self) -> bool:
        return len(self.pbs) > 1


def _drain_in_flight(
    engine: InferenceEngine,
    in_flight: list[_InFlight],
    out: np.ndarray,
    max_label_count: int,
    failures: list[BatchFailure] | None,
) -> None:
    """Collect dispatched launches into ``out`` (request order)."""

    def drain_one(fl: _InFlight) -> None:
        try:
            probs = fl.dev.cpu().numpy()
        except Exception as e:
            for pb in fl.pbs:
                _retry_batch(engine, pb, e, out, max_label_count, failures)
            return
        if fl.stacked:
            for i, pb in enumerate(fl.pbs):
                _scatter(pb, probs[i, : fl.rows[i]], out, max_label_count)
        else:
            _scatter(fl.pbs[0], probs[: fl.rows[0]], out, max_label_count)

    if len(in_flight) <= 1:
        for fl in in_flight:
            drain_one(fl)
        return
    # One device-side concat and a single transfer instead of one per launch.
    # Width padding is semantics-free: padded label slots are exactly 0.
    wmax = max(fl.dev.shape[-1] for fl in in_flight)
    try:
        padded = []
        for fl in in_flight:
            dev = fl.dev.reshape(-1, fl.dev.shape[-1])
            if dev.shape[-1] != wmax:
                dev = torch.nn.functional.pad(dev, (0, wmax - dev.shape[-1]))
            padded.append(dev)
        flat = torch.cat(padded, dim=0).cpu().numpy()
    except Exception:
        # The single transfer hides which launch failed: drain one by one so
        # the fault is isolated and retried alone.
        for fl in in_flight:
            drain_one(fl)
        return
    row = 0
    for fl in in_flight:
        if fl.stacked:
            B0 = fl.dev.shape[1]
            for i, pb in enumerate(fl.pbs):
                _scatter(pb, flat[row + i * B0 : row + i * B0 + fl.rows[i]], out, max_label_count)
            row += len(fl.pbs) * B0
        else:
            _scatter(fl.pbs[0], flat[row : row + fl.rows[0]], out, max_label_count)
            row += fl.dev.shape[0]


def plan_and_run_overlapped(
    engine: InferenceEngine,
    tokenizer: PromptTokenizer,
    label_counts: Sequence[int],
    runtime: RuntimeConfig,
    num_requests: int,
    max_label_count: int,
    chunk_task: Callable[[int, int], EncodeTask],
    chunk: int = 256,
    failures: list[BatchFailure] | None = None,
    timer=None,
) -> np.ndarray:
    """Tokenize-and-dispatch pipeline: bucketed batches go to the device as
    soon as they fill, while a producer thread brings the next chunk.

    ``chunk_task(lo, hi)``: the encode of requests lo..hi as an
    :data:`~..tokenization.EncodeTask`. A call of at least
    :data:`~..tokenization.POOL_MIN_TEXTS` requests whose tokenizer has a
    pool (``PromptTokenizer.pool``: the port's own reader) runs the tasks
    there, ``runtime.effective_tokenizer_workers()`` processes off the
    interpreter lock that this thread's launches need: chunks of a batch
    over the workers (at least 16 requests), so that they fill a job's
    first batch together, at most ``2 * workers`` of them outstanding,
    consumed in order. Smaller calls run them on the producer thread in
    chunks of 64, 128, then ``chunk``. Either way rows fill each (seq,
    labels) bucket in request order, so every forward holds the same rows.

    Every arrival dispatches all ready batches of its shape key as one
    launch (capped at ``_MAX_STACK``); the partial tail batch of each key
    launches alone at the end. ``timer`` receives the host-side attribution
    (``h_tokenize`` blocking tokenize waits, ``h_dispatch`` assembly and
    launch, ``h_drain`` device wait, transfer and demux) and counts the
    chunks (``tokenize_chunks_pooled``, ``tokenize_chunks_inline``).

    Same results as plan_batches + run_planned (same bucketing, demux and
    one-retry-then-isolate failure handling)."""
    bs = runtime.batch_size
    accum: dict[tuple[int, int], list[tuple[int, np.ndarray, int]]] = {}
    ready: dict[tuple[int, int], list[PlannedBatch]] = {}
    in_flight: list[_InFlight] = []
    out = np.zeros((num_requests, max_label_count), dtype=np.float32)
    timer = timer if timer is not None else StageTimer()
    pool = None
    if num_requests >= POOL_MIN_TEXTS:
        pool = tokenizer.pool(runtime.effective_tokenizer_workers())
    chunk_count = "tokenize_chunks_inline" if pool is None else "tokenize_chunks_pooled"
    # The producer thread's tokenize spans hang under this call's span.
    rec = metrics.RECORDER
    parent = None if rec is None else rec.current()

    def make_pb(key: tuple[int, int], idxs_rows: list[tuple[int, np.ndarray, int]]):
        sb, lb = key
        ids = np.full((len(idxs_rows), sb), tokenizer.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(idxs_rows), sb), dtype=np.int32)
        lens = np.zeros((len(idxs_rows),), dtype=np.int32)
        idxs = []
        for row, (i, enc_row, L) in enumerate(idxs_rows):
            ids[row, :L] = enc_row[:L]
            mask[row, :L] = 1
            lens[row] = L
            idxs.append(i)
        return PlannedBatch(idxs, TokenizedBatch(ids, mask, lens), lb)

    def dispatch_ready(key: tuple[int, int]):
        pbs = ready.pop(key, [])
        if not pbs:
            return
        with timer.stage("h_dispatch"):
            for c0 in range(0, len(pbs), _MAX_STACK):
                _dispatch_launch(
                    engine, pbs[c0 : c0 + _MAX_STACK], key[1], out,
                    max_label_count, failures, in_flight,
                )

    def chunk_bounds():
        # In this thread a small first chunk reaches the device fast and
        # later chunks grow to the full ``chunk``; over the pool every chunk
        # is a batch over the workers.
        if pool is None:
            sizes, size = [s for s in (64, 128) if s < chunk], chunk
        else:
            sizes, size = [], min(chunk, max(16, -(-bs // pool.workers)))
        lo = 0
        while lo < num_requests:
            hi = min(lo + (sizes.pop(0) if sizes else size), num_requests)
            yield lo, hi
            lo = hi

    def inline_chunks():
        for lo, hi in chunk_bounds():
            yield lo, tokenizer.run(chunk_task(lo, hi))

    def pooled_chunks():
        pending: deque = deque()

        def oldest():
            lo, hi, fut = pending.popleft()
            rec = metrics.RECORDER
            if rec is None:
                return lo, pool.result(fut)[0]
            # The span is this thread's wait; the encode's own time is the
            # worker's.
            with rec.span("tokenize", texts=hi - lo, pooled=1) as sp:
                enc, worker_ms = pool.result(fut)
                sp.attrs.update(tokens=int(enc.lengths.sum()), worker_ms=round(worker_ms, 3))
            return lo, enc

        try:
            for lo, hi in chunk_bounds():
                pending.append((lo, hi, pool.submit(chunk_task(lo, hi))))
                if len(pending) == 2 * pool.workers:
                    yield oldest()
            while pending:
                yield oldest()
        finally:
            for _, _, fut in pending:
                fut.cancel()

    def encoded_chunks():
        """(chunk start, encoded chunk) stream from a producer thread. If the
        consumer exits early, the stop flag lets the producer finish instead
        of blocking on a full queue."""
        q: queue.Queue = queue.Queue(maxsize=4)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with metrics.adopted(parent):
                    for item in inline_chunks() if pool is None else pooled_chunks():
                        if not put(item):
                            return
                put(None)
            except BaseException as e:  # surfaced in the consumer
                put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            t.join()
        finally:
            stop.set()

    chunks = encoded_chunks()
    try:
        while True:
            with timer.stage("h_tokenize"):
                item = next(chunks, None)
            if item is None:
                break
            c0, enc = item
            timer.add_count(chunk_count, 1)
            touched = set()
            for j in range(len(enc.lengths)):
                i = c0 + j
                L = int(enc.lengths[j])
                key = (runtime.bucket_for_seq(L), runtime.bucket_for_labels(label_counts[i]))
                accum.setdefault(key, []).append((i, enc.input_ids[j], min(L, key[0])))
                if len(accum[key]) == bs:
                    with timer.stage("h_dispatch"):
                        ready.setdefault(key, []).append(make_pb(key, accum.pop(key)))
                    touched.add(key)
            # Batches filled within one chunk stack together; batches of
            # different chunks never wait on each other.
            for key in sorted(touched):
                dispatch_ready(key)
    finally:
        # Stops the producer (and cancels its pool tasks) when this loop
        # raises.
        chunks.close()
    for key in sorted(ready):
        dispatch_ready(key)
    for key in sorted(accum):
        with timer.stage("h_dispatch"):
            _dispatch_launch(
                engine, [make_pb(key, accum.pop(key))], key[1], out,
                max_label_count, failures, in_flight,
            )

    with timer.stage("h_drain"):
        _drain_in_flight(engine, in_flight, out, max_label_count, failures)
    return out


# ---------------------------------------------------------------------------
# Streaming (continuous batching) scheduler
# ---------------------------------------------------------------------------
@dataclass
class _Request:
    text: str
    labels: tuple[str, ...]
    prompt_first: bool
    future: Future = field(default_factory=Future)
    # With the recorder on: the submitting thread's open span (the HTTP
    # request's, which holds its id), the submit time, and the round's id.
    span: Any = None
    t_submit: int = 0
    round_id: int = 0

    @property
    def num_labels(self) -> int:
        return len(self.labels)

    @property
    def prompt(self) -> str:
        """Packed prompt, built only when the affix path cannot compose."""
        return pack_prompt(self.text, list(self.labels), self.prompt_first)


class SchedulerOverloaded(RuntimeError):
    """Raised by submit() when the bounded request queue is full: the
    backpressure signal (serving maps it to HTTP 429)."""


class SchedulerClosed(RuntimeError):
    """Raised by submit() after close(), and set on any request still queued
    at close() time, so no caller blocks on a Future that can no longer be
    fulfilled."""


def _resolve(fut: Future, result=None, error: BaseException | None = None) -> None:
    """Fulfil a request's Future exactly once. A Future the client already
    cancelled (or that a concurrent path resolved) is skipped: setting it
    would raise and fail every later request of the round."""
    if fut.done():
        return
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
    except InvalidStateError:  # cancelled between the check and the set
        pass


class StreamingScheduler:
    """Continuous-batching request scheduler for serving.

    Requests are enqueued from any thread and flow through three threads:

      1. tokenizer: collects a round (up to ``round_requests`` requests,
         waiting at most ``max_wait_ms`` for it to fill) and encodes it,
         grouped by label set, with the shared label block encoded once
         per group (:class:`~..tokenization.AffixEncoder`);
      2. dispatcher: buckets the encoded round by shape
         (:func:`plan_from_encoded`) and launches its batches without
         waiting (:func:`dispatch_planned`);
      3. drainer: waits for each round's results (:func:`_drain_in_flight`)
         and fulfils each request's Future exactly once.

    The stages overlap: one round tokenizes while the previous dispatches
    and the one before drains. ``pipeline_depth`` bounds the rounds between
    stages (and so the device memory their inputs and outputs hold).
    ``max_pending`` bounds the request queue: submit() raises
    :class:`SchedulerOverloaded` instead of queueing without limit.
    """

    # Label sets whose AffixEncoder is kept; the least recently used is
    # evicted beyond this (serving traffic usually has a handful of sets).
    _AFFIX_CACHE_MAX = 64

    def __init__(
        self,
        engine: InferenceEngine,
        tokenizer: PromptTokenizer,
        runtime: RuntimeConfig | None = None,
        max_wait_ms: float = 5.0,
        max_pending: int = 4096,
        pipeline_depth: int = 4,
        round_requests: int | None = None,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.runtime = runtime or RuntimeConfig()
        self.max_wait_s = max_wait_ms / 1e3
        # Requests per round: a round costs one tokenize call, one plan, one
        # dispatch and one drain transfer whatever its size, so bigger rounds
        # amortize that host work; under light load rounds close at
        # max_wait_ms anyway.
        self.round_requests = (
            round_requests if round_requests is not None else 8 * self.runtime.batch_size
        )
        self._q: queue.Queue[_Request | None] = queue.Queue(maxsize=max_pending)
        self._running = True
        # Orders submit()'s {check _running -> enqueue} against close(): a
        # request enqueued after close() drained the queue would never be
        # resolved.
        self._submit_lock = threading.Lock()
        self._plan_q: queue.Queue = queue.Queue(maxsize=pipeline_depth)
        self._drain_q: queue.Queue = queue.Queue(maxsize=pipeline_depth)
        self._affix_cache: OrderedDict[tuple, AffixEncoder] = OrderedDict()
        self._tokenizer_thread = threading.Thread(target=self._tokenize_loop, daemon=True)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._drainer = threading.Thread(target=self._drain_loop, daemon=True)
        self._drainer.start()
        self._thread.start()
        self._tokenizer_thread.start()

    def submit(self, text: str, labels: Sequence[str], prompt_first: bool) -> Future:
        """Returns a Future resolving to probs np.ndarray [len(labels)].

        Types are checked here, so a malformed request fails its own caller
        and not the round it would have joined."""
        if not isinstance(text, str):
            raise ValueError(f"text must be a string, got {type(text).__name__}")
        labels = tuple(labels)
        if not labels or not all(isinstance(l, str) for l in labels):
            raise ValueError("labels must be a non-empty sequence of strings")
        req = _Request(text, labels, bool(prompt_first))
        rec = metrics.RECORDER
        if rec is not None:
            req.span, req.t_submit = rec.current(), time.perf_counter_ns()
        with self._submit_lock:
            if not self._running:
                raise SchedulerClosed("scheduler is closed")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                raise SchedulerOverloaded(f"request queue full ({self._q.maxsize} pending)") from None
        return req.future

    def pending(self) -> int:
        """Current request-queue depth (approximate: it races the tokenizer)."""
        return self._q.qsize()

    def close(self):
        """Stop the threads and fail every request still in the queue.

        Rounds already past the tokenizer finish and fulfil their futures;
        queued requests get :class:`SchedulerClosed`, so callers blocked on
        ``future.result()`` wake at once."""
        with self._submit_lock:
            self._running = False
        try:
            self._q.put(None, timeout=5)
        except queue.Full:
            pass  # the tokenizer re-checks _running every round
        # Each stage's finally passes the sentinel on to the next.
        self._tokenizer_thread.join(timeout=30)
        self._thread.join(timeout=30)
        self._drainer.join(timeout=30)
        while True:
            try:
                r = self._q.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                _resolve(r.future, error=SchedulerClosed("scheduler closed"))

    # ------------------------------------------------------------------
    def _collect(self) -> list[_Request]:
        """Block for one request, then take more until the round is full or
        ``max_wait_s`` has passed."""
        first = self._q.get()
        if first is None:
            return []
        reqs = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(reqs) < self.round_requests:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                r = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if r is None:
                self._q.put(None)  # re-signal shutdown for the outer loop
                break
            reqs.append(r)
        return reqs

    def _tokenize_loop(self):
        """Stage 1: collect a round, encode it, hand it to the dispatcher.
        :meth:`_encode_round` isolates group faults; only a round-wide fault
        fails every request of the round."""
        try:
            while self._running:
                reqs = self._collect()
                if not reqs:
                    break
                rec = metrics.RECORDER
                try:
                    kept, enc = self._encode_round(reqs) if rec is None else self._encode_traced(rec, reqs)
                    if kept:
                        self._plan_q.put((kept, enc))
                except Exception as e:  # round-wide fault: keep the loop
                    for r in reqs:
                        _resolve(r.future, error=e)
        finally:
            self._plan_q.put(None)

    def _encode_traced(self, rec, reqs: "list[_Request]"):
        """:meth:`_encode_round` with the recorder on: the round gets an id,
        each request a ``queue`` span (submit to collection, under the
        submitting thread's span), and the encode a ``round_tokenize`` span."""
        rnd, t = rec.new_id(), time.perf_counter_ns()
        for r in reqs:
            r.round_id = rnd
            if r.t_submit:
                rec.add("queue", r.t_submit, t, parent=r.span, ids={"round": rnd})
        with rec.span("round_tokenize", {"round": rnd}, texts=len(reqs), requests=len({id(r.span) for r in reqs})):
            return self._encode_round(reqs)

    def _affix_encoder(self, labels: tuple, prompt_first: bool, sample_text: str) -> AffixEncoder:
        """The cached AffixEncoder of a label set, least recently used out."""
        key = (labels, prompt_first)
        enc = self._affix_cache.get(key)
        if enc is not None:
            self._affix_cache.move_to_end(key)
            return enc
        enc = AffixEncoder.for_labels(
            self.tokenizer, labels, prompt_first, self.runtime.max_length, sample_text=sample_text
        )
        self._affix_cache[key] = enc
        while len(self._affix_cache) > self._AFFIX_CACHE_MAX:
            self._affix_cache.popitem(last=False)
        return enc

    def _encode_round(self, reqs: "list[_Request]") -> "tuple[list[_Request], TokenizedBatch | None]":
        """Encode one round grouped by (labels, prompt_first): a group whose
        AffixEncoder composes exactly encodes its texts with the shared label
        block composed in; any other group packs and encodes full prompts. A
        group whose encode raises fails only its own requests. Returns the
        surviving requests and the round's TokenizedBatch in their order."""
        max_length = self.runtime.max_length
        groups: dict[tuple, list[int]] = {}
        for i, r in enumerate(reqs):
            groups.setdefault((r.labels, r.prompt_first), []).append(i)

        parts: list[tuple[list[int], TokenizedBatch]] = []
        for (labels, pf), idxs in groups.items():
            try:
                texts = [reqs[i].text for i in idxs]
                enc = self._affix_encoder(labels, pf, texts[0])
                if enc.exact:
                    tb = enc.encode_batch(texts, max_length)
                else:
                    tb = self.tokenizer.encode_batch(
                        [reqs[i].prompt for i in idxs], max_length, pad_to=None
                    )
                parts.append((idxs, tb))
            except Exception as e:  # isolate: fail only this group
                for i in idxs:
                    _resolve(reqs[i].future, error=e)

        if not parts:
            return [], None
        if len(parts) == 1:
            idxs, tb = parts[0]
            return [reqs[i] for i in idxs], tb
        order = [i for idxs, _ in parts for i in idxs]
        pos = {req_i: row for row, req_i in enumerate(order)}
        n = len(order)
        target = max(tb.seq_length for _, tb in parts)
        ids = np.full((n, target), self.tokenizer.pad_token_id, dtype=np.int32)
        mask = np.zeros((n, target), dtype=np.int32)
        lengths = np.zeros((n,), dtype=np.int32)
        for idxs, tb in parts:
            L = tb.seq_length
            rows = np.asarray([pos[i] for i in idxs])
            ids[rows, :L] = tb.input_ids
            mask[rows, :L] = tb.attention_mask
            lengths[rows] = tb.lengths
        return [reqs[i] for i in order], TokenizedBatch(ids, mask, lengths)

    def _loop(self):
        """Stage 2: bucket, assemble and dispatch a round; hand it on to the
        drainer."""
        try:
            while True:
                item = self._plan_q.get()
                if item is None:
                    break
                reqs, enc = item
                rec = metrics.RECORDER
                try:
                    if rec is None:
                        work = self._dispatch_round(reqs, enc)
                    else:
                        with rec.span("dispatch", {"round": reqs[0].round_id}, texts=len(reqs)) as sp:
                            work = self._dispatch_round(reqs, enc)
                            sp.attrs["forwards"] = sum(len(fl.pbs) for fl in work[-1])
                    self._drain_q.put(work)
                except Exception as e:  # fail this round, keep the loop
                    for r in reqs:
                        _resolve(r.future, error=e)
        finally:
            self._drain_q.put(None)

    def _dispatch_round(self, reqs: "list[_Request]", enc: TokenizedBatch) -> tuple:
        """Bucket, assemble and launch one round; returns the drainer's item."""
        planned = plan_from_encoded(self.tokenizer, enc, [r.num_labels for r in reqs], self.runtime)
        maxw = max(r.num_labels for r in reqs)
        failures: list[BatchFailure] = []
        out = np.zeros((len(reqs), maxw), dtype=np.float32)
        in_flight = dispatch_planned(self.engine, planned, out, maxw, failures)
        return reqs, out, maxw, failures, in_flight

    def _drain_loop(self):
        """Stage 3: wait for each round's results and fulfil its futures
        exactly once; only the requests of a batch that failed after its
        retry get an error."""
        while True:
            item = self._drain_q.get()
            if item is None:
                break
            reqs, out, maxw, failures, in_flight = item
            rec = metrics.RECORDER
            sp = None if rec is None else rec.open(
                "drain", {"round": reqs[0].round_id}, forwards=sum(len(fl.pbs) for fl in in_flight))
            try:
                _drain_in_flight(self.engine, in_flight, out, maxw, failures)
                failed = {i: f.error for f in failures for i in f.indices}
                for i, r in enumerate(reqs):
                    if i in failed:
                        _resolve(r.future, error=RuntimeError(failed[i]))
                    else:
                        _resolve(r.future, out[i, : r.num_labels])
            except Exception as e:  # fail every request of the round
                for r in reqs:
                    _resolve(r.future, error=e)
            finally:
                if sp is not None:
                    rec.close(sp)
