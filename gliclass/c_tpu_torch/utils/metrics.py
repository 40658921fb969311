"""Observability: the span recorder, stage timers and the trace exporter.

The reference's entire instrumentation is one wall-clock interval printed at
exit (reference main.c:112-113,170-171). Here:

* the **recorder** (:class:`Recorder`) holds the program's spans: the job,
  its stages, each forward, each w8a8 linear, each tokenizer call, and on
  the serving path each request, its parse, queue and response, and each
  round's tokenize, dispatch and drain. It is off by default: the off state
  is :data:`RECORDER` being None, the one thing each site checks. When on,
  every span records its name, its start and end from
  ``time.perf_counter_ns()``, the native id of its thread, its own id and
  its parent's (a stack per thread; given explicitly where work crosses
  threads), the ids it belongs to (``job``, ``request``, ``round``:
  inherited from its parent) and a few integer attributes. Spans stay in
  memory until the caller takes them (:func:`stop`);
* every pipeline run carries a :class:`StageTimer` breakdown (pack /
  tokenize / device / decide, and the batch plane's ``h_*`` stages): a view
  of the same recorder, whose stages are spans when it is on;
* :func:`trace` turns the recorder on around a block traced by
  ``torch.profiler`` and writes the program's spans into the profiler's
  Chrome trace, on its clock, so one Perfetto view shows both.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from time import perf_counter_ns


class Span:
    """One recorded interval (times in ``perf_counter_ns``; ``tid`` 0 for a
    span that starts on one thread and ends on another)."""

    __slots__ = ("name", "t0", "t1", "tid", "sid", "parent", "ids", "attrs")

    def __init__(self, name, t0, t1, tid, sid, parent, ids, attrs):
        self.name, self.t0, self.t1, self.tid = name, t0, t1, tid
        self.sid, self.parent, self.ids, self.attrs = sid, parent, ids, attrs


def _ids(parent: Span | None, ids: dict | None) -> dict:
    if parent is None:
        return dict(ids) if ids else {}
    return {**parent.ids, **ids} if ids else parent.ids


class Recorder:
    """The spans of one recording; see the module docstring."""

    def __init__(self):
        self.spans: list[Span] = []
        self.threads: dict[int, int] = {}  # native thread id -> threading.get_ident()
        self.clock = [clock_pair()]  # (perf_counter_ns, time_ns) at start, and at stop
        self._next = itertools.count(1)
        self._local = threading.local()

    def new_id(self) -> int:
        """A fresh id, unique in this recording (spans, jobs, requests, rounds)."""
        return next(self._next)

    def _thread(self) -> tuple[list[Span], int]:
        """This thread's stack of open spans and its native id, read once
        (``get_native_id`` is a system call)."""
        local = self._local
        try:
            return local.stack, local.tid
        except AttributeError:
            local.stack, local.tid = [], threading.get_native_id()
            self.threads[local.tid] = threading.get_ident()
            return local.stack, local.tid

    def _stack(self) -> list[Span]:
        return self._thread()[0]

    def current(self) -> Span | None:
        """The innermost span open on this thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def open(self, name: str, ids: dict | None = None, parent: Span | None = None, t0: int | None = None,
             **attrs) -> Span:
        """Open a span on this thread, inside ``parent`` (default: the
        innermost open one); close it with :meth:`close`."""
        stack, tid = self._thread()
        if parent is None and stack:
            parent = stack[-1]
        sp = Span(name, perf_counter_ns() if t0 is None else t0, 0, tid, next(self._next),
                  parent.sid if parent is not None else 0, _ids(parent, ids), attrs)
        stack.append(sp)
        return sp

    def close(self, sp: Span, **attrs) -> None:
        sp.t1 = perf_counter_ns()
        sp.attrs.update(attrs)
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:
            stack.remove(sp)
        self.spans.append(sp)

    @contextlib.contextmanager
    def span(self, name: str, ids: dict | None = None, **attrs):
        """:meth:`open` and :meth:`close` around a block; yields the span
        (the block may add to its ``attrs``)."""
        sp = self.open(name, ids, **attrs)
        try:
            yield sp
        finally:
            self.close(sp)

    def add(self, name: str, t0: int, t1: int, parent: Span | None = None, ids: dict | None = None,
            **attrs) -> Span:
        """Record a finished span that crossed threads (``tid`` 0)."""
        sp = Span(name, t0, t1, 0, next(self._next), parent.sid if parent is not None else 0, _ids(parent, ids),
                  attrs)
        self.spans.append(sp)
        return sp


# The recorder, or None: off.
RECORDER: Recorder | None = None


def start() -> Recorder:
    """Turn the recorder on with no spans."""
    global RECORDER
    RECORDER = Recorder()
    return RECORDER


def stop() -> Recorder | None:
    """Turn the recorder off; returns it with its spans (None if it was off)."""
    global RECORDER
    rec, RECORDER = RECORDER, None
    if rec is not None:
        rec.clock.append(clock_pair())
    return rec


@contextlib.contextmanager
def adopted(parent: Span | None):
    """Within the block this thread's spans hang under ``parent``, a span
    open on another thread (nothing happens when it is None)."""
    rec = RECORDER
    if parent is None or rec is None:
        yield
        return
    stack = rec._stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.remove(parent)


def clock_pair() -> tuple[int, int]:
    """(``perf_counter_ns``, ``time_ns``) read at one instant: of five
    readings of the wall clock, the one bracketed most tightly by two of
    the performance counter, at the bracket's middle."""
    best = None
    for _ in range(5):
        a = perf_counter_ns()
        u = time.time_ns()
        b = perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


@dataclass
class StageTimer:
    """Wall time by stage of one pipeline run, and counters. With the
    recorder on, each :meth:`stage` is also a span of the same name, with
    the same two timestamps."""

    stages: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        rec = RECORDER
        sp = None if rec is None else rec.open(name)
        t = perf_counter_ns() if sp is None else sp.t0
        try:
            yield
        finally:
            if sp is None:
                t1 = perf_counter_ns()
            else:
                rec.close(sp)
                t1 = sp.t1
            self.stages[name] = self.stages.get(name, 0.0) + (t1 - t) / 1e9

    def add_count(self, name: str, n: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    @property
    def total(self) -> float:
        # "h_"-prefixed stages are NESTED attributions recorded inside another
        # stage (the streamed plan's host breakdown inside tokenize_device);
        # excluding them keeps `total` equal to actual wall time.
        return sum(v for k, v in self.stages.items() if not k.startswith("h_"))

    def throughput(self, count_name: str = "texts") -> float:
        n = self.counts.get(count_name, 0)
        return n / self.total if self.total > 0 else 0.0

    def to_dict(self) -> dict:
        d = {f"{k}_s": round(v, 6) for k, v in self.stages.items()}
        d.update(self.counts)
        d["total_s"] = round(self.total, 6)
        if "texts" in self.counts:
            d["texts_per_s"] = round(self.throughput(), 2)
        return d


def _trace_events(rec: Recorder, base_ns: int, pid="gliclass") -> list[dict]:
    """The recorder's spans as Chrome trace events on a profiler's clock:
    ``ts`` in µs of the wall clock since ``base_ns`` (the trace's
    ``baseTimeNanoseconds``), the performance counter mapped onto the wall
    clock by the recorder's clock pairs (their mean offset)."""
    offset = sum(u - p for p, u in rec.clock) / len(rec.clock) - base_ns
    events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "args": {"name": "gliclass spans"}}]
    for sp in rec.spans:
        args = {**sp.ids, **sp.attrs, "span": sp.sid, "parent": sp.parent}
        events.append({"ph": "X", "cat": "gliclass", "name": sp.name, "pid": pid, "tid": sp.tid,
                       "ts": (sp.t0 + offset) / 1e3, "dur": (sp.t1 - sp.t0) / 1e3, "args": args})
    return events


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace a block: ``torch.profiler`` (host ops, and CUDA kernels when a
    card is present) with the recorder on, written to ``log_dir/trace.json``
    in the Chrome trace format (chrome://tracing, Perfetto), the program's
    spans under the process ``gliclass``, one row per thread, on the
    profiler's clock. Yields the profiler. The recorder is off afterwards."""
    import json
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    start()
    try:
        with profile(activities=activities) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        rec = stop()
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    data["traceEvents"].extend(_trace_events(rec, int(data.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(data, f)
