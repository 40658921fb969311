"""The program's own spans against the device trace of one traced window.

With its recorder on (``gliclass.c_tpu_torch.utils.metrics``), the program
records spans on the host's performance counter: ``job`` and its stages,
``forward``, ``w8a8_linear``, ``tokenize``, and in serving ``request``,
``parse``, ``queue``, ``respond``, ``round_tokenize``, ``dispatch`` and
``drain``. :func:`reduce_program` reads them with the profiler's trace of the
same window (:func:`tracing.profile_window`: device activity only, which
still holds the CUDA runtime and driver calls on the host's threads):

* **the clock.** Each of the window's two marker kernels is found with its
  runtime launch call by correlation id. The call's trace time less the
  marker's host time (read just before the launch) is the offset of the
  trace's clock from the host's at each end of the window; their
  difference is the drift over it, and host times map between the two
  linearly;
* **attribution.** Each device kernel maps by correlation id to its launch
  call, and the call to the innermost program span open on its thread at
  that instant: device time by span, and whether a kernel was launched
  inside a ``forward``. A host thread of the trace is the recorder's by its
  id, or else by time: the thread whose spans hold nine in ten of its calls;
* **per forward**, the launch calls inside it (``cudaLaunchKernel*``,
  ``cuLaunchKernel*``; one a correlation id) and the synchronising calls
  (stream, device and event synchronisation, synchronous copies) with their
  host time, and whether a ``tokenize`` span was open on another thread
  meanwhile (the tokenizer holds the GIL);
* **idle gaps** named by the program spans open at each gap's middle.

:data:`METRICS` holds the per-layer metrics that read the result.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

import numpy as np

from .costs import k1_flash_attn, k2_ffn
from .costs.w8a8_linear import launch_bound_s
from .harness import nearest_rank
from .tracing import DEVICE_CATS, MARKER

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")  # name prefixes: the Ex variants too
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize")
FORWARD_KERNELS = k1_flash_attn.NAMES + k2_ffn.NAMES  # launched only inside a forward


def is_launch(name: str) -> bool:
    return name.startswith(LAUNCHES)


def is_sync(name: str) -> bool:
    """A call that blocks the host until the device is done: a synchronise,
    or a copy without ``Async`` in its name."""
    return name in SYNCS or (name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name)


def _corr(e: dict):
    return (e.get("args") or {}).get("correlation")


class Clock:
    """Host ``perf_counter_ns`` to trace µs and back, linear between two
    anchors: ``host_ns`` two host times, ``offsets_us`` the trace's offset
    (trace µs less host µs) at each."""

    def __init__(self, host_ns: tuple[float, float], offsets_us: tuple[float, float]):
        (self.a, b), (self.oa, ob) = host_ns, offsets_us
        self.slope = (ob - self.oa) / (b - self.a) if b != self.a else 0.0  # µs of drift per host ns

    def to_trace(self, t_ns: float) -> float:
        return t_ns / 1e3 + self.oa + self.slope * (t_ns - self.a)

    def to_host(self, ts_us: float) -> float:
        return (ts_us - self.oa + self.slope * self.a) / (1e-3 + self.slope)


def _innermost(spans: list, times: list[float]) -> list:
    """For each of ``times`` (trace µs, ascending) the innermost of ``spans``
    ((start µs, end µs, span), one thread's, nested, by start) open then."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _gaps(ivs: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The gaps in [lo, hi] between the intervals."""
    gaps, end = [], lo
    for a, b in sorted(ivs):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def _merged(spans: list) -> tuple[list[float], list[float]]:
    """The union of one thread's spans ((start, end, span), by start) as
    (starts, ends) of disjoint intervals."""
    starts, ends = [], []
    for a, b, _ in spans:
        if ends and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def _covered(merged: tuple[list[float], list[float]], times: list[float]) -> int:
    """How many of ``times`` lie inside the intervals."""
    starts, ends = merged
    n = 0
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        n += i >= 0 and ends[i] > t
    return n


def _open_at(spans: list, times_ns: list[float]) -> list[str]:
    """For each host time, the names of the spans open then, joined by '+'."""
    index = {}
    for name in sorted({s.name for s in spans}):
        ks = sorted((s.t0, s.t1) for s in spans if s.name == name)
        index[name] = ([a for a, _ in ks], np.maximum.accumulate(np.array([b for _, b in ks])))
    out = []
    for t in times_ns:
        open_ = [n for n, (starts, reach) in index.items()
                 if (i := bisect.bisect_right(starts, t) - 1) >= 0 and reach[i] > t]
        out.append("+".join(open_) or "none")
    return out


def reduce_program(trace_path: str, markers: list[float], spans: list, threads: dict | None = None,
                   clock_pairs: list | None = None) -> dict | None:
    """The window's program spans against its trace (``markers``: the two
    markers' host times in s, as :func:`tracing.profile_window` gives them;
    ``spans``: the recorder's; ``threads``: its native thread id ->
    ``threading.get_ident()`` map, for a trace that names host threads by
    the latter; ``clock_pairs``: its (perf_counter_ns, time_ns) pairs, for
    the offset that the trace's wall clock gives, logged beside the
    anchors'). None without the two markers; only ``runtime_calls`` when
    the trace holds no runtime calls or no launch of a marker."""
    with open(trace_path) as f:
        data = json.load(f)
    events = data.get("traceEvents", [])
    xs = [e for e in events if e.get("ph") == "X"]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    calls = sorted((e for e in xs if e.get("cat") in RUNTIME_CATS), key=lambda e: e["ts"])
    marks = sorted((e for e in dev if MARKER in e.get("name", "")), key=lambda e: e["ts"])
    if len(marks) < 2 or len(markers) < 2:
        return None
    if not calls:
        return {"runtime_calls": 0}
    call_of = {}  # correlation id -> the call that launched a kernel or started a copy or set
    for e in calls:
        if _corr(e) is not None and (_corr(e) not in call_of or is_launch(e["name"])):
            call_of[_corr(e)] = e
    anchors = [call_of.get(_corr(m)) for m in (marks[0], marks[-1])]
    if None in anchors:
        return {"runtime_calls": len(calls)}
    host = (markers[0] * 1e9, markers[-1] * 1e9)
    offsets = (anchors[0]["ts"] - markers[0] * 1e6, anchors[1]["ts"] - markers[-1] * 1e6)
    clock = Clock(host, offsets)
    lo, hi = marks[0]["ts"] + marks[0]["dur"], marks[-1]["ts"]

    # Each call's innermost span on its thread.
    # The trace names a host thread by its native id, or by its pthread id
    # (``threading.get_ident()``): whole, or cut to 32 bits read unsigned or signed.
    native = {}
    for n, ident in (threads or {}).items():
        low = ident & 0xFFFFFFFF
        for key in (ident, low, low - (1 << 32) if low >= 1 << 31 else low):
            native[key] = n
    by_tid: dict = defaultdict(list)
    for s in spans:
        if s.tid:
            by_tid[s.tid].append((clock.to_trace(s.t0), clock.to_trace(s.t1), s))
    for v in by_tid.values():
        v.sort(key=lambda x: (x[0], -x[1]))
    calls_by_tid: dict = defaultdict(list)
    for e in calls:
        calls_by_tid[native.get(e.get("tid"), e.get("tid"))].append(e)
    # A trace thread that none of these ids names is the recorder's thread
    # whose spans hold nine in ten of its calls, if one does.
    by_time = 0
    merged = {tid: _merged(v) for tid, v in by_tid.items()}
    for tid in [t for t in calls_by_tid if t not in by_tid]:
        es = calls_by_tid[tid]
        sample = [e["ts"] for e in es[::max(1, len(es) // 2000)]]
        score, best = max(((_covered(m, sample), n) for n, m in merged.items() if n not in calls_by_tid),
                          default=(0, None))
        if best is not None and score >= 0.9 * len(sample):
            calls_by_tid[best] = calls_by_tid.pop(tid)
            by_time += 1
    inner: dict = {}
    unmatched = sorted(((len(es), tid) for tid, es in calls_by_tid.items() if tid not in by_tid), reverse=True)
    for tid, es in calls_by_tid.items():
        for e, s in zip(es, _innermost(by_tid.get(tid, []), [e["ts"] for e in es])):
            inner[id(e)] = s
    by_sid = {s.sid: s for s in spans}

    def within(s, name):
        for _ in range(64):
            if s is None or s.name == name:
                return s
            s = by_sid.get(s.parent)
        return None

    in_window = [s for s in spans if host[0] <= s.t0 and s.t1 <= host[1]]
    fw = {s.sid: s for s in in_window if s.name == "forward"}
    launched, syncs = defaultdict(set), defaultdict(list)
    for e in calls:
        f = within(inner.get(id(e)), "forward")
        if f is None or f.sid not in fw:
            continue
        if is_launch(e["name"]):
            launched[f.sid].add(_corr(e))
        elif is_sync(e["name"]):
            syncs[f.sid].append(e["dur"] / 1e6)
    tok = [s for s in in_window if s.name == "tokenize" and (by_sid.get(s.parent) is None
                                                              or by_sid[s.parent].name != "tokenize")]
    forwards = []
    for sid, s in fw.items():
        forwards.append({**s.attrs, "host_s": (s.t1 - s.t0) / 1e9, "launches": len(launched[sid]),
                         "syncs": len(syncs[sid]), "sync_s": sum(syncs[sid]),
                         "tokenize_open": any(t.tid != s.tid and t.t0 < s.t1 and t.t1 > s.t0 for t in tok)})

    # Device kernels: mapped to their launch, charged to its innermost span.
    kernels = [e for e in dev if MARKER not in e.get("name", "") and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    device_by, mapped, fwd_kernels, fwd_kernels_out = defaultdict(float), 0, 0, 0
    w8a8 = {s.sid: s for s in in_window if s.name == "w8a8_linear"}
    w8a8_s, w8a8_hit = 0.0, set()
    for e in kernels:
        t = (min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)) / 1e6
        call = call_of.get(_corr(e))
        s = inner.get(id(call)) if call is not None else None
        mapped += call is not None
        device_by[s.name if s is not None else ("unmapped" if call is None else "no span")] += t
        if any(k in e["name"] for k in FORWARD_KERNELS):
            fwd_kernels += 1
            fwd_kernels_out += within(s, "forward") is None
        if s is not None and s.sid in w8a8:
            w8a8_s += t
            w8a8_hit.add(s.sid)
    gaps = _gaps([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in kernels], lo, hi)
    idle_by: dict = defaultdict(float)
    for (a, b), name in zip(gaps, _open_at(spans, [clock.to_host((a + b) / 2) for a, b in gaps])):
        idle_by[name] += (b - a) / 1e6

    # Queue waits: a request's submit to its round's dispatch (its latest round).
    dispatch = {}
    for s in sorted((s for s in spans if s.name == "dispatch"), key=lambda s: s.t0):
        dispatch.setdefault(s.ids.get("round"), s.t0)
    waits: dict = defaultdict(float)
    for s in in_window:
        if s.name == "queue" and s.ids.get("round") in dispatch:
            rid = s.ids.get("request", s.sid)
            waits[rid] = max(waits[rid], (dispatch[s.ids["round"]] - s.t0) / 1e9)
    return {
        "runtime_calls": len(calls),
        "offsets_us": list(offsets), "drift_us": offsets[1] - offsets[0],
        "wallclock_offset_us": (sum(u - p for p, u in clock_pairs) / len(clock_pairs)
                                - data.get("baseTimeNanoseconds", 0)) / 1e3 if clock_pairs else None,
        "kernels": len(kernels), "kernels_mapped": mapped,
        "threads_matched_by_time": by_time,
        "calls_off_span_threads": [[tid, n] for n, tid in unmatched[:3]],  # on threads that recorded no span
        "forward_kernels": fwd_kernels, "forward_kernels_outside": fwd_kernels_out,
        "forwards": forwards,
        "w8a8": {"shapes": [(s.attrs["m"], s.attrs["k"], s.attrs["n"]) for s in w8a8.values()],
                 "with_kernels": len(w8a8_hit), "device_s": w8a8_s},
        "tokenize_s": sum((s.t1 - s.t0) / 1e9 for s in tok), "tokens": sum(s.attrs.get("tokens", 0) for s in tok),
        "queue_waits_s": list(waits.values()),
        "device_by_span": dict(device_by), "idle_by_span": dict(idle_by),
    }


# ------------------------------------------------------------------ metrics
def fwd_host_ms(red: dict, peaks=None) -> float | None:
    """Mean host time of the window's ``forward`` spans, in ms."""
    fw = red.get("forwards")
    return 1e3 * sum(f["host_s"] for f in fw) / len(fw) if fw else None


def launches_per_fwd(red: dict, peaks=None) -> float | None:
    """Kernel launch calls inside ``forward`` spans per forward."""
    fw = red.get("forwards")
    return sum(f["launches"] for f in fw) / len(fw) if fw else None


def syncs_per_fwd(red: dict, peaks=None) -> float | None:
    """Synchronising calls inside ``forward`` spans per forward."""
    fw = red.get("forwards")
    return sum(f["syncs"] for f in fw) / len(fw) if fw else None


def roofline_pct_w8a8_linear(red: dict, peaks=None) -> float | None:
    """The w8a8 linears' share of their roofline, in percent: the bound of
    every ``w8a8_linear`` span's (M, K, N) (``costs/w8a8_linear.py``) over
    the device time of the kernels launched inside those spans. Nothing
    when a span launched no kernel the trace holds."""
    w = red.get("w8a8")
    if not w or not w["shapes"] or peaks is None or w["device_s"] <= 0 or w["with_kernels"] != len(w["shapes"]):
        return None
    return 100.0 * sum(launch_bound_s(m, k, n, peaks) for m, k, n in w["shapes"]) / w["device_s"]


def queue_wait_p95_ms(red: dict, peaks=None) -> float | None:
    """95th percentile, nearest rank, of the window's requests' queue wait
    (submit to the start of its round's ``dispatch``; a request of several
    rounds waits for its last), in ms."""
    w = red.get("queue_waits_s")
    return 1e3 * nearest_rank(w, 0.95) if w else None


def tok_ms_per_ktok(red: dict, peaks=None) -> float | None:
    """Tokenizer time (``tokenize`` spans, outermost) per thousand tokens, in ms."""
    n = red.get("tokens", 0)
    return 1e3 * red["tokenize_s"] / (n / 1e3) if n else None


# name -> (the traffic kinds it reads, its function)
METRICS = {
    "fwd_host_ms": (("job", "serve"), fwd_host_ms),
    "launches_per_fwd": (("job", "serve"), launches_per_fwd),
    "syncs_per_fwd": (("job", "serve"), syncs_per_fwd),
    "roofline_pct.w8a8_linear": (("job",), roofline_pct_w8a8_linear),
    "queue_wait_p95_ms.serve": (("serve",), queue_wait_p95_ms),
    "tok_ms_per_ktok.job": (("job",), tok_ms_per_ktok),
}
