"""The traced run's instruments: host spans and forward records taken from
the benchmark's own wrappers, the device trace, and their reduction.

* :class:`Instruments` wraps calls into the program's layers (the engine's
  forward step, the tokenizer's encodes, the job, the HTTP request) and
  records a host span for each, and for every forward its rows, sequence
  bucket, label bucket, real rows and tokens, and the K1 and K2 launches
  it made (the program's own launch counters, read around the step).
* :func:`profile_window` traces the device over the measured window with
  ``torch.profiler`` (device activity only: a host-op trace of a whole
  window is too large to read back in a run's time) between two marker
  kernels, which tie the host clock to the trace's.
* :func:`reduce_trace` reads the exported Chrome trace: device busy time,
  time by kernel, and the idle gaps, each named by the host spans open at
  its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import threading
import time
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel: nothing in the program launches it


class Instruments:
    """Spans and forward records of one traced run (``install`` then
    ``remove``)."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []  # (kind, start, end), time.perf_counter
        self.forwards: list[dict] = []
        self._lock = threading.Lock()
        self._undo: list = []

    def span(self, kind: str, fn):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                with self._lock:
                    self.spans.append((kind, t0, t1))
        return wrapped

    def _patch(self, owner, name: str, value) -> None:
        self._undo.append((owner, name, owner.__dict__.get(name, _MISSING)))
        setattr(owner, name, value)

    def install(self, engine, pipeline=None, server=None) -> None:
        from gliclass.c_tpu_torch.ops import fused_attention, fused_ffn
        from gliclass.c_tpu_torch.tokenization import AffixEncoder, PromptTokenizer

        step = engine._step

        def forward(ids, mask, max_labels, dev_inputs=None):
            k1, k2 = fused_attention.launches, fused_ffn.launches
            out = step(ids, mask, max_labels, dev_inputs)
            per_row = np.asarray(mask).sum(axis=1)
            real = per_row > 1  # a padded row holds one pad token
            self.forwards.append({
                "rows": int(ids.shape[0]), "seq": int(ids.shape[1]), "labels": int(max_labels),
                "real_rows": int(real.sum()), "real_tokens": int(per_row[real].sum()),
                "k1": fused_attention.launches - k1, "k2": fused_ffn.launches - k2,
            })
            return out

        self._patch(engine, "_step", self.span("forward", forward))
        for cls in (AffixEncoder, PromptTokenizer):
            self._patch(cls, "encode_batch", self.span("tokenize", cls.encode_batch))
        if pipeline is not None:
            self._patch(pipeline, "classify_job", self.span("job", pipeline.classify_job))
        if server is not None:
            self._patch(server, "classify", self.span("request", server.classify))

    def remove(self) -> None:
        for owner, name, old in reversed(self._undo):
            if old is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        self._undo.clear()


_MISSING = object()


@contextlib.contextmanager
def profile_window(device, trace_path: str):
    """Trace the block; yields a dict that holds, after the block,
    ``trace_path`` written and the host times of the two markers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    info: dict = {"path": None, "markers": []}
    with profile(activities=acts) as prof:
        if cuda:
            torch.cuda.synchronize()
            info["markers"].append(time.perf_counter())
            torch.cuda._sleep(1000)
        yield info
        if cuda:
            torch.cuda.synchronize()
            info["markers"].append(time.perf_counter())
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    t = time.perf_counter()
    prof.export_chrome_trace(trace_path)
    info["path"], info["export_s"] = trace_path, time.perf_counter() - t


def reduce_trace(trace_path: str, markers: list[float], spans: list[tuple[str, float, float]]) -> dict | None:
    """Busy and idle time of the device between the markers, its time by
    kernel, and its idle time by the host spans open at each gap's middle.
    None when the trace holds no device activity or no markers."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    marks = sorted((e for e in dev if MARKER in e.get("name", "")), key=lambda e: e["ts"])
    if len(marks) < 2 or len(markers) < 2:
        return None
    lo = marks[0]["ts"] + marks[0]["dur"]
    hi = marks[-1]["ts"]
    offset = marks[0]["ts"] - markers[0] * 1e6  # trace us = host s * 1e6 + offset
    ivs, by_name, count = [], defaultdict(float), defaultdict(int)
    for e in dev:
        if MARKER in e.get("name", ""):
            continue
        a, b = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if b <= a:
            continue
        ivs.append((a, b))
        by_name[e["name"]] += (b - a) / 1e6
        count[e["name"]] += 1
    ivs.sort()
    busy, gaps, cur_a, cur_b = 0.0, [], None, lo
    for a, b in ivs:
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                busy += cur_b - cur_a
            if a > cur_b:
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
        if hi > cur_b:
            gaps.append((cur_b, hi))
    else:
        gaps.append((lo, hi))
    idle_by = _name_gaps(gaps, offset, spans)
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "kernel_s": dict(by_name),
        "kernel_n": dict(count),
        "idle_by_host": idle_by,
    }


def _name_gaps(gaps, offset: float, spans) -> dict:
    kinds = sorted({k for k, _, _ in spans})
    index = {}
    for k in kinds:
        ks = sorted((a, b) for kk, a, b in spans if kk == k)
        starts = [a for a, _ in ks]
        reach = np.maximum.accumulate(np.array([b for _, b in ks])) if ks else np.array([])
        index[k] = (starts, reach)
    out: dict = defaultdict(float)
    for a, b in gaps:
        t = ((a + b) / 2 - offset) / 1e6
        open_ = []
        for k in kinds:
            starts, reach = index[k]
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and reach[i] > t:
                open_.append(k)
        out["+".join(open_) or "none"] += (b - a) / 1e6
    return dict(out)


def breakdown(red: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time and the ten largest idle totals by host activity."""
    top = sorted(red["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(red["idle_by_host"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top], "idle_gaps": [[n, s] for n, s in idle]}
