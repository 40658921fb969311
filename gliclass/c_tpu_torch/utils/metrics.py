"""Observability: stage timers, throughput counters, profiler hooks.

The reference's entire instrumentation is one wall-clock interval printed at
exit (reference main.c:112-113,170-171). Here every pipeline run can carry a
:class:`StageTimer` breakdown (pack / tokenize / device / decide), counters
export as a dict (JSON-able for logs), and :func:`trace` wraps a block in a
``torch.profiler`` trace written as a Chrome trace when deep device profiling
is needed.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    stages: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t
            )

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

    def report(self) -> str:
        parts = [f"{k}={v:.3f}s" for k, v in self.stages.items()]
        line = " ".join(parts) + f" total={self.total:.3f}s"
        if "texts" in self.counts:
            line += f" ({self.throughput():.1f} texts/s)"
        return line


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace around a block (host ops, and CUDA kernels
    when a card is present), written to ``log_dir/trace.json`` in the Chrome
    trace format (chrome://tracing, Perfetto). Yields the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
