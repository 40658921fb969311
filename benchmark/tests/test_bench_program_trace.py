"""``program_trace.reduce_program`` and its metrics on a small synthetic
Chrome trace: two marker kernels with their launch calls (the clock
anchors, 2 µs of drift between them), kernels with launch calls by
correlation id (one without), a copy, a synchronise, and program spans on two
threads, the serving ones too."""

import json

import pytest

from benchmark import program_trace as pt
from benchmark.costs import w8a8_linear
from gliclass.c_tpu_torch.utils.metrics import Span

PEAKS = {"bf16_flops": 989e12, "int8_ops": 1979e12, "hbm_bytes": 3.35e12}
MAIN, OTHER, IDENT = 11, 12, 0x7F5A_9C4F_A740  # native ids of two threads, and MAIN's pthread id
# How a trace may name MAIN: by its pthread id whole, or cut to 32 bits read unsigned or signed.
TIDS = [IDENT, 0x9C4F_A740, 0x9C4F_A740 - (1 << 32)]
H0 = 5.0  # the first marker's host time, s; it launches at trace 1000 us, the second (H0 + 1 ms) at 2002


def _x(name, ts, dur, cat, corr=None, tid=IDENT):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace_us(host_s):
    """Host s to trace us under the two anchors (offset -4999000 us at H0, +2 us over the ms)."""
    return host_s * 1e6 - 4999000 + 2 * (host_s - H0) / 1e-3


def _span(name, sid, parent, t0_s, t1_s, tid=MAIN, ids=None, **attrs):
    return Span(name, round(t0_s * 1e9), round(t1_s * 1e9), tid, sid, parent, ids or {}, attrs)


def _spans():
    job = {"job": 1}
    return [
        _span("job", 1, 0, H0 + 100e-6, H0 + 900e-6, ids=job, texts=4),
        _span("forward", 2, 1, H0 + 200e-6, H0 + 500e-6, ids=job, rows=4, real_rows=3, seq=16, labels=2),
        _span("w8a8_linear", 3, 2, H0 + 210e-6, H0 + 300e-6, ids=job, m=64, k=32, n=32),
        _span("tokenize", 4, 1, H0 + 400e-6, H0 + 600e-6, tid=OTHER, ids=job, texts=4, tokens=500),
        _span("queue", 5, 0, H0 + 100e-6, H0 + 120e-6, tid=0, ids={"request": 7, "round": 3}),
        _span("queue", 6, 0, H0 + 100e-6, H0 + 250e-6, tid=0, ids={"request": 7, "round": 4}),
        _span("queue", 7, 0, H0 + 130e-6, H0 + 140e-6, tid=0, ids={"request": 8, "round": 3}),
        _span("dispatch", 8, 0, H0 + 150e-6, H0 + 160e-6, tid=13, ids={"round": 3}),
        _span("dispatch", 9, 0, H0 + 300e-6, H0 + 310e-6, tid=13, ids={"round": 4}),
    ]


def _events(tid=IDENT):
    """The trace, MAIN's calls under ``tid``; the markers are launched from another thread (999)."""
    return [x if x["cat"] not in pt.RUNTIME_CATS or x["tid"] != IDENT else dict(x, tid=tid) for x in [
        _x("cudaLaunchKernel", 1000, 3, "cuda_runtime", 1, tid=999), _x("spin_kernel", 1005, 10, "kernel", 1, tid=7),
        _x("cudaLaunchKernel", 2002, 3, "cuda_runtime", 99, tid=999), _x("spin_kernel", 2005, 10, "kernel", 99, tid=7),
        # Inside the w8a8 linear, inside the forward (again after it), inside the job only.
        _x("cudaLaunchKernel", _trace_us(H0 + 215e-6), 3, "cuda_runtime", 2),
        _x("elementwise_kernel", 1300, 50, "kernel", 2, tid=7),
        _x("cuLaunchKernel", _trace_us(H0 + 350e-6), 3, "cuda_driver", 3),
        _x("flash_da_tc_kernel<bf16>", 1360, 40, "kernel", 3, tid=7),
        _x("cudaStreamSynchronize", _trace_us(H0 + 400e-6), 20, "cuda_runtime", 30),
        _x("cudaMemcpyAsync", _trace_us(H0 + 420e-6), 5, "cuda_runtime", 31),
        _x("Memcpy HtoD (Pageable -> Device)", 1450, 10, "gpu_memcpy", 31, tid=7),
        _x("cudaLaunchKernel", _trace_us(H0 + 700e-6), 3, "cuda_runtime", 4),
        _x("reduce_kernel", 1750, 50, "kernel", 4, tid=7),
        _x("orphan_kernel", 1900, 50, "kernel", 5, tid=7),  # no launch call in the trace
        _x("aten::mm", 1200, 5, "cpu_op"),
    ]]


def _reduce(tmp_path, events, spans=None):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events, "baseTimeNanoseconds": 10 ** 9}))
    return pt.reduce_program(str(path), [H0, H0 + 1e-3], _spans() if spans is None else spans, {MAIN: IDENT},
                             [(int(H0 * 1e9), int(H0 * 1e9) + 3 * 10 ** 9)])


@pytest.mark.parametrize("tid", TIDS + [4242])
def test_reduction_anchors_attribution_and_counts(tmp_path, tid):
    # 4242 names MAIN by no id the recorder knows: matched by time instead.
    red = _reduce(tmp_path, _events(tid))
    assert red["threads_matched_by_time"] == (tid == 4242) and red["calls_off_span_threads"] == [[999, 2]]
    assert red["offsets_us"] == pytest.approx([1000 - H0 * 1e6, 2002 - (H0 + 1e-3) * 1e6])
    assert red["drift_us"] == pytest.approx(2.0)
    assert red["wallclock_offset_us"] == pytest.approx(3e6 - 1e6)
    assert (red["kernels"], red["kernels_mapped"]) == (5, 4)
    assert (red["forward_kernels"], red["forward_kernels_outside"]) == (1, 0)
    (fw,) = red["forwards"]
    assert (fw["launches"], fw["syncs"], fw["real_rows"]) == (2, 1, 3)
    assert fw["host_s"] == pytest.approx(300e-6) and fw["sync_s"] == pytest.approx(20e-6)
    assert fw["tokenize_open"]
    assert red["w8a8"] == {"shapes": [(64, 32, 32)], "with_kernels": 1, "device_s": pytest.approx(50e-6)}
    assert red["device_by_span"] == pytest.approx({"w8a8_linear": 50e-6, "forward": 50e-6, "job": 50e-6,
                                                   "unmapped": 50e-6})
    assert sorted(red["queue_waits_s"]) == pytest.approx([20e-6, 200e-6])
    assert (red["tokenize_s"], red["tokens"]) == (pytest.approx(200e-6), 500)
    # The window is 1015-2005 us, busy 1300-1350, 1360-1400, 1450-1460, 1750-1800, 1900-1950.
    assert sum(red["idle_by_span"].values()) == pytest.approx(990e-6 - 200e-6)
    assert red["idle_by_span"]["forward+job+tokenize"] == pytest.approx(50e-6)  # 1400-1450: H0 + 425 us
    assert red["idle_by_span"]["job"] == pytest.approx(390e-6)  # 1460-1750 and 1800-1900


def test_metrics_read_the_reduction(tmp_path):
    red = _reduce(tmp_path, _events())
    read = {name: fn(red, PEAKS) for name, (_, fn) in pt.METRICS.items()}
    assert read["fwd_host_ms"] == pytest.approx(0.3)
    assert (read["launches_per_fwd"], read["syncs_per_fwd"]) == (2, 1)
    bound = w8a8_linear.launch_bound_s(64, 32, 32, PEAKS)
    assert read["roofline_pct.w8a8_linear"] == pytest.approx(100 * bound / 50e-6)
    assert read["queue_wait_p95_ms.serve"] == pytest.approx(0.2)
    assert read["tok_ms_per_ktok.job"] == pytest.approx(1e3 * 200e-6 / 0.5)
    assert w8a8_linear.launch_work(64, 32, 32) == (2 * 64 * 32 * 32, 64 * 32 * 2 + 32 * 32 + 32 * 4 + 64 * 32 * 2)


def test_w8a8_roofline_is_nothing_when_a_linear_launched_no_kernel(tmp_path):
    spans = _spans() + [_span("w8a8_linear", 20, 2, H0 + 310e-6, H0 + 320e-6, m=64, k=32, n=32)]
    red = _reduce(tmp_path, _events(), spans)
    assert red["w8a8"]["with_kernels"] == 1 and len(red["w8a8"]["shapes"]) == 2
    assert pt.roofline_pct_w8a8_linear(red, PEAKS) is None


def test_a_trace_without_runtime_calls_or_markers(tmp_path):
    events = [e for e in _events() if e["cat"] not in pt.RUNTIME_CATS]
    assert _reduce(tmp_path, events) == {"runtime_calls": 0}
    assert _reduce(tmp_path, [e for e in _events() if "spin" not in e["name"]]) is None
    assert all(fn({}, PEAKS) is None for _, fn in pt.METRICS.values())


@pytest.mark.parametrize("name,launch,sync", [
    ("cudaLaunchKernel", True, False), ("cudaLaunchKernelExC", True, False), ("cuLaunchKernelEx", True, False),
    ("cudaStreamSynchronize", False, True), ("cudaMemcpy", False, True), ("cudaMemcpyAsync", False, False),
    ("cuMemcpyDtoH_v2", False, True), ("cudaEventRecord", False, False),
])
def test_call_kinds(name, launch, sync):
    assert (pt.is_launch(name), pt.is_sync(name)) == (launch, sync)
