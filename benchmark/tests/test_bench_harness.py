"""The harness's rules: the JAX import check, files found by name, the cost
model's counts by hand, and the trace's reduction."""

import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import ROOT

from benchmark import harness, tracing
from benchmark.costs import k1_flash_attn, k2_ffn, step


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("gliclass.c_tpu", True), ("gliclass.c_tpu.ops.fused_attention", True),
    ("gliclass.c_tpu_torch", False), ("gliclass.c_tpu_torch.engine", False), ("gliclass", False),
    ("jaxtyping", False), ("gliclass.c_tpu_tools", False), ("benchmark.harness", False),
])
def test_forbidden_modules_compare_whole_names(name, bad):
    assert harness.forbidden_modules([name]) == ([name] if bad else [])


def test_the_run_path_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.harness, benchmark.compare; "
            "import gliclass.c_tpu_torch.pipeline, gliclass.c_tpu_torch.serving; "
            "from benchmark.harness import forbidden_modules; print(forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "large-job-long", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_files_dropped_in_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(root / "benchmark/configs/gliclass-base.json"))
    cfg["model"]["backbone"]["num_hidden_layers"] = 6
    json.dump(cfg, open(root / "benchmark/configs/new-model.json", "w"))
    json.dump(dict(json.load(open(root / "benchmark/traffic/job-mixed.json")), texts_per_job=64),
              open(root / "benchmark/traffic/new-mix.json", "w"))
    json.dump({"logit_gap": 0.05}, open(root / "benchmark/limits/new-cell.json", "w"))
    (root / "benchmark/metrics/new_metric.job.py").write_text("def read(run):\n    return 42.0\n")
    spec["configs"].append({"name": "new-model", "source": "https://example.org/m", "file": "benchmark/configs/new-model.json",
                            "reduced": ["num_hidden_layers"], "why": "test"})
    spec["workloads"].append({"name": "new-cell", "config": "new-model", "traffic": "new-mix", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "new_metric.job", "unit": "%", "better": "higher", "source": "program_counter",
                              "layer": "engine", "moves": "job_texts_per_s", "workloads": ["new-cell"]})
    for m in spec["end_to_end"]:
        if m["name"] == "job_texts_per_s":
            m["workloads"].append("new-cell")
    json.dump(spec, open(root / "BENCHMARK.json", "w"))
    cell = harness.load_cell("new-cell", str(root))
    assert cell.config["model"]["backbone"]["num_hidden_layers"] == 6
    assert cell.traffic["texts_per_job"] == 64 and cell.limits == {"logit_gap": 0.05}
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "job_texts_per_s"]
    assert [m["name"] for m in cell.per_layer] == ["new_metric.job"]
    assert harness._reader(cell.metric_dir, "new_metric.job")(None) == 42.0


def test_step_cost_by_hand():
    model = json.load(open(os.path.join(ROOT, "benchmark/configs/gliclass-large.json")))["model"]
    w = step.step_work(model, rows=1, seq=512, labels=16)
    # 24 layers x 2 x 512 tokens x (1024 x 3072 + 1024 x 1024 + 2 x 1024 x 4096) = 309.2 G
    layers = 24 * 2 * 512 * (1024 * 3072 + 1024 * 1024 + 2 * 1024 * 4096)
    pos = 24 * 2 * 2 * 512 * 1024 * 1024  # the 512 relative embeddings through q and k
    head = 17 * 2 * 2 * 1024 * 4096  # the text and 16 label slots through two projectors
    assert w["int8"] == layers + pos + head
    assert w["bf16"] == 24 * 8 * 16 * 512 * 512 * 64 + 2 * 16 * 1024
    assert abs(layers / 1e9 - 309.2) < 0.1 and abs(24 * 8 * 16 * 512 * 512 * 64 / 1e9 - 51.5) < 0.1


def test_kernel_bounds_by_hand():
    peaks = {"bf16_flops": 989e12, "int8_ops": 1979e12, "hbm_bytes": 3.35e12}
    ops, nbytes = k1_flash_attn.launch_work(16, 512, 12, 64, 256)
    assert ops == 8 * 16 * 12 * 512 * 512 * 64
    assert nbytes == 4 * 16 * 12 * 512 * 64 * 2 + 2 * 512 * 12 * 64 * 2 + 16 * 512 * 4
    assert k1_flash_attn.launch_bound_s(16, 512, 12, 64, 256, peaks) == ops / 989e12
    ops, nbytes = k2_ffn.launch_work(8192, 768, 3072)
    assert ops == 4 * 8192 * 768 * 3072 and nbytes == 2 * 8192 * 768 * 2 + 2 * 768 * 3072 + 2 * 3840 * 4
    assert abs(k2_ffn.launch_bound_s(8192, 768, 3072, peaks) * 1e3 - 0.0391) < 1e-4  # PERF.md's K2 bound


def _event(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}


def test_trace_reduction(tmp_path):
    # Markers at 1000 and 2000 us; kernels busy 1100-1300 and 1250-1400 (merged) and 1700-1800.
    events = [_event("spin_kernel", 1000, 10), _event("k_a", 1100, 200), _event("k_b", 1250, 150),
              _event("k_a", 1700, 100), _event("spin_kernel", 2000, 10), _event("cpu", 1200, 50, "cpu_op")]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    host0 = 5.0  # the first marker's host time: trace us = host s * 1e6 + (1000 - 5e6)
    spans = [("tokenize", host0 + 500e-6, host0 + 650e-6), ("forward", host0 + 800e-6, host0 + 950e-6)]
    red = tracing.reduce_trace(str(path), [host0, host0 + 1e-3], spans)
    assert red["window_s"] == pytest.approx(990e-6)
    assert red["busy_s"] == pytest.approx(400e-6)
    assert red["kernel_s"] == pytest.approx({"k_a": 300e-6, "k_b": 150e-6})
    # Gaps: 1010-1100 (none), 1400-1700 (middle 1550: tokenize), 1800-2000 (middle 1900: forward).
    assert red["idle_by_host"] == pytest.approx({"none": 90e-6, "tokenize": 300e-6, "forward": 200e-6})
    bd = tracing.breakdown(red)
    assert bd["device_ops"][0] == ["k_a", pytest.approx(300e-6)] and len(bd["idle_gaps"]) == 3


def test_metric_readers_on_a_record():
    model = json.load(open(os.path.join(ROOT, "benchmark/configs/gliclass-base.json")))["model"]
    peaks = {"bf16_flops": 989e12, "int8_ops": 1979e12, "hbm_bytes": 3.35e12}
    fw = [{"rows": 128, "seq": 56, "labels": 32, "real_rows": 100, "real_tokens": 4200, "k1": 12, "k2": 12}]
    trace = {"window_s": 0.01, "busy_s": 0.004, "kernel_s": {"flash_da_tc_kernel(x)": 0.001, "s8_gemm_kernel<1>": 0.002},
             "kernel_n": {"flash_da_tc_kernel(x)": 12, "s8_gemm_kernel<1>": 24}, "idle_by_host": {}}
    rec = harness.RunRecord("job", model, 0.01, {"timings": [{"h_tokenize_s": 1.0, "total_s": 4.0}]}, fw, trace, peaks)
    read = lambda n: harness._reader(os.path.join(ROOT, "benchmark/metrics"), n)(rec)  # noqa: E731
    assert read("device_idle_pct.job") == pytest.approx(60.0)
    assert read("device_idle_pct.serve") is None
    assert read("h_tokenize_share.job") == pytest.approx(25.0)
    assert read("pad_share.job") == pytest.approx(100 * (1 - 4200 / (128 * 56)))
    t = step.step_seconds_at_peak(model, 128, 56, 32, peaks)
    assert read("mfu.job") == pytest.approx(100 * t / 0.01)
    k1 = 12 * k1_flash_attn.launch_bound_s(128, 56, 12, 64, 256, peaks)
    assert read("roofline_pct.k1_flash_attn") == pytest.approx(100 * k1 / 0.001)
    assert read("roofline_pct.k2_ffn") == pytest.approx(100 * 12 * k2_ffn.launch_bound_s(128 * 56, 768, 3072, peaks) / 0.002)
    trace["kernel_n"]["flash_da_tc_kernel(x)"] = 11  # launches and kernels disagree: nothing
    assert read("roofline_pct.k1_flash_attn") is None
