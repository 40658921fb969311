"""Shared set-up of the benchmark's own tests: the repository root on the
path, the ``cuda`` marker, and cells at a tiny test-only geometry (the
files under ``data/``; no cell of ``BENCHMARK.json`` is this small)."""

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

# The tiny cells' correctness limit: their program reads a logit gap of
# 0.17-0.28 on seeds 11-13, the 4-bit control 3.3-4.1 (the control test
# holds both sides).
TINY_LOGIT_GAP = 1.0


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped with a reason when none is present")


def tiny_cell(kind: str):
    from benchmark import harness

    data = os.path.join(HERE, "data")
    with open(os.path.join(data, "tiny-config.json")) as f:
        config = json.load(f)
    with open(os.path.join(data, f"tiny-{kind}.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    like = "large-job-long" if kind == "job" else "base-serve-steady"
    e2e = [m for m in spec["end_to_end"] if like in m.get("workloads", [like])]
    per_layer = [m for m in spec["per_layer"] if like in m["workloads"]]
    limits = {"logit_gap": TINY_LOGIT_GAP, "decision_flips": 0, "few_compared": 0, "misrouted": 0, "failed": 0,
              "unanswered_sample": 0, "weights_differ": 0, "reused_jobs": 0}
    return harness.Cell(f"tiny-{kind}", config, traffic, limits, e2e, per_layer)


@pytest.fixture
def cpu():
    import torch

    return torch.device("cpu")
