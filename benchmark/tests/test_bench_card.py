"""One short run of each cell on the card (skipped without one)."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["large-job-long", "base-serve-steady"])
def test_cell_runs_correct_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run only on one")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "2147483659",
                          "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu", line
