"""A run of each kind of traffic end to end on the CPU at the tiny geometry:
the result line meets the contract, and the plain reference agrees."""

import json
import math

import pytest
from conftest import tiny_cell

from benchmark import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _check_line(out, cell, trace):
    keys = list(out)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    json.loads(json.dumps(out))  # one JSON object, every value serialisable
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    want = {m["name"]: m["unit"] for m in (cell.per_layer if trace else cell.end_to_end)}
    for name, m in out["metrics"].items():
        assert want[name] == m["unit"] and math.isfinite(m["value"])
    dev = out["device"]
    assert dev["platform"] == "cpu" and dev["kind"] == "cpu"


@pytest.mark.parametrize("kind", ["job", "serve"])
def test_run_end_to_end_on_cpu(kind, cpu):
    cell = tiny_cell(kind)
    out = harness.run(cell, 2**31 + 17, 1.5, False, cpu)
    _check_line(out, cell, False)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}


@pytest.mark.parametrize("kind", ["job", "serve"])
def test_traced_run_reports_host_side_metrics(kind, cpu):
    cell = tiny_cell(kind)
    out = harness.run(cell, 23, 1.0, True, cpu)
    _check_line(out, cell, True)
    # The CPU has no device trace: only the metrics of counters and spans.
    want = {"job": {"h_tokenize_share.job", "pad_share.job"}, "serve": {"rows_per_forward.serve", "p95_ms.serve"}}[kind]
    assert set(out["metrics"]) == want
    assert "breakdown" not in out


def test_same_seed_same_traffic(cpu):
    from benchmark import textgen

    cell = tiny_cell("job")
    lex = textgen.Lexicon(5, cell.config["tokenizer"])
    a = harness.make_job(textgen.TextMaker(lex, cell.traffic, 5), cell.traffic, 5, 3)
    b = harness.make_job(textgen.TextMaker(textgen.Lexicon(5, cell.config["tokenizer"]), cell.traffic, 5), cell.traffic, 5, 3)
    c = harness.make_job(textgen.TextMaker(lex, cell.traffic, 6), cell.traffic, 6, 3)
    assert a == b and a.texts != c.texts
    words = lambda job: sorted(len(t.split()) for t in job.texts)  # noqa: E731
    assert words(a) == words(c)  # the same sizes for every seed, in another order


def test_a_pool_run_out_fails_the_run(cpu):
    """A program that outruns the traffic file's pool meets jobs a second
    time, its tokenizer's caches warm: the run is not correct."""
    cell = tiny_cell("job")
    cell.traffic.update(pool_jobs=1, texts_per_job=4)
    out = harness.run(cell, 31, 2.0, False, cpu, warm=False)
    assert out["checks"]["reused_jobs"]["value"] > 0 and out["correct"] is False
