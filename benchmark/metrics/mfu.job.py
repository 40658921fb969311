"""The whole step's share of the chip's peak over the traced window, in
percent: for every forward launched in the window, the model's work at its
(rows, seq bucket, label bucket) (``costs/step.py``: int8 products at the
int8 peak, attention's contractions at the bf16 peak), summed, over the
window. Job cells only."""

from benchmark.costs.step import step_seconds_at_peak


def read(run):
    if run.kind != "job" or not run.forwards or not run.trace or run.peaks is None:
        return None
    t = sum(step_seconds_at_peak(run.model, f["rows"], f["seq"], f["labels"], run.peaks) for f in run.forwards)
    return 100.0 * t / run.trace["window_s"]
