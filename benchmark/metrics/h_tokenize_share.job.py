"""Share of the jobs' wall time that the batch plane spent waiting on the
tokenizer, in percent: the program's ``StageTimer`` ``h_tokenize`` over its
``total``, each summed over the window's jobs. Job cells only."""


def read(run):
    if run.kind != "job":
        return None
    timings = run.work.get("timings") or []
    total = sum(t.get("total_s", 0.0) for t in timings)
    if total <= 0:
        return None
    return 100.0 * sum(t.get("h_tokenize_s", 0.0) for t in timings) / total
