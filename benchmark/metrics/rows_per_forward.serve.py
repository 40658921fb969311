"""Real rows (texts) per device forward over the window: the rows of every
forward the serving scheduler launched, padded rows left out, over the
number of forwards. Serving cells only."""


def read(run):
    if run.kind != "serve" or not run.forwards:
        return None
    return sum(f["real_rows"] for f in run.forwards) / len(run.forwards)
