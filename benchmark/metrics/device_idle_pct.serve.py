"""Share of the traced window in which no kernel, copy or set ran on the
device, in percent (the profiler's device trace between the window's two
marker kernels). serve cells only."""


def read(run):
    if run.kind != "serve" or not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
