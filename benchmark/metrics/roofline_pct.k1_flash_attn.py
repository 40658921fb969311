"""K1's share of its roofline, in percent: the bound of every K1 launch in
the window (``costs/k1_flash_attn.py``, from the launch's rows and seq
bucket and the model's heads; the program's launch counter says how many
launches each forward made) over K1's device time in the trace (kernels
named in ``NAMES``). Nothing when the trace's K1 kernels and the counted
launches disagree in number. Job cells only."""

from benchmark.costs.k1_flash_attn import NAMES, launch_bound_s


def read(run):
    if run.kind != "job" or not run.trace or run.peaks is None:
        return None
    names = [n for n in run.trace["kernel_s"] if any(k in n for k in NAMES)]
    t = sum(run.trace["kernel_s"][n] for n in names)
    events = sum(run.trace["kernel_n"][n] for n in names)
    launches = [(f["rows"], f["seq"]) for f in run.forwards for _ in range(f["k1"])]
    if t <= 0 or not launches or events != len(launches):
        return None
    bb = run.model["backbone"]
    heads = bb["num_attention_heads"]
    d = bb["hidden_size"] // heads
    bound = sum(launch_bound_s(r, s, heads, d, bb["position_buckets"], run.peaks) for r, s in launches)
    return 100.0 * bound / t
