"""K2's share of its roofline, in percent: the bound of every K2 launch in
the window (``costs/k2_ffn.py``, from the launch's rows x seq bucket token
rows and the model's widths; the program's launch counter says how many
launches each forward made) over K2's device time in the trace (kernels
named in ``NAMES``). Nothing when the trace's K2 products and the counted
launches disagree in number. Job cells only."""

from benchmark.costs.k2_ffn import NAMES, launch_bound_s


def read(run):
    if run.kind != "job" or not run.trace or run.peaks is None:
        return None
    names = [n for n in run.trace["kernel_s"] if any(k in n for k in NAMES)]
    t = sum(run.trace["kernel_s"][n] for n in names)
    gemms = sum(run.trace["kernel_n"][n] for n in names if "s8_gemm_kernel" in n)
    fused = sum(run.trace["kernel_n"][n] for n in names if "ffn_w8a8_kernel" in n)
    launches = [f["rows"] * f["seq"] for f in run.forwards for _ in range(f["k2"])]
    if t <= 0 or not launches or gemms + 2 * fused != 2 * len(launches):
        return None
    bb = run.model["backbone"]
    H, I = bb["hidden_size"], bb["intermediate_size"]
    return 100.0 * sum(launch_bound_s(m, H, I, run.peaks) for m in launches) / t
