"""95th percentile of the request latency, in ms, nearest rank over every
request due in the window: from its due time to the last byte of its
answer, on the load generator's clock; a request that failed or got no
answer counts at the generator's deadline. Serving cells only.

It is a per-layer metric, read in the traced run, because its spread from
run to run is wider than any bound the benchmark may set (PERF.md §2). The
profiler's cost on the host raises it there: compare traced runs with traced
runs (an untraced run logs its own p95 on standard error)."""

from benchmark.harness import nearest_rank


def read(run):
    lat = run.work.get("latencies_s") if run.kind == "serve" else None
    return 1e3 * nearest_rank(lat, 0.95) if lat else None
