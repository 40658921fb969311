"""The bound of one w8a8 linear (the program's ``w8a8_linear`` span) from
its product's shape.

For an [M, K] activation times a [K, N] weight: 2 * M * K * N int8
operations. Bytes: the bf16 activation read once, the int8 weight read
once, its fp32 per-column scale read once, the bf16 output written once.
"""


def launch_work(m: int, k: int, n: int) -> tuple[float, float]:
    """(int8 operations, bytes) of one linear."""
    return 2 * m * k * n, m * k * 2 + k * n + n * 4 + m * n * 2


def launch_bound_s(m: int, k: int, n: int, peaks: dict) -> float:
    ops, nbytes = launch_work(m, k, n)
    return max(ops / peaks["int8_ops"], nbytes / peaks["hbm_bytes"])
