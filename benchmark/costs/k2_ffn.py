"""The bound of one w8a8 FFN launch (K2) from its shape.

For ``m`` token rows of width ``H`` and an intermediate of ``I``: the up and
down int8 products, 2 * m * H * I operations each. Bytes: x read once
(bf16), both int8 weights read once, their fp32 scales and biases read once,
the output written once (bf16); the intermediate stays inside the FFN.
"""

NAMES = ("s8_gemm_kernel", "row_quant_kernel", "ffn_w8a8_kernel")  # K2's kernels, both variants


def launch_work(m: int, H: int, I: int) -> tuple[float, float]:
    """(int8 operations, bytes) of one launch."""
    ops = 2 * 2 * m * H * I
    nbytes = m * H * 2 + 2 * H * I + (I + H) * 4 * 2 + m * H * 2
    return ops, nbytes


def launch_bound_s(m: int, H: int, I: int, peaks: dict) -> float:
    ops, nbytes = launch_work(m, H, I)
    return max(ops / peaks["int8_ops"], nbytes / peaks["hbm_bytes"])
