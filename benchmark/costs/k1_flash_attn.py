"""The bound of one disentangled-attention launch (K1) from its shape.

The work the model needs for ``rows`` sequences of ``seq`` tokens and
``heads`` heads of width ``d``: per query-key pair of each head, the content
score, the content-to-position and position-to-content terms and the
weighted value, each 2 * d bf16 operations. Bytes: q, k and v read once
(bf16), the two projected position tables the layer needs read once
(2 * buckets rows of heads * d, bf16), the key mask (int32) read once, the
output written once (bf16).
"""

NAMES = ("flash_da_tc_kernel", "flash_da_kernel")  # K1's tensor-core and CUDA-core kernels


def launch_work(rows: int, seq: int, heads: int, d: int, buckets: int) -> tuple[float, float]:
    """(bf16 operations, bytes) of one launch."""
    ops = 4 * 2 * rows * heads * seq * seq * d
    act = rows * heads * seq * d * 2
    nbytes = 3 * act + 2 * (2 * buckets) * heads * d * 2 + rows * seq * 4 + act
    return ops, nbytes


def launch_bound_s(rows: int, seq: int, heads: int, d: int, buckets: int, peaks: dict) -> float:
    ops, nbytes = launch_work(rows, seq, heads, d, buckets)
    return max(ops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes"])
