"""Published peaks of the chips the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM5 data sheet, dense rates (no sparsity), at the full 700 W
power limit: 989 TFLOP/s bf16 on the tensor cores, 1,979 TOP/s int8,
3.35 TB/s of HBM3 bandwidth.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "int8_ops": 1979e12, "hbm_bytes": 3.35e12},
}


def peaks_for(device_name: str) -> dict | None:
    """The peaks of ``device_name``, or None for a chip the table lacks (a
    reader then reports nothing rather than a share of an unknown peak)."""
    return PEAKS.get(device_name)
