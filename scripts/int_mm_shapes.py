"""Which int8 product shapes ``torch._int_mm`` refuses on the card, and the
port's padded ``int_mm`` at each of them against an exact product.

    python3 scripts/int_mm_shapes.py

For each (M, K, N) it calls ``torch._int_mm`` on the operands as they are
and prints "runs" or the error it raised; then it calls
``gliclass.c_tpu_torch.ops.layers.int_mm`` (which pads) and compares it with
a float64 product on the card (exact: every partial sum is an integer below
2^53). Prints the card's name and power limit first. Exits non-zero without
a card, or if ``int_mm`` fails or is not exact at any shape.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Row counts around the one first refused (342), the smallest torch accepts
# (17), and main-path sizes; widths of the tiny test model (32), of
# gliclass-base (768), mixed, and ones that are not multiples of 8.
ROWS = (17, 20, 24, 28, 32, 64, 96, 100, 340, 341, 342, 343, 344, 345, 346, 348, 352, 1000, 1001, 1024, 8190,
        8192)
WIDTHS = ((32, 32), (768, 768), (32, 768), (768, 32), (64, 64), (96, 128), (256, 32), (8, 8), (16, 16), (40, 40))
OTHER = ((1, 32, 32), (16, 768, 768), (342, 36, 40), (344, 32, 36), (343, 100, 60), (352, 40, 40),
         (352, 104, 60))


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; this probe needs the card", flush=True)
        return 2
    from gliclass.c_tpu_torch.ops.layers import int_mm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(m, k, n) for k, n in WIDTHS for m in ROWS] + list(OTHER)
    bad = []
    refused = []
    for m, k, n in shapes:
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        try:
            torch._int_mm(a, b)
            torch.cuda.synchronize()
            raw = "runs"
        except RuntimeError as e:
            raw = "refused: " + str(e).strip().splitlines()[0][:120]
            refused.append((m, k, n))
        try:
            got = int_mm(a, b)
            torch.cuda.synchronize()
            want = (a.double() @ b.double()).to(torch.int64)
            exact = got.dtype == torch.int32 and got.shape == (m, n) and torch.equal(got.to(torch.int64), want)
            padded = "exact" if exact else "NOT EXACT"
        except RuntimeError as e:
            exact, padded = False, "failed: " + str(e).strip().splitlines()[0][:120]
        if not exact:
            bad.append((m, k, n))
        print(f"M={m:5d} K={k:4d} N={n:4d}: torch._int_mm {raw} | int_mm (padded) {padded}", flush=True)
    print(f"torch._int_mm refused {len(refused)} of {len(shapes)} shapes: {refused}", flush=True)
    if bad:
        print(f"FAIL: int_mm failed or was not exact at {bad}", flush=True)
        return 1
    print(f"int_mm exact at all {len(shapes)} shapes", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
