"""Time K6 (absolute position table) and K9 (windowed position tables) on the
card three ways.

    python3 scripts/k6_k9_times.py [--seed N]

For each shape it times, on the same bf16 table: the wrapper (which
allocates the output and reaches the launch through ctypes), the C entry
with its arguments and output built once (CUDA events, median of 20 calls
after 3 warm-ups; both include the host's time to reach the launch), and the
device time per call of the kernel alone (torch.profiler over 20 calls).
Beside them: one PyTorch gather of the same values (yardstick only) and the
byte bound (the table read once, the output written once, at 3.35 TB/s).
Each kernel's output is first checked equal to its plain version. K6 at
gliclass-base's h = 12, d = 64 for S = 56, 72, 88, 128 (the serve path's
short buckets) and 512; K9 at [12, 512, blk 32, 64], the tiled route's
shape.
Prints the card line and one JSON line, times in ms.

The package comes from the first ``gliclass`` on ``sys.path``, so two
source trees can be timed in turns in one call on one card:

    PYTHONPATH=OTHER_TREE python3 scripts/k6_k9_times.py   # and again without

Needs torch and the CUDA toolkit; no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # chip_smoke, after PYTHONPATH


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    import chip_smoke as cs
    from gliclass.c_tpu_torch.ops import _build
    from gliclass.c_tpu_torch.ops import fused_attention as FA

    def device_ms(fn):
        return sum(cs.device_ms_by_kernel(fn).values()) or None

    dev = torch.device("cuda")
    print(f"package: {os.path.dirname(FA.__file__)}", flush=True)
    lib = _build.lib()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    h, d, bf16 = 12, 64, 1
    res = {}
    for S in (56, 72, 88, 128, 512):
        pos = torch.randn(h, 2 * S - 1, d, generator=gen, device=dev).to(torch.bfloat16)
        if not torch.equal(FA.abs_pos_table(pos, S), FA.abs_pos_table_plain(pos, S)):
            print(f"FAIL: K6 S={S} differs from its plain version", flush=True)
            return 1
        out = torch.empty(h, S, d, S, dtype=pos.dtype, device=dev)
        args_c = (bf16, pos.data_ptr(), out.data_ptr(), h, S, d, _build.stream_ptr(pos))
        entry = lambda: _build.check(lib.gct_abs_pos_table(*args_c), "K6")
        idx = FA.rel_index(S, dev)
        nbytes = (pos.numel() + out.numel()) * 2
        res[f"K6 S={S}"] = dict(
            wrapper_ms=cs.time_ms(lambda: FA.abs_pos_table(pos, S)), entry_ms=cs.time_ms(entry),
            device_ms=device_ms(entry), gather_ms=cs.time_ms(lambda: pos[:, idx]),
            bound_ms=cs.bound_ms(0.0, "bf16", nbytes)[0], mbytes=nbytes / 1e6)
        del out
    S, blk = 512, FA.TILED_BLK
    pos = torch.randn(h, 2 * S - 1, d, generator=gen, device=dev).to(torch.bfloat16)
    if not torch.equal(FA.windowed_pos_tables(pos, blk), FA.windowed_pos_tables_plain(pos, blk)):
        print("FAIL: K9 differs from its plain version", flush=True)
        return 1
    out = torch.empty(h, 2 * (S // blk) - 1, blk, blk, d, dtype=pos.dtype, device=dev)
    args_c = (bf16, pos.data_ptr(), out.data_ptr(), h, S, d, blk, _build.stream_ptr(pos))
    entry = lambda: _build.check(lib.gct_windowed_pos_table(*args_c), "K9")
    idx = FA._win_index(S, blk, dev).reshape(-1)
    nbytes = (pos.numel() + out.numel()) * 2
    res[f"K9 S={S} blk={blk}"] = dict(
        wrapper_ms=cs.time_ms(lambda: FA.windowed_pos_tables(pos, blk)), entry_ms=cs.time_ms(entry),
        device_ms=device_ms(entry), gather_ms=cs.time_ms(lambda: torch.index_select(pos, 1, idx)),
        bound_ms=cs.bound_ms(0.0, "bf16", nbytes)[0], mbytes=nbytes / 1e6)
    print(cs.smi_line(), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
