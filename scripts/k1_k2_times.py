"""Time K1 (flash disentangled attention) and K2 (fused w8a8 FFN) on the card,
each variant three ways.

    python3 scripts/k1_k2_times.py [--seed N]

For each shape it times, on the same bf16 inputs: the wrapper (which sends
these shapes to the tensor-core variant), the tensor-core variant's C entry
with its arguments built once, and the CUDA-core variant's C entry (CUDA
events, median of 20 calls after 3 warm-ups; a call through the wrapper or
a C entry includes the host's time to reach the launch); then the device
time per call of each variant's kernels (torch.profiler over 20 calls, by
kernel: K2's tensor-core variant is four launches). K1 at the four shapes the
gliclass-base main path sends it ([128, 56], [128, 72], [64, 56], [32, 72])
and at [128, 128] and [16, 512], with SDPA on the summed biases beside it
(yardstick only, chip_smoke.sdpa_rel_ms); K2 at gliclass-base's M = 8192,
2304 ([32, 72]) and 11264 ([128, 88]), H = 768, I = 3072, with the [N, K]
weights made once as the engine makes them. Prints the card line and one
JSON line, times in ms.

The package comes from the first ``gliclass`` on ``sys.path``, so two
source trees can be timed in turns in one call on one card:

    PYTHONPATH=OTHER_TREE python3 scripts/k1_k2_times.py   # and again without

Needs torch, numpy and the CUDA toolkit; no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import numpy as np
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
    device_ms = cs.device_ms_by_kernel
    from gliclass.c_tpu_torch.ops import _build
    from gliclass.c_tpu_torch.ops import fused_attention as FA
    from gliclass.c_tpu_torch.ops import fused_ffn as FF
    from gliclass.c_tpu_torch.ops.quant import quantize_weight

    dev = torch.device("cuda")
    print(f"package: {os.path.dirname(FA.__file__)}", flush=True)
    lib = _build.lib()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    res = {}
    h, d = 12, 64
    scale = math.sqrt(3 * d)
    for B, S in ((128, 56), (128, 72), (64, 56), (32, 72), (128, 128), (16, 512)):
        q, k, v, pk, pq, mask = cs.rel_inputs(gen, dev, B, S, torch.bfloat16)
        out = torch.empty((B, S, h, d), dtype=torch.bfloat16, device=dev)
        common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], pk.data_ptr(), pq.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), B, h, S, 1.0 / scale, _build.stream_ptr(q))
        has_tc = hasattr(lib, "gct_flash_disentangled_attention_tc")  # an older tree has no tensor-core K1
        tc = lambda: _build.check(lib.gct_flash_disentangled_attention_tc(*common), "K1 tc")
        cc = lambda: _build.check(lib.gct_flash_disentangled_attention(1, *common), "K1 cc")
        res[f"K1 B={B} S={S}"] = dict(
            wrapper_ms=cs.time_ms(lambda: FA.flash_disentangled_attention(q, k, v, pk, pq, mask, scale)),
            tc_entry_ms=cs.time_ms(tc) if has_tc else None, cuda_core_entry_ms=cs.time_ms(cc),
            sdpa_ms=cs.sdpa_rel_ms(q, k, v, pk, pq, mask, scale),
            tc_device_ms=device_ms(tc) if has_tc else None, cuda_core_device_ms=device_ms(cc))
    H, I = 768, 3072
    wu, su = (torch.from_numpy(a).to(dev) for a in quantize_weight(rng.normal(0, 0.02, (H, I)).astype(np.float32)))
    wd, sd = (torch.from_numpy(a).to(dev) for a in quantize_weight(rng.normal(0, 0.02, (I, H)).astype(np.float32)))
    bu = torch.from_numpy(rng.normal(0, 0.02, I).astype(np.float32)).to(dev)
    bd = torch.from_numpy(rng.normal(0, 0.02, H).astype(np.float32)).to(dev)
    has_tc = hasattr(FF, "nk_weight")
    wt = dict(wt_up=FF.nk_weight(wu), wt_dn=FF.nk_weight(wd)) if has_tc else {}
    for M in (8192, 32 * 72, 128 * 88):
        x = torch.randn(M, H, generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty_like(x)
        ptrs = (x.data_ptr(), wu.data_ptr(), su.data_ptr(), bu.data_ptr(), wd.data_ptr(), sd.data_ptr(), bd.data_ptr())
        cc = lambda: _build.check(lib.gct_fused_ffn_w8a8(*ptrs, out.data_ptr(), M, H, I, _build.stream_ptr(x)),
                                  "K2 cc")
        rec = dict(wrapper_ms=cs.time_ms(lambda: FF.fused_ffn_w8a8(x, wu, su, bu, wd, sd, bd, "gelu", **wt)),
                   cuda_core_entry_ms=cs.time_ms(cc), cuda_core_device_ms=device_ms(cc))
        if has_tc:
            tc_args, scratch = FF.w8a8_tc_args(x, wt["wt_up"], su, bu, wt["wt_dn"], sd, bd, out)
            tc = lambda: _build.check(lib.gct_fused_ffn_w8a8_tc(*tc_args), "K2 tc")
            rec.update(tc_entry_ms=cs.time_ms(tc), tc_device_ms=device_ms(tc))
        res[f"K2 M={M}"] = rec
    print(cs.smi_line(), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
