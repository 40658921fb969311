"""Time K4 (weight-only FFN) and K5 (causal GQA attention) on the card, each
variant three ways.

    python3 scripts/k4_k5_times.py [--seed N]

For each shape it times, on the same bf16 inputs: the wrapper (which sends
these shapes to the tensor-core variant), the tensor-core variant's C entry
with its arguments built once, and the CUDA-core variant's C entry (CUDA
events, median of 20 calls after 3 warm-ups; a call through the wrapper or
a C entry includes the host's time to reach the launch); then the device
time per call of each variant's kernels alone (torch.profiler over 20
calls; K4's tensor-core variant split into its up and down launches). K5 at
qwen-1.5B's [64, 128] and [16, 512] (nkv = 2, g = 6, d = 128), the Llama
geometry's [16, 512] (g = 1) and qwen's [64, 88]; K4 at gliclass-base's
M = 8192 and M = 64 x 56 (H = 768, I = 3072). Also SDPA with ``enable_gqa``
for K5 (yardstick only). Prints the card line and one JSON line, times in
ms.

The package comes from the first ``gliclass`` on ``sys.path``, so two
source trees can be timed in turns in one call on one card:

    PYTHONPATH=OTHER_TREE python3 scripts/k4_k5_times.py   # and again without

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
    from gliclass.c_tpu_torch.ops import causal_attention as CA
    from gliclass.c_tpu_torch.ops import fused_ffn as FF
    from gliclass.c_tpu_torch.ops.quant import quantize_weight

    dev = torch.device("cuda")
    print(f"package: {os.path.dirname(CA.__file__)}", flush=True)
    lib = _build.lib()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    res = {}
    d = 128
    for label, B, nkv, g, S in (("qwen", 64, 2, 6, 128), ("qwen", 16, 2, 6, 512), ("llama", 16, 16, 1, 512),
                                ("qwen", 64, 2, 6, 88)):
        nh = nkv * g
        qg = torch.randn(B, S, nh * d, generator=gen, device=dev).to(torch.bfloat16).reshape(
            B, S, nkv, g, d).permute(0, 2, 3, 1, 4)
        k, v = (torch.randn(B, nkv, S, d, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lengths[0] = S
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
        scale = 1.0 / math.sqrt(d)
        out = torch.empty((B, S, nh, d), dtype=torch.bfloat16, device=dev)
        lens = (S, S, 0) if len(_build._SIGNATURES["gct_causal_flash_attention"]) > 23 else (S,)  # Sq, S, q_off
        common = (qg.data_ptr(), *qg.stride()[:4], k.data_ptr(), *k.stride()[:3], v.data_ptr(), *v.stride()[:3],
                  mask.data_ptr(), out.data_ptr(), B, nkv, g, *lens, d, scale, _build.stream_ptr(qg))
        tc = lambda: _build.check(lib.gct_causal_flash_attention_tc(*common), "K5 tc")
        cc = lambda: _build.check(lib.gct_causal_flash_attention(1, *common), "K5 cc")
        q4 = qg.reshape(B, nh, S, d)
        amask = torch.ones(S, S, dtype=torch.bool, device=dev).tril()[None, None] & (mask > 0)[:, None, None, :]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q4, k, v, attn_mask=amask, enable_gqa=True)
        res[f"K5 {label} B={B} S={S}"] = dict(
            wrapper_ms=cs.time_ms(lambda: CA.causal_flash_attention(qg, k, v, mask, scale)),
            tc_entry_ms=cs.time_ms(tc), cuda_core_entry_ms=cs.time_ms(cc), sdpa_ms=cs.time_ms(sdpa),
            tc_device_ms=device_ms(tc), cuda_core_device_ms=device_ms(cc), sdpa_device_ms=device_ms(sdpa))
    H, I = 768, 3072
    wu, su = (torch.from_numpy(a).to(dev) for a in quantize_weight(rng.normal(0, 0.02, (H, I)).astype(np.float32)))
    wd, sd = (torch.from_numpy(a).to(dev) for a in quantize_weight(rng.normal(0, 0.02, (I, H)).astype(np.float32)))
    bu = torch.from_numpy(rng.normal(0, 0.02, I).astype(np.float32)).to(dev)
    bd = torch.from_numpy(rng.normal(0, 0.02, H).astype(np.float32)).to(dev)
    for M in (8192, 64 * 56):
        x = torch.randn(M, H, generator=gen, device=dev).to(torch.bfloat16)
        hbuf, out = torch.empty(M, I, dtype=torch.bfloat16, device=dev), torch.empty_like(x)
        ptrs = (x.data_ptr(), wu.data_ptr(), su.data_ptr(), bu.data_ptr(), wd.data_ptr(), sd.data_ptr(), bd.data_ptr())
        tc = lambda: _build.check(lib.gct_fused_ffn_wonly_tc(*ptrs, hbuf.data_ptr(), out.data_ptr(), M, H, I,
                                                             _build.stream_ptr(x)), "K4 tc")
        cc = lambda: _build.check(lib.gct_fused_ffn_wonly(*ptrs, out.data_ptr(), M, H, I, _build.stream_ptr(x)),
                                  "K4 cc")
        res[f"K4 M={M}"] = dict(
            wrapper_ms=cs.time_ms(lambda: FF.fused_ffn_wonly(x, wu, su, bu, wd, sd, bd, "gelu")),
            tc_entry_ms=cs.time_ms(tc), cuda_core_entry_ms=cs.time_ms(cc),
            tc_device_ms=device_ms(tc), cuda_core_device_ms=device_ms(cc))
    print(cs.smi_line(), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
