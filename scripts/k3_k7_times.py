"""Time K3 (INT8-weight matmul) and K7 (the bias route's softmax) on the card.

    python3 scripts/k3_k7_times.py [--seed N]

Runs each kernel's wrapper (bf16: the tensor-core variants) and the
CUDA-core variant's C entry on the same bf16 inputs, at the shapes
chip_smoke.py times: K3 at qkv, o, up and down with M = 8192; K7 at
[128, 12, 512, 64] and [16, 12, 512, 64] in the route's bias layout. CUDA
events, median of 20 calls after 3 warm-ups. Prints the card line and one
JSON line of times in ms.

The package comes from the first ``gliclass`` on ``sys.path``, so two
source trees can be timed in turns in one call on one card:

    PYTHONPATH=OTHER_TREE python3 scripts/k3_k7_times.py   # and again without

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
    from gliclass.c_tpu_torch.ops import fused_attention as FA
    from gliclass.c_tpu_torch.ops import int8_matmul as IM
    from gliclass.c_tpu_torch.ops import _build
    from gliclass.c_tpu_torch.ops.quant import quantize_weight

    dev = torch.device("cuda")
    print(f"package: {os.path.dirname(FA.__file__)}", flush=True)
    _build.lib()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    res = {}
    for name, (M, K, N) in {"qkv": (8192, 768, 2304), "o": (8192, 768, 768), "up": (8192, 768, 3072),
                            "down": (8192, 3072, 768)}.items():
        w_q, scale = (torch.from_numpy(a).to(dev) for a in quantize_weight(
            rng.normal(0, 0.02, (K, N)).astype(np.float32)))
        bias = torch.from_numpy(rng.normal(0, 0.02, N).astype(np.float32)).to(dev)
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        out = IM.int8_matmul(x, w_q, scale, bias)
        ref = IM.int8_matmul_plain(x, w_q, scale, bias)
        cc_out = torch.empty_like(out)
        cc_args = (1, x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), bias.data_ptr(), cc_out.data_ptr(), M, N, K,
                   _build.stream_ptr(x))
        res[f"K3 {name}"] = dict(
            ms=cs.time_ms(lambda: IM.int8_matmul(x, w_q, scale, bias)),
            cuda_core_ms=cs.time_ms(lambda: _build.check(_build.lib().gct_int8_matmul(*cc_args), "K3")),
            max_abs_err=(out.float() - ref.float()).abs().max().item())
    scale = math.sqrt(64 * 3)
    for B in (128, 16):
        q, k, v, c2p, p2c, mask = cs.bias_inputs(gen, dev, B, 512, torch.bfloat16, True)
        out = FA.bias_fused_attention(q, k, v, c2p, p2c, mask, scale)
        ref = FA.bias_fused_attention_plain(q, k, v, c2p, p2c, mask, scale)
        res[f"K7 B={B} S=512"] = dict(
            ms=cs.time_ms(lambda: FA.bias_fused_attention(q, k, v, c2p, p2c, mask, scale)),
            cuda_core_ms=cs.cuda_core_bias_ms(q, k, v, c2p, p2c, mask, scale),
            max_abs_err=(out.float() - ref.float()).abs().max().item())
        del ref
        torch.cuda.empty_cache()
    res["K3 sum ms"] = sum(r["ms"] for n, r in res.items() if n.startswith("K3 "))
    res["K7 sum ms"] = sum(r["ms"] for n, r in res.items() if n.startswith("K7 "))
    print(cs.smi_line(), flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
