"""Where the tensor-core K8 (or K7) kernel spends its time, phase by phase.

    python3 scripts/row_tc_phases.py [--kernel row|bias] [--seed N]

Builds copies of csrc/row_disentangled_attention_tc.cu (``--kernel row``,
the default) or csrc/bias_fused_attention_tc.cu (``--kernel bias``) cut
short with a `return` before the softmax ("scores": staging, the products
and the score adds) and before p.v ("scores + softmax"), the whole kernel
("full"), and the whole kernel with the accurate softmax of the CUDA-core
kernels ("accurate softmax": expf and a division per element in place of
ex2.approx and one reciprocal per row), and times each at [B, 12, 512, 64]
bf16 for B = 128 and 16 (CUDA events, median of 20, two turns; K7's biases
in the route's layout). The differences between cuts give each phase's
share. Needs a CUDA card and nvcc; the copies are built under
build/row_tc_phases/.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from gliclass.c_tpu_torch.ops import _build  # noqa: E402

CSRC = os.path.join(ROOT, "gliclass", "c_tpu_torch", "csrc")
# kernel -> (source, C entry, the line that starts p.v)
KERNELS = {"row": ("row_disentangled_attention_tc.cu", "gct_row_disentangled_attention_tc", "  // p.v: the warp's rows"),
           "bias": ("bias_fused_attention_tc.cu", "gct_bias_fused_attention_tc", "  // p.v: rows m0")}
SOFTMAX = "  // Exact softmax over each whole row"
FAST = ("const float inv = 1.f / warp_sum(sum);", "__expf(", "e[u] * inv")
ACCURATE = ("sum = warp_sum(sum);", "expf(", "e[u] / sum")


def variants(src: str, pv: str) -> dict:
    for marker in (SOFTMAX, pv, *FAST):
        if marker not in src:
            sys.exit(f"row_tc_phases: {marker!r} not found in the kernel source")
    accurate = src
    for old, new in zip(FAST, ACCURATE):
        accurate = accurate.replace(old, new)
    return {"scores": src.replace(SOFTMAX, "  return;\n" + SOFTMAX),
            "scores + softmax": src.replace(pv, "  return;\n" + pv),
            "full": src, "accurate softmax": accurate}


def build(srcs: dict, entry: str) -> dict:
    out = os.path.join(ROOT, "build", "row_tc_phases")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(srcs.items()):
        cu, so = os.path.join(out, f"v{i}.cu"), os.path.join(out, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen([_build._nvcc(), *_build._FLAGS, "-I", CSRC, "-shared", cu, "-o", so],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            sys.exit(f"row_tc_phases: {name} failed to build:\n{log}")
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="row")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("row_tc_phases: needs a CUDA card", flush=True)
        return 2
    source, entry, pv = KERNELS[args.kernel]
    with open(os.path.join(CSRC, source)) as f:
        fns = build(variants(f.read(), pv), entry)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    print(cs.smi_line(), flush=True)
    scale = (3 * 64) ** 0.5
    for B in (128, 16):
        out = torch.empty((B, 512, 12, 64), dtype=torch.bfloat16, device=dev)
        if args.kernel == "row":
            q, k, v, pk, pq, mask = cs.rel_inputs(gen, dev, B, 512, torch.bfloat16)
            tables = (pk.data_ptr(), pq.data_ptr())
        else:
            q, k, v, c2p, p2c, mask = cs.bias_inputs(gen, dev, B, 512, torch.bfloat16, True)
            tables = (c2p.data_ptr(), *c2p.stride(), p2c.data_ptr(), *p2c.stride())
        call = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], *tables, mask.data_ptr(), out.data_ptr(),
                B, 12, 512, 1.0 / scale, _build.stream_ptr(q))
        for turn in range(2):
            order = list(fns) if turn == 0 else list(fns)[::-1]
            times = {name: cs.time_ms(lambda fn=fns[name]: _build.check(fn(*call), name)) for name in order}
            print(f"[{B}, 12, 512, 64] bf16, turn {turn + 1}: " +
                  "; ".join(f"{name} {times[name]:.4f} ms" for name in fns), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
