"""How far a decoder bundle's fp32 goldens move with the host CPU's code paths.

    python3 scripts/golden_host_spread.py [--variant qwen|llama] [--layers N] [--tiny]

A bundle's goldens are the port's fp32 logits on the host CPU
(``convert.forward_golden_logits``), and ``selftest --dtype float32`` holds
the card's logits to them at 1e-3. At the qwen and llama real-scale widths
the goldens reach |logit| 38, where the CPU libraries' choice of code path
(AVX2 or AVX-512 kernels, threads) moves the last bits of every sum. This
script builds the variant's config at full widths and depth (random init,
seed 0, as ``utils.realscale.write_bundle``) with a 4,000-piece BPE trained
here in place of the full vocabulary, computes the goldens on the CPU once
for each environment of :data:`SETTINGS` (each in a subprocess, since the
libraries read them when they start), in fp32 and in fp64 (the goldens
``utils.realscale`` records for a decoder), and, where a card is present, the
same records' fp32 logits on the card: through the golden function and
through the selftest's own path (``pipeline.predict_logits``). It prints
the max |delta| of every pair over the real label slots. ``--tiny`` shrinks
the widths for a rehearsal on a small CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# Goldens of the golden subprocess: (its environment, the goldens' dtype).
# fp32 in the host's default, in the code paths another host may take (AVX2
# where this one has AVX-512; one thread), and in MKL's and ATen's
# instruction-set-independent modes; fp64 (``utils.realscale``'s for a
# decoder) in the default and in the most different of those.
_AVX2 = {"ATEN_CPU_CAPABILITY": "avx2", "MKL_ENABLE_INSTRUCTIONS": "AVX2"}
_ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
_COMPATIBLE = {"MKL_CBWR": "COMPATIBLE", "ATEN_CPU_CAPABILITY": "default"}
SETTINGS = {
    "default": ({}, "float32"),
    "avx2": (_AVX2, "float32"),
    "one_thread": (_ONE_THREAD, "float32"),
    "compatible": (_COMPATIBLE, "float32"),
    "fp64": ({}, "float64"),
    "fp64_compatible_one_thread": (dict(_COMPATIBLE, **_ONE_THREAD), "float64"),
}

CHILD = r"""
import json, sys, time
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
import golden_host_spread as G
cfg, params, ptok = G.load(sys.argv[2])
t0 = time.perf_counter()
logits = G.goldens(cfg, params, ptok, "cpu", sys.argv[4])
info = {"s": time.perf_counter() - t0, "capability": torch.backends.cpu.get_cpu_capability(),
        "threads": torch.get_num_threads()}
np.savez(sys.argv[3], *logits)
print("INFO " + json.dumps(info), flush=True)
"""


def config(variant: str, layers: int | None, tiny: bool, ptok):
    from gliclass.c_tpu_torch.config import GLiClassConfig
    from gliclass.c_tpu_torch.utils import realscale as R

    _, _, bb, name, hidden = R.variant_spec(variant)
    bb = dataclasses.replace(bb, vocab_size=ptok._tok.get_vocab_size())
    if layers:
        bb = dataclasses.replace(bb, num_hidden_layers=layers)
    if tiny:
        bb = dataclasses.replace(bb, hidden_size=64, intermediate_size=128, num_attention_heads=4,
                                 num_key_value_heads=2 if bb.num_key_value_heads < bb.num_attention_heads else 4)
        hidden = 64
    return GLiClassConfig(original_model_name=name, hidden_size=hidden, prompt_first=True,
                          class_token_index=ptok.label_token_id, text_token_index=ptok.sep_token_id, backbone=bb)


def load(work: str):
    """The config, params (CPU tensors) and tokenizer saved in ``work``."""
    import torch

    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    ptok = PromptTokenizer.from_file(os.path.join(work, "tokenizer.json"))
    cfg = config(spec["variant"], spec["layers"], spec["tiny"], ptok)
    params = torch.load(os.path.join(work, "params.pt"), mmap=True)
    return cfg, params, ptok


def goldens(cfg, params, ptok, device: str, dtype: str = "float32") -> list:
    from gliclass.c_tpu_torch.convert.convert import forward_golden_logits
    from gliclass.c_tpu_torch.utils.realscale import GOLDEN_SAMPLES

    return [np.asarray(forward_golden_logits(cfg, params, ptok, t, l, s, device=device, dtype=dtype)["logits"])
            for t, l, s in GOLDEN_SAMPLES]


def selftest_logits(cfg, params, ptok, ref: list) -> list:
    """The card's logits of the golden records through the selftest's path."""
    from gliclass.c_tpu_torch.config import RuntimeConfig
    from gliclass.c_tpu_torch.engine import InferenceEngine
    from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline
    from gliclass.c_tpu_torch.utils.realscale import GOLDEN_SAMPLES

    rt = RuntimeConfig(max_length=1024, compute_dtype="float32")
    pipe = ZeroShotClassificationPipeline(InferenceEngine(cfg, params, rt, device="cuda"), ptok, rt, prompt_first=True)
    return [pipe.predict_logits(t, l, s)[:, :r.shape[1]] for (t, l, s), r in zip(GOLDEN_SAMPLES, ref)]


def max_delta(a: list, b: list) -> float:
    out = 0.0
    for x, y in zip(a, b):
        real = (x > -9.99e3) & (y > -9.99e3)
        out = max(out, float(np.abs(x.astype(np.float64) - y.astype(np.float64))[real].max()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", default="qwen", choices=("qwen", "llama"))
    ap.add_argument("--layers", type=int, default=None, help="depth (default: the variant's)")
    ap.add_argument("--tiny", action="store_true", help="narrow widths, for a rehearsal on the CPU")
    args = ap.parse_args()

    import torch

    from gliclass.c_tpu_torch.models.gliclass import init_gliclass_params
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer
    from gliclass.c_tpu_torch.utils import realscale as R

    cpu = subprocess.run(["sh", "-c", "grep -m1 'model name' /proc/cpuinfo; nproc"], capture_output=True, text=True)
    print(f"host: {' '.join(cpu.stdout.split())}; torch {torch.__version__}", flush=True)
    shm = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(prefix="golden_spread_", dir=shm) as work:
        R.build_realscale_tokenizer(os.path.join(work, "tokenizer.json"), vocab_size=4000, max_mb=4)
        with open(os.path.join(work, "spec.json"), "w") as f:
            json.dump(vars(args), f)
        ptok = PromptTokenizer.from_file(os.path.join(work, "tokenizer.json"))
        cfg = config(args.variant, args.layers, args.tiny, ptok)
        params = init_gliclass_params(torch.Generator().manual_seed(0), cfg)
        torch.save(params, os.path.join(work, "params.pt"))
        print(f"{args.variant}: {cfg.backbone.num_hidden_layers} layers, hidden {cfg.backbone.hidden_size}, "
              f"vocab {cfg.backbone.vocab_size}", flush=True)
        got = {}
        for name, (env, dtype) in SETTINGS.items():
            out = os.path.join(work, f"{name}.npz")
            env = dict(os.environ, PYTHONPATH=ROOT, **env)
            st = subprocess.run([sys.executable, "-c", CHILD, os.path.dirname(os.path.abspath(__file__)), work, out,
                                 dtype], env=env, capture_output=True, text=True, timeout=900)
            if st.returncode != 0:
                print(f"{name}: exit {st.returncode}: {st.stderr[-2000:]}", flush=True)
                continue
            info = json.loads(next(l for l in st.stdout.splitlines() if l.startswith("INFO "))[5:])
            with np.load(out) as z:
                got[name] = [z[k] for k in sorted(z.files, key=lambda k: int(k.split("_")[1]))]
            print(f"{name} {json.dumps(SETTINGS[name])}: {info['s']:.2f} s, capability {info['capability']}, "
                  f"{info['threads']} threads", flush=True)
        ref = got["default"]
        print(f"max |golden| {max(float(np.abs(x[x > -9.99e3]).max()) for x in ref):.4f}", flush=True)
        if torch.cuda.is_available():
            t0 = time.perf_counter()
            got["card"] = goldens(cfg, params, ptok, "cuda")
            got["card_selftest_path"] = selftest_logits(cfg, params, ptok, ref)
            print(f"card ({torch.cuda.get_device_name(0)}): {time.perf_counter() - t0:.1f} s", flush=True)
        names = list(got)
        print("max |delta| between each pair (real label slots):", flush=True)
        for i, a in enumerate(names):
            print(f"  {a:>20}: " + " ".join(f"{b}={max_delta(got[a], got[b]):.6f}" for b in names[i + 1:]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
