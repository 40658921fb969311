"""Build the port's real-scale bundles and check each on the card and
with the plain versions on the host.

    python3 scripts/realscale_build.py [--variant base small large qwen llama]
                                       [--root DIR]

For each variant, ``utils.realscale.ensure_realscale_bundle`` in a fresh
cache (a temporary directory, removed at the end, unless ``--root`` names
one; a tokenizer already at ``DIR/torch/...`` is used as it is): the
tokenizer training (files, bytes, distinct words, pieces, sha256, the
seconds of listing, counting, merging and writing, on one host thread),
the bundle (the seconds of init, quantize, goldens and writing; bytes) and
the whole build's wall time. Then ``cli selftest --bundle B`` in this
process: on the card with ``--dtype float32``, in bf16, with
``--int8-dynamic`` and with ``--int8``, the launches of each kernel counted
over each (K1/K1' for the DeBERTa variants, K5/K5' for qwen and llama);
on the host CPU (every op's plain version) in bf16 and with
``--int8-dynamic``, the witness that tells a kernel's error from the
artifact's; and the goldens' range beside the card's fp32 logits of the
same records outside the pipeline. Prints the card line, one JSON line per
variant and a last JSON line with all of them; exits 1 if a selftest did.

Needs torch, numpy, the card and the CUDA toolkit; no JAX, no
``tokenizers``, no network.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # chip_smoke, after PYTHONPATH

REPORTS = ("[realscale] tokenizer: ", "[realscale] bundle: ")
# (device, flags): fp32 on the card (the golden gate; K1 and K5 on CUDA
# cores), bf16 and both INT8 modes on the card (K1'-K5' on tensor cores),
# and bf16 and w8a8 with the plain versions on the host CPU.
SELFTESTS = (("cuda", ["--dtype", "float32"]), ("cuda", []), ("cuda", ["--int8-dynamic"]), ("cuda", ["--int8"]),
             ("cpu", []), ("cpu", ["--int8-dynamic"]))


def build(root: str, variant: str) -> dict:
    from gliclass.c_tpu_torch.utils import realscale as R

    msgs: list = []

    def log(m: str) -> None:
        msgs.append(m)
        print(m, file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    bundle = R.ensure_realscale_bundle(root=root, log=log, variant=variant)
    rec = {"variant": variant, "bundle": bundle, "build_s": time.perf_counter() - t0}
    for key, prefix in zip(("tokenizer", "bundle_build"), REPORTS):
        rec[key] = next((json.loads(m[len(prefix):]) for m in msgs if m.startswith(prefix)), None)
    return rec


def selftest(bundle: str, device: str, flags: list) -> dict:
    """``cli selftest --bundle B *flags`` in this process on ``device``,
    with the launches of each kernel over it."""
    import chip_smoke as C
    import torch

    from gliclass.c_tpu_torch.ops import _build

    _build.lib()
    C.reset_counts()
    t0 = time.perf_counter()
    rc, out, err = C.run_cli_here(["selftest", "--bundle", bundle, *flags], torch.device(device))
    return {"device": device, "flags": flags, "rc": rc, "s": time.perf_counter() - t0,
            "gates": [l for l in out.splitlines() if "check" in l or "gate" in l] or [err[-500:]],
            "launches": {k: v for k, v in C.read_counts().items() if v}}


def golden_logits_on_card(bundle: str) -> dict:
    """The bundle's goldens against the same records computed by the port
    in fp32 on the card (``forward_golden_logits(..., device="cuda")``),
    logit against logit outside the pipeline (no seq or row buckets); and
    the goldens' range."""
    import numpy as np

    from gliclass.c_tpu_torch.convert import bundle as B
    from gliclass.c_tpu_torch.convert.convert import forward_golden_logits
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    cfg, params = B.load_config(bundle), B.load_params(bundle)
    tok = PromptTokenizer.from_file(B.tokenizer_path(bundle))
    want, got = [], []
    for rec in B.load_goldens(bundle):
        card = forward_golden_logits(cfg, params, tok, rec["texts"], rec["labels"], rec["same_labels"],
                                     rec["prompt_first"], rec["max_length"], device="cuda")
        want.append(np.asarray(rec["logits"], dtype=np.float64).ravel())
        got.append(np.asarray(card["logits"], dtype=np.float64).ravel())
    want, got = np.concatenate(want), np.concatenate(got)
    finite = np.isfinite(want) & np.isfinite(got)
    delta = np.abs(want - got)[finite]
    return {"golden_min": float(want.min()), "golden_max": float(want.max()),
            "non_finite": int((~finite).sum()), "card_fp32_max_abs_delta": float(delta.max()) if delta.size else None,
            "card_fp32_max_rel_delta": float((delta / np.maximum(np.abs(want[finite]), 1.0)).max())
            if delta.size else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", nargs="+", default=["base"], choices=["base", "small", "large", "qwen", "llama"])
    ap.add_argument("--root", default=None, help="cache root (default: a temporary directory, removed)")
    args = ap.parse_args()

    import chip_smoke as C

    print(C.smi_line() if shutil.which("nvidia-smi") else "no nvidia-smi", flush=True)
    root = args.root or tempfile.mkdtemp(prefix="gliclass_realscale_")
    records, rc = [], 0
    try:
        for variant in args.variant:
            rec = build(root, variant)
            rec["selftests"] = [selftest(rec["bundle"], device, flags) for device, flags in SELFTESTS]
            rec["goldens"] = golden_logits_on_card(rec["bundle"])
            rc |= any(t["rc"] != 0 for t in rec["selftests"])
            if args.root is None:  # the tokenizers stay for the variants that share them
                shutil.rmtree(rec["bundle"], ignore_errors=True)
            print(json.dumps(rec), flush=True)
            records.append(rec)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"records": records}), flush=True)
    return int(rc)


if __name__ == "__main__":
    sys.exit(main())
