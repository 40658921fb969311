"""The JAX package on the port's real-scale decoder artifacts, on the CPU:
the reference readings that ``chip_smoke.py`` phase 17 holds the card to.

    python3 scripts/realscale_jax_reference.py --root DIR [--variant qwen llama] [--port-cpu]

``DIR/torch/<variant>/tokenizer.json`` must hold the tokenizer the card's
host trained (the root of ``chip_smoke.start_decoder_builds`` keeps it):
``utils.realscale.ensure_realscale_bundle`` then builds the very bundle the
card built (its weights come from a fixed seed, its goldens from the port's
fp64 CPU forward), in ``DIR``. For each selftest of phase 17 with INT8
weights (fp32 ``--int8-dynamic``, bf16 ``--int8``, bf16 ``--int8-dynamic``)
and for bf16 alone: the JAX package's max |logit delta| against the goldens
(its forward on the golden records, jitted as its engine runs it; its own
``selftest`` inverts probabilities and cannot read these logits) and its
``selftest`` F1 gate (256 texts, its default causal route); with
``--port-cpu``, the port's ``cli selftest`` of the same flags on the CPU.
Prints one JSON line per variant.

Needs JAX, ``tokenizers`` and the JAX package: it runs where the tests run,
never on the card. A qwen or llama bundle takes 7-9 GB of disk and a few
minutes per F1 gate on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (selftest flags, compute dtype, quant mode)
MODES = ((["--dtype", "float32", "--int8-dynamic"], "float32", "int8-dynamic"),
         (["--int8"], "bfloat16", "int8"), (["--int8-dynamic"], "bfloat16", "int8-dynamic"),
         ([], "bfloat16", "none"))


def jax_readings(bundle: str, dtype: str, quant_mode: str) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gliclass.c_tpu.config import RuntimeConfig
    from gliclass.c_tpu.convert import bundle as JB
    from gliclass.c_tpu.models.gliclass import gliclass_forward
    from gliclass.c_tpu.ops.layers import act_quant
    from gliclass.c_tpu.pipeline import ZeroShotClassificationPipeline
    from gliclass.c_tpu.prompting import pack_prompts
    from gliclass.c_tpu.tokenization import PromptTokenizer
    from gliclass.c_tpu.utils.eval import int8_f1_gate

    cfg, tok = JB.load_config(bundle), PromptTokenizer.from_file(JB.tokenizer_path(bundle))
    params = jax.tree.map(jnp.asarray, JB.load_params(bundle, quantized=quant_mode != "none"))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    worst = 0.0
    for rec in JB.load_goldens(bundle):
        b = tok.encode_batch(pack_prompts(rec["texts"], rec["labels"], rec["same_labels"], rec["prompt_first"]),
                             max_length=rec["max_length"])
        n = max(len(l) for l in rec["labels"])
        with act_quant(quant_mode == "int8-dynamic"):
            logits = np.asarray(jax.jit(lambda p, i, m: gliclass_forward(p, i, m, cfg, n, jdt))(
                params, jnp.asarray(b.input_ids), jnp.asarray(b.attention_mask)))
        golden = np.asarray(rec["logits"], np.float64)
        real = golden > -9.99e3
        worst = max(worst, float(np.abs(logits[:, :golden.shape[1]] - golden)[real].max()))
    del params
    out = {"golden_max_abs_delta": worst}
    if quant_mode != "none":
        rt = RuntimeConfig(compute_dtype=dtype, quant_mode=quant_mode)
        pipe32 = ZeroShotClassificationPipeline.from_bundle(bundle, dataclasses.replace(rt, quant_mode="none"))
        gate = int8_f1_gate(pipe32, ZeroShotClassificationPipeline.from_bundle(bundle, rt), n_texts=256,
                            threshold=rt.threshold)
        out.update(f1_fp32=gate["f1_fp32"], f1_int8=gate["f1_int8"], f1_delta=gate["delta"],
                   max_prob_delta=gate["max_prob_delta"])
    gc.collect()
    return out


def port_cpu_selftest(bundle: str, flags: list) -> list:
    from gliclass.c_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["selftest", "--bundle", bundle, *flags], device="cpu")
    return [l for l in out.getvalue().splitlines() if "check" in l or "gate" in l]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="cache root holding torch/<variant>/tokenizer.json")
    ap.add_argument("--variant", nargs="+", default=["qwen", "llama"], choices=["qwen", "llama"])
    ap.add_argument("--port-cpu", action="store_true", help="also the port's cli selftest on the CPU")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from gliclass.c_tpu_torch.utils import realscale as R

    for variant in args.variant:
        bundle = R.ensure_realscale_bundle(root=args.root, variant=variant)
        rec = {"variant": variant, "tokenizer_sha256": R.hashlib.sha256(
            open(os.path.join(bundle, "tokenizer.json"), "rb").read()).hexdigest(), "selftests": []}
        for flags, dtype, quant_mode in MODES:
            t0 = time.perf_counter()
            run = {"flags": flags, "jax": jax_readings(bundle, dtype, quant_mode)}
            if args.port_cpu:
                run["port_cpu"] = port_cpu_selftest(bundle, flags)
            run["s"] = time.perf_counter() - t0
            print(json.dumps(run), file=sys.stderr, flush=True)
            rec["selftests"].append(run)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
