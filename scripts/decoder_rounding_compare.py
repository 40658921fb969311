"""The port's bf16 w8a8 decoder against the JAX package's, on the CPU, at
qwen-1.5B widths (H 1536, 12/2 heads, I 8960).

    python3 scripts/decoder_rounding_compare.py ops [--layers 1]
    python3 scripts/decoder_rounding_compare.py layers [--layers 28]
    python3 scripts/decoder_rounding_compare.py bundle --dir DIR [--layers 28]

``ops``: one layer's blocks and the head's projector fed the same bf16
inputs in both packages (the JAX side jitted, as its engine compiles it):
for each, max |delta|, the share of outputs that differ and the share more
than one bf16 step (at the JAX value) apart. ``layers``: 8 texts of 40
tokens (3 label tokens each, prompt last); the states of every layer at the pooled token
(position 0) and at the label tokens, port against the JAX package's
flash route, the JAX package's flash route against its XLA route, and each
against the port's fp32 (unquantized weights); then the probabilities.
``bundle``: a bundle by ``utils.realscale.write_bundle`` (4,000-piece BPE
over 4 MiB of local files, the given depth) in DIR, both packages'
``cli selftest --int8-dynamic`` on it, and ``predict_probs`` of the eval
set's first 64 texts in fp32 and in bf16 w8a8 (the JAX package on its
flash and XLA routes). Weights: the JAX package's ``init_gliclass_params
(jax.random.key(0))`` and ``quantize_tree`` (``ops``, ``layers``).

Needs JAX and the JAX package; runs where the tests run, never on the card.
At depth 28 ``layers`` holds about 10 GB and takes a few minutes; ``bundle``
writes 6.8 GB and takes about 15 minutes.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLASS_TOKEN = 7


def _models(layers: int):
    import jax
    import numpy as np

    from gliclass.c_tpu import config as jcfg
    from gliclass.c_tpu.models.gliclass import init_gliclass_params
    from gliclass.c_tpu.ops.quant import quantize_tree
    from gliclass.c_tpu_torch import config as tcfg
    from gliclass.c_tpu_torch.convert.params import params_from_numpy

    kw = dict(dataclasses.asdict(jcfg.qwen2_config("1.5b")), vocab_size=200, num_hidden_layers=layers)
    g = dict(hidden_size=1536, class_token_index=CLASS_TOKEN, prompt_first=False)
    jc = jcfg.GLiClassConfig(backbone=jcfg.BackboneConfig(**kw), **g)
    tc = tcfg.GLiClassConfig(backbone=tcfg.BackboneConfig(**kw), **g)
    params = jax.tree.map(np.asarray, init_gliclass_params(jax.random.key(0), jc))
    q = jax.tree.map(np.asarray, quantize_tree(params))
    return jc, tc, params, q, params_from_numpy(params, "cpu"), params_from_numpy(q, "cpu")


def _batch(n=8, s=40, labels=3, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 190, size=(n, s)).astype(np.int32)
    mask = np.zeros((n, s), dtype=np.int32)
    for i in range(n):
        mask[i, :s - 3 * i] = 1
        for k in range(labels):
            ids[i, s - 3 * i - 2 - 2 * k] = CLASS_TOKEN
    ids[mask == 0] = 0
    return ids, mask


def _diff(name, got, want):
    import numpy as np

    d = np.abs(got - want)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)  # one bf16 step at each value
    print(f"{name:30s} max|d| {d.max():.3e}  /max|jax| {d.max() / np.abs(want).max():.3e}  "
          f"differ {np.mean(d > 0):.4%}  more than one bf16 step {np.mean(d > step):.4%}", flush=True)


def ops(layers: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from gliclass.c_tpu.models import heads as jheads
    from gliclass.c_tpu.models import llama as jllama
    from gliclass.c_tpu.ops import layers as jl
    from gliclass.c_tpu_torch.models import heads as theads
    from gliclass.c_tpu_torch.models import llama as tllama
    from gliclass.c_tpu_torch.ops import layers as tl

    os.environ["GLICLASS_TPU_CAUSAL_ATTN"] = "flash"
    jc, tc, _, q, _, tq = _models(layers)
    jq = jax.tree.map(jnp.asarray, q)
    lj = jax.tree.map(lambda a: a[0], jq["backbone"]["layers"])
    lt = tllama._layer(tq["backbone"]["layers"], 0)
    ids, mask = _batch()
    bf, eps, S = jnp.bfloat16, jc.backbone.rms_norm_eps, ids.shape[1]

    def f32(a):
        return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a).astype(jnp.float32))

    def T(a):
        return torch.from_numpy(np.array(f32(a))).to(torch.bfloat16)

    x = jnp.take(jq["backbone"]["embeddings"]["word"], jnp.asarray(ids), axis=0).astype(bf)
    cos, sin = (jnp.asarray(t) for t in jllama.rope_tables(S, jc.backbone.head_dim, jc.backbone.rope_theta))
    ct, st = tllama.rope_device(S, tc.backbone.head_dim, float(tc.backbone.rope_theta), "cpu")
    with jl.act_quant(True), tl.act_quant(True), torch.inference_mode():
        a = jax.jit(lambda x: jl.rms_norm(lj["attn_norm"], x, eps))(x)
        _diff("attn_norm", f32(tl.rms_norm(lt["attn_norm"], T(x), eps)), f32(a))
        _diff("q linear (w8a8)", f32(tl.linear(lt["attn"]["q"], T(a), torch.bfloat16)),
              f32(jax.jit(lambda a: jl.linear(lj["attn"]["q"], a, bf))(a)))
        o = jax.jit(lambda a: jllama.llama_attention(lj["attn"], a, None, cos, sin, jc.backbone, bf,
                                                     attention_mask=jnp.asarray(mask)))(a)
        _diff("attention block (flash)", f32(tllama.llama_attention(
            lt["attn"], T(a), torch.from_numpy(mask), ct, st, tc.backbone, torch.bfloat16)), f32(o))
        m = jax.jit(lambda x, o: jl.rms_norm(lj["mlp_norm"], x + o, eps))(x, o)
        _diff("mlp_norm(x + attn)", f32(tl.rms_norm(lt["mlp_norm"], T(x), eps, residual=T(o))), f32(m))
        _diff("  the norm of the rounded sum", f32(tl.rms_norm(lt["mlp_norm"], T(x) + T(o), eps)), f32(m))
        _diff("mlp block (SwiGLU)", f32(tllama.llama_mlp(lt["mlp"], T(m), torch.bfloat16)),
              f32(jax.jit(lambda m: jllama.llama_mlp(lj["mlp"], m, bf))(m)))
        h = jax.jit(lambda i, k: jllama.llama_encode(jq["backbone"], i, k, jc.backbone, bf))(
            jnp.asarray(ids), jnp.asarray(mask))
        _diff(f"final state ({layers} layers)", f32(tllama.llama_encode(
            tq["backbone"], torch.from_numpy(ids), torch.from_numpy(mask), tc.backbone, torch.bfloat16)), f32(h))
        for name in ("text_projector", "classes_projector"):
            _diff(name, f32(theads.features_projector(tq["head"][name], T(h)[:, 0], "gelu", torch.bfloat16)),
                  f32(jax.jit(lambda h: jheads.features_projector(jq["head"][name], h[:, 0], "gelu", bf))(h)))


def layers_cmp(layers: int) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from gliclass.c_tpu.models import llama as jllama
    from gliclass.c_tpu.models.gliclass import gliclass_probs as jprobs
    from gliclass.c_tpu.ops.layers import act_quant as jaq
    from gliclass.c_tpu_torch.models import llama as tllama
    from gliclass.c_tpu_torch.models.gliclass import gliclass_probs as tprobs
    from gliclass.c_tpu_torch.ops.layers import act_quant as taq

    jc, tc, _, q, tp, tq = _models(layers)
    ids, mask = _batch()
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)

    def port(p, dtype, act, states):
        with torch.inference_mode(), taq(act):
            if states:
                return tllama.llama_encode(p["backbone"], ti, tm, tc.backbone, dtype, return_all_layers=True).float()
            return tprobs(p, ti, tm, tc, 4, dtype).numpy()

    def jax_(route, states):
        os.environ["GLICLASS_TPU_CAUSAL_ATTN"] = route
        jq = jax.tree.map(jnp.asarray, q)
        with jaq(True):
            if states:
                f = jax.jit(lambda p, i, m: jllama.llama_encode(p, i, m, jc.backbone, jnp.bfloat16,
                                                                return_all_layers=True))
                return np.asarray(f(jq["backbone"], jnp.asarray(ids), jnp.asarray(mask)).astype(jnp.float32))
            f = jax.jit(lambda p, i, m: jprobs(p, i, m, jc, 4, jnp.bfloat16))
            return np.asarray(f(jq, jnp.asarray(ids), jnp.asarray(mask)))

    f32, pt = port(tp, torch.float32, False, True).numpy(), port(tq, torch.bfloat16, True, True).numpy()
    jf, jx = jax_("flash", True), jax_("xla", True)
    sels = {"pooled": np.zeros_like(mask, bool), "label": ids == CLASS_TOKEN}
    sels["pooled"][:, 0] = True
    pairs = (("port-jaxF", pt, jf), ("jaxF-jaxX", jf, jx), ("port-f32", pt, f32), ("jaxF-f32", jf, f32))
    print("layer  tokens  " + "  ".join(f"{n:>19s}" for n, _, _ in pairs) + "   (max, mean |d| / |b| per token)")
    for i in range(layers + 1):
        for sn, sel in sels.items():
            cells = []
            for _, a, b in pairs:
                d = np.abs(a[i] - b[i]).max(-1) / np.abs(b[i]).max(-1)
                cells.append(f"{d[sel].max():.3e}/{np.abs(a[i] - b[i])[sel].mean() / np.abs(b[i])[sel].mean():.3e}")
            print(f"{i:5d}  {sn:6s}  " + "  ".join(f"{c:>19s}" for c in cells), flush=True)
    p32, ppt = port(tp, torch.float32, False, False), port(tq, torch.bfloat16, True, False)
    pjf, pjx = jax_("flash", False), jax_("xla", False)
    for n, a, b in (("port-f32", ppt, p32), ("jaxF-f32", pjf, p32), ("jaxX-f32", pjx, p32),
                    ("port-jaxF", ppt, pjf), ("jaxF-jaxX", pjf, pjx)):
        d = np.abs(a - b)[:, :3]
        print(f"probabilities {n}: max {d.max():.4f} mean {d.mean():.4f}")


def bundle_cmp(directory: str, layers: int) -> None:
    import jax
    import numpy as np

    from gliclass.c_tpu.cli import main as jmain
    from gliclass.c_tpu.config import RuntimeConfig as JR
    from gliclass.c_tpu.pipeline import ZeroShotClassificationPipeline as JP
    from gliclass.c_tpu_torch.cli import main as tmain
    from gliclass.c_tpu_torch.config import GLiClassConfig, RuntimeConfig as TR, qwen2_config
    from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline as TP
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer
    from gliclass.c_tpu_torch.utils import realscale as R
    from gliclass.c_tpu_torch.utils.eval import synthetic_eval_set

    jax.config.update("jax_platforms", "cpu")
    tok = os.path.join(directory, "tokenizer.json")
    if not os.path.exists(tok):
        R.build_realscale_tokenizer(tok, vocab_size=4000, max_mb=4)
    bundle = os.path.join(directory, f"bundle{layers}")
    if not os.path.exists(os.path.join(bundle, "goldens.json")):
        ptok = PromptTokenizer.from_file(tok)
        bb = dataclasses.replace(qwen2_config("1.5b"), vocab_size=4000, num_hidden_layers=layers)
        cfg = GLiClassConfig(hidden_size=bb.hidden_size, prompt_first=True, class_token_index=ptok.label_token_id,
                             text_token_index=ptok.sep_token_id, backbone=bb)
        R.write_bundle(bundle, cfg, ptok)
    for name, run in (("port", lambda: tmain(["selftest", "--bundle", bundle, "--int8-dynamic"], device="cpu")),
                      ("JAX", lambda: jmain(["selftest", "--bundle", bundle, "--int8-dynamic"]))):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            run()
        print(f"{name} selftest --int8-dynamic: " + " | ".join(out.getvalue().strip().splitlines()), flush=True)
    texts, labels, _ = synthetic_eval_set(256, 0)
    texts, probs = texts[:64], {}
    probs["port fp32"] = TP.from_bundle(bundle, TR(compute_dtype="float32"), device="cpu").predict_probs(
        texts, [labels], True)
    probs["port w8a8"] = TP.from_bundle(bundle, TR(quant_mode="int8-dynamic"), device="cpu").predict_probs(
        texts, [labels], True)
    for route in ("flash", "xla"):
        os.environ["GLICLASS_TPU_CAUSAL_ATTN"] = route
        probs[f"JAX w8a8 {route}"] = np.asarray(JP.from_bundle(bundle, JR(quant_mode="int8-dynamic")).predict_probs(
            texts, [labels], True))
    for a, b in (("port w8a8", "port fp32"), ("JAX w8a8 flash", "port fp32"), ("JAX w8a8 xla", "port fp32"),
                 ("port w8a8", "JAX w8a8 flash"), ("JAX w8a8 flash", "JAX w8a8 xla")):
        d = np.abs(probs[a] - probs[b])
        print(f"probabilities {a} against {b}: max {d.max():.4f} mean {d.mean():.4f}")
    for k, v in probs.items():
        print(f"{k}: cells with p > 0.5 {int((v > 0.5).sum())} of {v.size}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=["ops", "layers", "bundle"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dir", default=None, help="bundle: where the tokenizer and the bundle go")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.what == "ops":
        ops(args.layers or 1)
    elif args.what == "layers":
        layers_cmp(args.layers or 28)
    else:
        bundle_cmp(args.dir, args.layers or 28)
    return 0


if __name__ == "__main__":
    sys.exit(main())
