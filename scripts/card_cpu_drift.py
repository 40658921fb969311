"""How far the port on the card drifts from the port on the CPU, layer by layer.

    python3 scripts/card_cpu_drift.py [--model base|qwen] [--seed N]

Runs the backbone of gliclass-base (DeBERTa-v3-base) or gliclass-qwen-1.5B
(Qwen2-1.5B, 28 layers) with chip_smoke.py's random INT8 weights on the first
texts of its job, on the card and on the CPU, and prints the relative L2
error of the hidden states after every layer (valid tokens only) in three
modes: fp32 (weight-only INT8), bf16 "int8" and bf16 "int8-dynamic". Each
card run goes once through the hand-written kernels and once with every
kernel wrapper of the backbone replaced by its plain PyTorch version on the
card: equal drift says the kernels add nothing to it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from gliclass.c_tpu_torch.config import (  # noqa: E402
    GLiClassConfig, RuntimeConfig, deberta_v3_config, qwen2_config,
)
from gliclass.c_tpu_torch.engine import InferenceEngine  # noqa: E402
from gliclass.c_tpu_torch.models import deberta as D  # noqa: E402
from gliclass.c_tpu_torch.models import llama as L  # noqa: E402
from gliclass.c_tpu_torch.ops import causal_attention as CA  # noqa: E402
from gliclass.c_tpu_torch.ops import fused_attention as FA  # noqa: E402
from gliclass.c_tpu_torch.ops import fused_ffn as FF  # noqa: E402
from gliclass.c_tpu_torch.ops import int8_matmul as IM  # noqa: E402
from gliclass.c_tpu_torch.ops.layers import act_quant, layer_norm, rms_norm  # noqa: E402
from gliclass.c_tpu_torch.ops.quant import quantize_tree  # noqa: E402
from gliclass.c_tpu_torch.prompting import pack_prompts  # noqa: E402
from gliclass.c_tpu_torch.tokenization import PromptTokenizer  # noqa: E402

# Kernel wrappers as the backbones call them -> their plain versions.
PLAIN = [(D, "flash_disentangled_attention", FA.flash_disentangled_attention_plain),
         # The FFN wrappers' keywords (the [N, K] weights, the model group) do not change the plain arithmetic.
         (FF, "fused_ffn_w8a8", lambda *a, wt_up=None, wt_dn=None, group=None: FF.fused_ffn_w8a8_plain(*a)),
         (FF, "fused_ffn_wonly", lambda *a, group=None: FF.fused_ffn_wonly_plain(*a)),
         (IM, "int8_matmul", IM.int8_matmul_plain),
         (L, "causal_flash_attention", CA.causal_flash_attention_plain)]


def layer_states(engine, batch) -> list[torch.Tensor]:
    """Hidden states after each layer (fp32, host), the backbones' loops."""
    ids, mask = engine._device_inputs(batch.input_ids, batch.attention_mask)
    bb, dt, p = engine.cfg.backbone, engine.compute_dtype, engine.params["backbone"]
    out = []
    with torch.inference_mode(), act_quant(engine._act_quant):
        B, S = ids.shape
        if bb.model_type == "deberta-v2":
            x = D.embed(p["embeddings"], ids, mask, bb, dt)
            km, mb = mask.to(torch.int32).contiguous(), mask.bool()
            pair = mb[:, :, None] & mb[:, None, :]
            cols = D.rel_bias_columns(S, bb.position_buckets, bb.position_buckets, bb.max_position_embeddings)
            c2p, p2c = (torch.from_numpy(c.astype(np.int64)).to(ids.device) for c in cols)
            rel = layer_norm(p["rel_ln"], p["rel_embeddings"].to(dt), bb.layer_norm_eps)
            for i in range(bb.num_hidden_layers):
                x = D.encoder_layer(D._layer(p["layers"], i), x, rel, pair, c2p, p2c, bb, dt, km, "flash")
                out.append(x.float().cpu())
            return out
        x = p["embeddings"]["word"].index_select(0, ids.reshape(-1).long()).reshape(B, S, -1).to(dt)
        km = mask.to(torch.int32).contiguous()
        cos, sin = L.rope_device(S, bb.head_dim, float(bb.rope_theta), str(ids.device))
        for i in range(bb.num_hidden_layers):
            pl = L._layer(p["layers"], i)
            x = x + L.llama_attention(pl["attn"], rms_norm(pl["attn_norm"], x, bb.rms_norm_eps),
                                      km, cos, sin, bb, dt)
            x = x + L.llama_mlp(pl["mlp"], rms_norm(pl["mlp_norm"], x, bb.rms_norm_eps), dt)
            out.append(x.float().cpu())
    return out


def with_plain_versions(fn):
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in PLAIN]
    for mod, name, plain in PLAIN:
        setattr(mod, name, plain)
    try:
        return fn()
    finally:
        for mod, name, kernel in saved:
            setattr(mod, name, kernel)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("base", "qwen"), default="base")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--texts", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    rng = np.random.default_rng(args.seed)
    if args.model == "base":
        bb = deberta_v3_config("base")
        tok = PromptTokenizer(cs.WordTokenizer(bb.vocab_size))
        cfg = GLiClassConfig(hidden_size=bb.hidden_size, class_token_index=tok.label_token_id,
                             text_token_index=tok.sep_token_id, prompt_first=True, backbone=bb)
        qparams = quantize_tree(cs.make_params(rng, bb, cfg.hidden_size))
    else:
        bb = qwen2_config("1.5b")
        tok = PromptTokenizer(cs.WordTokenizer(bb.vocab_size))
        cfg = GLiClassConfig(hidden_size=bb.hidden_size, class_token_index=tok.label_token_id,
                             text_token_index=tok.sep_token_id, prompt_first=False, backbone=bb)
        qparams = cs.make_decoder_params(rng, bb, cfg.hidden_size)
    job = cs.make_job(rng, 384, 16)
    batch = tok.encode_batch(pack_prompts(job["texts"][:args.texts], job["labels"], True, cfg.prompt_first),
                             max_length=512)
    valid = torch.from_numpy(batch.attention_mask).bool()
    rel = lambda a, b: ((a[valid] - b[valid]).norm() / b[valid].norm()).item()
    print(f"{args.model}: {bb.num_hidden_layers} layers, batch {tuple(batch.input_ids.shape)} | "
          f"{cs.smi_line()}", flush=True)
    for dtype, quant_mode in (("float32", "int8"), ("bfloat16", "int8"), ("bfloat16", "int8-dynamic")):
        rt = RuntimeConfig(batch_size=64, max_length=512, compute_dtype=dtype, quant_mode=quant_mode)
        ref = layer_states(InferenceEngine(cfg, qparams, rt, device="cpu"), batch)
        card = InferenceEngine(cfg, qparams, rt, device="cuda")
        kern = layer_states(card, batch)
        plain = with_plain_versions(lambda: layer_states(card, batch))
        for name, got in (("kernels", kern), ("plain versions", plain)):
            errs = " ".join(f"{rel(a, b):.1e}" for a, b in zip(got, ref))
            print(f"{dtype} {quant_mode}, card with {name} vs CPU, by layer: {errs}", flush=True)
        del card
    return 0


if __name__ == "__main__":
    sys.exit(main())
