"""Llama/Qwen2 decoder backbone in PyTorch (gliclass-qwen-1.5B-v1.0 and
gliclass-llama-1.3B-v1.0), run as a causal encoder.

RMSNorm pre-norm blocks, rotary position embeddings (HF rotate_half
convention), grouped-query attention, SwiGLU MLP, causal masking combined
with the key padding mask, and the final RMSNorm (the hidden states equal
``last_hidden_state`` of transformers' LlamaModel / Qwen2Model).

Parameters are the JAX package's tree (``embeddings.word``, per-layer
``attn.{q,k,v,o}``, ``attn_norm``, ``mlp.{gate,up,down}``, ``mlp_norm``
stacked on a leading ``[L, ...]`` axis, ``final_norm``); the layers run as a
Python loop over ``[L, ...]`` slices. Every matmul goes through
``ops.layers.linear`` (INT8-capable).

Attention takes the kernel route (ops/causal_attention, K5): GQA without
repeating k/v, fp32 scores and softmax statistics, no [B, h, S, S] tensor.
:func:`score_attention` keeps the JAX package's materialized-score
formulation: the reference the tests hold the kernel route against, and the
path of the "xla"/"table" routes (the trainer's).

Under tensor parallelism (``parallel.collectives.model_parallel``) each rank
holds its own query heads and the kv heads they read (``parallel.sharding``),
and its own columns of the MLP's intermediate; head counts come from the
local projections' widths, and each attention and MLP block ends with the
sum over the model group (``ops.layers.row_linear``). Norms and embeddings
are replicated.

Under sequence parallelism (``seq``, a ``parallel.collectives.SeqShard``)
each seq rank embeds and runs the norms, projections and MLP on its block of
S/sp tokens, with rotary embeddings at their absolute positions; attention
all-gathers k and v over the seq group and runs the rank's query rows at
their offset (K5 with ``q_off``; the score path with the causal bias's rows
at the offset).
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch

from ..config import BackboneConfig, check_attn_route
from ..ops.causal_attention import causal_flash_attention, causal_mask
from ..ops.layers import (act_quant_enabled, activation_per_op, divide, linear, masked_softmax, rms_norm,
                          row_linear)
from ..parallel.collectives import SeqShard, all_gather_seq, copy_to_model, tp_group
from . import _init
from .deberta import _layer, _split_heads

Params = dict[str, Any]

_NEG_INF = float(np.finfo(np.float32).min)


def rope_tables(seq_len: int, head_dim: int, theta: float) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) tables [S, head_dim] in HF's rotary convention (duplicated
    half-frequencies: emb = cat(freqs, freqs)), computed in float64."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    t = np.arange(seq_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)  # [S, D/2]
    emb = np.concatenate([freqs, freqs], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


@functools.lru_cache(maxsize=64)
def rope_device(seq_len: int, head_dim: int, theta: float, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rope_tables` as f32 tensors on ``device``, built once per
    shape and shared by every caller (read only). Made outside inference
    mode even when the first caller runs in it (a served forward), so that
    a later forward under autograd (the trainer's) may save them for its
    backward."""
    cos, sin = rope_tables(seq_len, head_dim, theta)
    with torch.inference_mode(False):
        return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, h, S, D]; cos/sin f32 [S, D]. The product promotes to f32 (as in
    JAX); the caller casts back."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return x * cos + rot * sin


def _qkv_rope(p: Params, x: torch.Tensor, cos, sin, cfg: BackboneConfig, compute_dtype):
    """Projections, head split and rotary embedding: (qg [B, nkv, g, S, d],
    k [B, nkv, S, d], v [B, nkv, S, d]) in the compute dtype; nh and nkv
    the heads of the projections' widths (this rank's under tensor
    parallelism)."""
    d = cfg.head_dim
    q, k, v = (linear(p[n], x, compute_dtype) for n in ("q", "k", "v"))
    nh, nkv = q.shape[-1] // d, k.shape[-1] // d
    q, k, v = _split_heads(q, nh), _split_heads(k, nkv), _split_heads(v, nkv)
    q = apply_rope(q, cos, sin).to(compute_dtype)
    k = apply_rope(k, cos, sin).to(compute_dtype)
    B, _, S, _ = q.shape
    return q.reshape(B, nkv, nh // nkv, S, d), k, v


def _merge_heads(ctx: torch.Tensor) -> torch.Tensor:
    """[B, nkv, g, S, d] -> [B, S, nh*d] (free for the kernel's layout)."""
    B, nkv, g, S, d = ctx.shape
    return ctx.reshape(B, nkv * g, S, d).transpose(1, 2).reshape(B, S, nkv * g * d)


def _gather_kv(k: torch.Tensor, v: torch.Tensor, seq: SeqShard | None):
    """Every token's k and v, gathered over the seq group under ``seq``."""
    if seq is None:
        return k, v
    return all_gather_seq(torch.stack((k, v)), 3, seq.group).unbind(0)


def llama_attention(p: Params, x: torch.Tensor, key_mask: torch.Tensor, cos, sin,
                    cfg: BackboneConfig, compute_dtype, seq: SeqShard | None = None) -> torch.Tensor:
    """One causal GQA self-attention block through the K5 kernel route.
    key_mask: [B, S] int32. With ``seq``, x holds the rank's tokens
    ``seq.rows`` (cos/sin their rows), run at their offset."""
    group = tp_group("attn")
    qg, k, v = _qkv_rope(p, copy_to_model(x, group), cos, sin, cfg, compute_dtype)
    k, v = _gather_kv(k, v, seq)
    ctx = causal_flash_attention(qg, k, v, key_mask, 1.0 / math.sqrt(cfg.head_dim),
                                 seq.off if seq is not None else 0)
    return row_linear(p["o"], _merge_heads(ctx.to(compute_dtype)), compute_dtype, group)


def score_attention(p: Params, x: torch.Tensor, mask_bias: torch.Tensor, cos, sin,
                    cfg: BackboneConfig, compute_dtype, seq: SeqShard | None = None) -> torch.Tensor:
    """The JAX package's materialized-score formulation (its XLA route):
    scores in the compute dtype (fp32 in fp32) divided by sqrt(d), the
    additive [B, S, S] causal + padding bias, softmax, P.v with fp32 sums.
    With ``seq``: the rank's rows, mask_bias [B, S/sp, S]."""
    group = tp_group("attn")
    qg, k, v = _qkv_rope(p, copy_to_model(x, group), cos, sin, cfg, compute_dtype)
    k, v = _gather_kv(k, v, seq)
    score_dtype = torch.float32 if compute_dtype == torch.float32 else compute_dtype
    scores = divide(torch.einsum("bkgid,bkjd->bkgij", qg.float(), k.float()).to(score_dtype),
                    math.sqrt(cfg.head_dim))
    scores = scores + mask_bias[:, None, None].to(score_dtype)
    probs = masked_softmax(scores).to(compute_dtype)
    ctx = torch.einsum("bkgij,bkjd->bkgid", probs.float(), v.float())
    return row_linear(p["o"], _merge_heads(ctx.to(compute_dtype)), compute_dtype, group)


def causal_mask_bias(attention_mask: torch.Tensor, seq: SeqShard | None = None) -> torch.Tensor:
    """[B, S] mask -> additive fp32 bias [B, S, S]: 0 where key j <= query i
    and valid, finfo(f32).min elsewhere (the score route's mask). With
    ``seq``, the rows of the rank's queries: [B, S/sp, S]."""
    S = attention_mask.shape[-1]
    n, off = (seq.n, seq.off) if seq is not None else (S, 0)
    causal = causal_mask(n, S, attention_mask.device, off)
    ok = causal[None] & attention_mask.bool()[:, None, :]
    return torch.where(ok, 0.0, _NEG_INF).to(torch.float32)


def llama_mlp(p: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    """SwiGLU, rounded as the JAX package's graph rounds it: silu op by op,
    and under w8a8 the product gate * up quantized unrounded (in fp32)."""
    group = tp_group("mlp")
    x = copy_to_model(x, group)
    gate = activation_per_op("silu")(linear(p["gate"], x, compute_dtype)).to(compute_dtype)
    up = linear(p["up"], x, compute_dtype)
    h = gate.float() * up.float() if act_quant_enabled() else gate * up
    return row_linear(p["down"], h, compute_dtype, group)


def llama_encode(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 cfg: BackboneConfig, compute_dtype=torch.float32, attn_route: str = "auto",
                 return_all_layers: bool = False, seq: SeqShard | None = None) -> torch.Tensor:
    """[B, S] ids + mask -> [B, S, H] hidden states (after the final norm).

    ``attn_route`` "xla" or "table" takes :func:`score_attention` (the JAX
    package's GLICLASS_TPU_CAUSAL_ATTN=xla; the trainer's route, since K5
    has no backward); every other route the K5 kernel route.

    With ``return_all_layers`` the states stacked [L+1, B, S, H] in
    transformers' ``output_hidden_states`` order: the embedding output, the
    input of layers 1..L-1, and the final-normed output last (the raw output
    of the last layer never appears).

    With ``seq`` the states are this seq rank's tokens ``seq.rows`` only
    (ids and mask stay whole: the keys are every token)."""
    check_attn_route(attn_route)
    B, S = input_ids.shape
    rows = seq.rows if seq is not None else slice(None)
    ids = input_ids[:, rows]
    x = params["embeddings"]["word"].index_select(0, ids.reshape(-1).long())
    x = x.reshape(*ids.shape, -1).to(compute_dtype)
    key_mask = attention_mask.to(torch.int32).contiguous()
    cos, sin = rope_device(S, cfg.head_dim, float(cfg.rope_theta), str(input_ids.device))
    cos, sin = cos[rows], sin[rows]
    score = attn_route in ("xla", "table")
    mask_bias = causal_mask_bias(attention_mask, seq) if score else None

    layers = params["layers"]
    n_layers = next(iter(layers["attn"]["o"].values())).shape[0]
    states = []
    for i in range(n_layers):
        if return_all_layers:
            states.append(x)
        p = _layer(layers, i)
        a = rms_norm(p["attn_norm"], x, cfg.rms_norm_eps)
        if score:
            o = score_attention(p["attn"], a, mask_bias, cos, sin, cfg, compute_dtype, seq)
        else:
            o = llama_attention(p["attn"], a, key_mask, cos, sin, cfg, compute_dtype, seq)
        # The norm takes the unrounded sum, the residual stream the rounded one.
        m = rms_norm(p["mlp_norm"], x, cfg.rms_norm_eps, residual=o)
        x = x + o
        x = x + llama_mlp(p["mlp"], m, compute_dtype)
    final = rms_norm(params["final_norm"], x, cfg.rms_norm_eps)
    return torch.stack(states + [final]) if return_all_layers else final


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------
def init_llama_params(generator: torch.Generator, cfg: BackboneConfig, dtype=torch.float32,
                      device="cpu") -> Params:
    """Random Llama/Qwen2 parameters in the JAX package's tree (its
    ``init_llama_params``): weights N(0, 0.02), q/k/v biases 0 where the
    model has them (``attention_bias`` or qwen2), RMSNorm scales 1."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    nh, nkv, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    qkv_bias = cfg.attention_bias or cfg.model_type == "qwen2"
    g, kw = generator, dict(dtype=dtype, device=device, lead=(L,))
    norm = lambda: {"scale": _init.ones((L, H), dtype, device)}
    return {
        "embeddings": {"word": _init.normal(g, (cfg.vocab_size, H), dtype, device)},
        "layers": {
            "attn": {"q": _init.dense(g, H, nh * d, bias=qkv_bias, **kw),
                     "k": _init.dense(g, H, nkv * d, bias=qkv_bias, **kw),
                     "v": _init.dense(g, H, nkv * d, bias=qkv_bias, **kw),
                     "o": _init.dense(g, nh * d, H, bias=False, **kw)},
            "attn_norm": norm(),
            "mlp": {"gate": _init.dense(g, H, I, bias=False, **kw), "up": _init.dense(g, H, I, bias=False, **kw),
                    "down": _init.dense(g, I, H, bias=False, **kw)},
            "mlp_norm": norm(),
        },
        "final_norm": {"scale": _init.ones((H,), dtype, device)},
    }
