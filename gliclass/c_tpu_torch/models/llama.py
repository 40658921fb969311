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
formulation as the reference the tests hold the kernel route against.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..config import BackboneConfig
from ..ops.causal_attention import causal_flash_attention
from ..ops.layers import linear, masked_softmax, rms_norm
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
    shape and shared by every caller (read only)."""
    cos, sin = rope_tables(seq_len, head_dim, theta)
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, h, S, D]; cos/sin f32 [S, D]. The product promotes to f32 (as in
    JAX); the caller casts back."""
    d2 = x.shape[-1] // 2
    rot = torch.cat([-x[..., d2:], x[..., :d2]], dim=-1)
    return x * cos + rot * sin


def _qkv_rope(p: Params, x: torch.Tensor, cos, sin, cfg: BackboneConfig, compute_dtype):
    """Projections, head split and rotary embedding: (qg [B, nkv, g, S, d],
    k [B, nkv, S, d], v [B, nkv, S, d]) in the compute dtype."""
    nh, nkv, d = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    q = _split_heads(linear(p["q"], x, compute_dtype), nh)
    k = _split_heads(linear(p["k"], x, compute_dtype), nkv)
    v = _split_heads(linear(p["v"], x, compute_dtype), nkv)
    q = apply_rope(q, cos, sin).to(compute_dtype)
    k = apply_rope(k, cos, sin).to(compute_dtype)
    B, _, S, _ = q.shape
    return q.reshape(B, nkv, nh // nkv, S, d), k, v


def _merge_heads(ctx: torch.Tensor) -> torch.Tensor:
    """[B, nkv, g, S, d] -> [B, S, nh*d] (free for the kernel's layout)."""
    B, nkv, g, S, d = ctx.shape
    return ctx.reshape(B, nkv * g, S, d).transpose(1, 2).reshape(B, S, nkv * g * d)


def llama_attention(p: Params, x: torch.Tensor, key_mask: torch.Tensor, cos, sin,
                    cfg: BackboneConfig, compute_dtype) -> torch.Tensor:
    """One causal GQA self-attention block through the K5 kernel route.
    key_mask: [B, S] int32."""
    qg, k, v = _qkv_rope(p, x, cos, sin, cfg, compute_dtype)
    ctx = causal_flash_attention(qg, k, v, key_mask, 1.0 / math.sqrt(cfg.head_dim))
    return linear(p["o"], _merge_heads(ctx.to(compute_dtype)), compute_dtype)


def score_attention(p: Params, x: torch.Tensor, mask_bias: torch.Tensor, cos, sin,
                    cfg: BackboneConfig, compute_dtype) -> torch.Tensor:
    """The JAX package's materialized-score formulation (its XLA route):
    scores in the compute dtype (fp32 in fp32) divided by sqrt(d), the
    additive [B, S, S] causal + padding bias, softmax, P.v with fp32 sums."""
    qg, k, v = _qkv_rope(p, x, cos, sin, cfg, compute_dtype)
    score_dtype = torch.float32 if compute_dtype == torch.float32 else compute_dtype
    scores = (torch.einsum("bkgid,bkjd->bkgij", qg.float(), k.float()).to(score_dtype)
              / math.sqrt(cfg.head_dim)).to(score_dtype)
    scores = scores + mask_bias[:, None, None].to(score_dtype)
    probs = masked_softmax(scores).to(compute_dtype)
    ctx = torch.einsum("bkgij,bkjd->bkgid", probs.float(), v.float())
    return linear(p["o"], _merge_heads(ctx.to(compute_dtype)), compute_dtype)


def causal_mask_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] mask -> additive fp32 bias [B, S, S]: 0 where key j <= query i
    and valid, finfo(f32).min elsewhere (the score route's mask)."""
    S = attention_mask.shape[-1]
    causal = torch.ones(S, S, dtype=torch.bool, device=attention_mask.device).tril()
    ok = causal[None] & attention_mask.bool()[:, None, :]
    return torch.where(ok, 0.0, _NEG_INF).to(torch.float32)


def llama_mlp(p: Params, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    gate = F.silu(linear(p["gate"], x, compute_dtype))
    up = linear(p["up"], x, compute_dtype)
    return linear(p["down"], gate * up, compute_dtype)


def llama_encode(params: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 cfg: BackboneConfig, compute_dtype=torch.float32) -> torch.Tensor:
    """[B, S] ids + mask -> [B, S, H] hidden states (after the final norm)."""
    B, S = input_ids.shape
    x = params["embeddings"]["word"].index_select(0, input_ids.reshape(-1).long())
    x = x.reshape(B, S, -1).to(compute_dtype)
    key_mask = attention_mask.to(torch.int32).contiguous()
    cos, sin = rope_device(S, cfg.head_dim, float(cfg.rope_theta), str(input_ids.device))

    layers = params["layers"]
    n_layers = next(iter(layers["attn"]["o"].values())).shape[0]
    for i in range(n_layers):
        p = _layer(layers, i)
        a = rms_norm(p["attn_norm"], x, cfg.rms_norm_eps)
        x = x + llama_attention(p["attn"], a, key_mask, cos, sin, cfg, compute_dtype)
        m = rms_norm(p["mlp_norm"], x, cfg.rms_norm_eps)
        x = x + llama_mlp(p["mlp"], m, compute_dtype)
    return rms_norm(params["final_norm"], x, cfg.rms_norm_eps)
