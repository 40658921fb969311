"""DeBERTa-v2/v3 encoder in PyTorch (the gliclass-{small,base,large} backbone).

Parameters are the JAX package's nested dict of tensors; the L layers are
stacked on a leading axis and run by a Python loop over ``[L, ...]`` slices.

Disentangled attention takes one of four kernel routes (ops/fused_attention),
chosen once per forward from (S, B) by ``attention_route``: the flash route
(K1), which forms the c2p/p2c terms per tile so that no [B, h, S, S] tensor
is built; the bias route (K6 tables, bias products, K7); the row route (K8,
whole score rows on chip); or the tiled route (K9 windowed tables, K10). All
start from the position tables projected once per layer, their rows taken
for each relative offset with a static 1-D index (:func:`rel_bias_columns`,
the Toeplitz structure: the bucketed position depends only on i - j).
:func:`score_attention` keeps the materialized-score formulation (relative-
axis products skewed by :func:`rel_to_abs`, pair mask): the reference the
tests hold the kernel routes against, the path of the "table"/"xla" routes,
and the path of configurations outside the kernel routes (one of c2p/p2c,
or no relative attention).

Under tensor parallelism (``parallel.collectives.model_parallel``) each rank
holds its own heads of q/k/v and the position projections and the matching
rows of o, and its own columns of the FFN's intermediate: the head count
comes from the local projection's width, and each attention and FFN block
ends with the sum over the model group (``ops.layers.row_linear``).
LayerNorms, embeddings, the relative embeddings and the conv stem are
replicated.

Under sequence parallelism (``seq``, a ``parallel.collectives.SeqShard``
that ``models.gliclass.encode_backbone`` passes) each seq rank embeds and
runs the norms, the projections and the FFN on its block of S/sp tokens;
attention all-gathers k and v over the seq group and runs the rank's query
rows at their offset (K1 with ``q_off``; the score path's c2p/p2c skewed at
the offset, the pair mask's rows). The position tables stay those of the
whole S. The forced ``bias``, ``row`` and ``tiled`` routes gather q as
well, run their kernels over all S and keep the rank's rows, as XLA's
partitioner runs a ``pallas_call`` under the JAX package's sequence
parallelism. The conv stem gathers its input, the embedding output, whose
(k - 1) / 2 neighbour rows on each side its taps read.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..config import BackboneConfig
from ..ops.fused_attention import (
    attention_route,
    flash_disentangled_attention,
    row_disentangled_attention,
    table_bias_attention,
    tiled_bias_attention,
)
from ..ops.fused_ffn import fused_ffn
from ..ops.layers import activation, divide, layer_norm, linear, masked_softmax, row_linear
from ..parallel.collectives import SeqShard, all_gather_seq, copy_to_model, tp_group
from . import _init

Params = dict[str, Any]

_NEG_INF = float(np.finfo(np.float32).min)


# ---------------------------------------------------------------------------
# Relative position buckets (host-side numpy; DeBERTa-v2's
# make_log_bucket_position / build_relative_position semantics).
# ---------------------------------------------------------------------------
def log_bucket(rel: np.ndarray, bucket_size: int, max_position: int) -> np.ndarray:
    """DeBERTa-v2 log-bucketing of relative distances, over any int array."""
    rel = np.asarray(rel, dtype=np.int64)
    if bucket_size <= 0 or max_position <= 0:
        return rel.astype(np.int32)
    sign = np.sign(rel)
    mid = bucket_size // 2
    abs_pos = np.where((rel < mid) & (rel > -mid), mid - 1, np.abs(rel)).astype(np.float64)
    log_pos = (
        np.ceil(np.log(abs_pos / mid) / math.log((max_position - 1) / mid) * (mid - 1))
        + mid
    )
    out = np.where(abs_pos <= mid, rel.astype(np.float64), log_pos * sign)
    return out.astype(np.int32)


def relative_position_bucket(
    query_size: int, key_size: int, bucket_size: int, max_position: int
) -> np.ndarray:
    """[query_size, key_size] int32 bucketed relative positions (q - k)."""
    q_ids = np.arange(query_size, dtype=np.int64)
    k_ids = np.arange(key_size, dtype=np.int64)
    return log_bucket(q_ids[:, None] - k_ids[None, :], bucket_size, max_position)


def rel_bias_columns(
    seq_len: int, att_span: int, bucket_size: int, max_position: int
) -> tuple[np.ndarray, np.ndarray]:
    """Rows of the projected position table for each relative offset.

    With m = j - i + S - 1 (the relative axis), i - j = S - 1 - m, and:

        c2p_cols[m] = clamp( bucket(S-1-m) + span, 0, 2*span-1 )
        p2c_cols[m] = clamp(-bucket(S-1-m) + span, 0, 2*span-1 )
    """
    r = np.arange(seq_len - 1, -seq_len, -1)  # r[m] = S-1-m, m = 0..2S-2
    br = log_bucket(r, bucket_size, max_position)
    c2p = np.clip(br + att_span, 0, att_span * 2 - 1).astype(np.int32)
    p2c = np.clip(-br + att_span, 0, att_span * 2 - 1).astype(np.int32)
    return c2p, p2c


def rel_to_abs(x: torch.Tensor, n_cols: int | None = None, row_off: int = 0, col_off: int = 0) -> torch.Tensor:
    """[..., R, 2S-1] relative-axis scores -> [..., R, n_cols] absolute scores
    with out[..., r, c] = x[..., r, (c + col_off) - (r + row_off) + S - 1]:
    row r and column c stand at positions r + row_off and c + col_off of the
    S. By default R = n_cols = S: out[..., i, j] = x[..., i, j - i + S - 1]."""
    *lead, R, W = x.shape
    S = (W + 1) // 2
    if W != 2 * S - 1 or (n_cols is None and R != S):
        raise ValueError(f"rel_to_abs: {R} rows of {W} relative columns")
    n_cols = S if n_cols is None else n_cols
    r = torch.arange(R, device=x.device)
    c = torch.arange(n_cols, device=x.device)
    idx = ((c[None, :] + col_off) - (r[:, None] + row_off) + (S - 1)).expand(*lead, R, n_cols)
    return torch.gather(x, -1, idx)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., S, H] -> [..., num_heads, S, head_dim] (a view)."""
    *lead, s, h = x.shape
    return x.reshape(*lead, s, num_heads, h // num_heads).transpose(-2, -3)


def _merge_heads(ctx: torch.Tensor) -> torch.Tensor:
    """[B, h, S, d] -> [B, S, h*d]."""
    B, h, S, d = ctx.shape
    return ctx.transpose(1, 2).reshape(B, S, h * d)


def _qkv(p_attn: Params, x: torch.Tensor, head_dim: int, compute_dtype):
    """q, k, v [B, h, S, d], h the heads of the projection's width (this
    rank's under tensor parallelism)."""
    if "qkv" in p_attn:
        # One [H, 3H] projection (engine.fuse_qkv_params); q/k/v are views.
        qkv = linear(p_attn["qkv"], x, compute_dtype)
        Ho = qkv.shape[-1] // 3
        nh = Ho // head_dim
        return (
            _split_heads(qkv[..., :Ho], nh),
            _split_heads(qkv[..., Ho : 2 * Ho], nh),
            _split_heads(qkv[..., 2 * Ho :], nh),
        )
    return tuple(
        _split_heads(y, y.shape[-1] // head_dim)
        for y in (linear(p_attn[n], x, compute_dtype) for n in ("q", "k", "v"))
    )


def _pos_qk(p_attn: Params, rel_emb: torch.Tensor, cfg: BackboneConfig, compute_dtype):
    """Position projections of the (layer-normed) relative embeddings,
    [2K, H] each. share_att_key (v3) reuses the content q/k projections —
    one slice of the fused projection when q/k/v are fused."""
    if cfg.share_att_key and "qkv" in p_attn:
        r = linear(p_attn["qkv"], rel_emb, compute_dtype)
        Hp = r.shape[-1] // 3
        return r[..., :Hp], r[..., Hp : 2 * Hp]
    if cfg.share_att_key:
        pos_q_p, pos_k_p = p_attn["q"], p_attn["k"]
    else:
        pos_q_p = p_attn.get("pos_q", p_attn.get("q", p_attn.get("qkv")))
        pos_k_p = p_attn.get("pos_k", p_attn.get("k", p_attn.get("qkv")))
    return linear(pos_q_p, rel_emb, compute_dtype), linear(pos_k_p, rel_emb, compute_dtype)


def kernel_route(cfg: BackboneConfig) -> bool:
    """Whether attention runs through a kernel route: relative attention
    with both c2p and p2c (every published gliclass DeBERTa backbone)."""
    return cfg.relative_attention and set(cfg.pos_att_type) == {"c2p", "p2c"}


def disentangled_attention(
    p_attn: Params,
    x: torch.Tensor,
    rel_emb: torch.Tensor,
    c2p_cols: torch.Tensor,
    p2c_cols: torch.Tensor,
    cfg: BackboneConfig,
    compute_dtype,
    key_mask: torch.Tensor,
    route: str = "flash",
    seq: SeqShard | None = None,
) -> torch.Tensor:
    """One disentangled self-attention block through a kernel route,
    ``route`` "flash" (K1), "bias" (K6 + bias products + K7), "row" (K8) or
    "tiled" (K9 + K10).

    c2p_cols/p2c_cols: [2S-1] int64 rows of the projected position table per
    relative offset (:func:`rel_bias_columns`); key_mask: [B, S] int32. With
    ``seq``, x holds this seq rank's tokens ``seq.rows`` of the S."""
    group = tp_group("attn")
    x, rel_emb = copy_to_model(x, group), copy_to_model(rel_emb, group)
    scale = math.sqrt(cfg.head_dim * (1 + len(cfg.pos_att_type)))
    q, k, v = _qkv(p_attn, x, cfg.head_dim, compute_dtype)
    nh = q.shape[1]
    q_off = 0
    if seq is not None and route == "flash":  # the rank's query rows at their offset
        k, v = all_gather_seq(torch.stack((k, v)), 3, seq.group).unbind(0)
        q_off = seq.off
    elif seq is not None:  # the whole kernel over every row, the rank's rows kept
        q, k, v = all_gather_seq(torch.stack((q, k, v)), 3, seq.group).unbind(0)
    pos_q_flat, pos_k_flat = _pos_qk(p_attn, rel_emb, cfg, compute_dtype)
    pos_k_rel = _split_heads(pos_k_flat, nh).index_select(1, c2p_cols).contiguous()
    pos_q_rel = _split_heads(pos_q_flat, nh).index_select(1, p2c_cols).contiguous()
    # The bias and tiled routes store biases or tables in the compute dtype
    # (JAX models/deberta.py bias_dtype: fp32 in fp32 mode, else the compute
    # dtype); their kernels add them in fp32.
    if route == "bias":
        ctx = table_bias_attention(q, k, v, pos_k_rel, pos_q_rel, key_mask, scale, compute_dtype)
    elif route == "tiled":
        ctx = tiled_bias_attention(q, k, v, pos_k_rel, pos_q_rel, key_mask, scale, compute_dtype)
    elif route == "row":
        ctx = row_disentangled_attention(q, k, v, pos_k_rel, pos_q_rel, key_mask, scale)
    else:
        ctx = flash_disentangled_attention(q, k, v, pos_k_rel, pos_q_rel, key_mask, scale, q_off)
    if seq is not None and route != "flash":
        ctx = ctx[:, :, seq.rows]
    return row_linear(p_attn["o"], _merge_heads(ctx), compute_dtype, group)


def score_attention(
    p_attn: Params,
    x: torch.Tensor,
    rel_emb: torch.Tensor,
    pair_mask: torch.Tensor,
    c2p_cols: torch.Tensor,
    p2c_cols: torch.Tensor,
    cfg: BackboneConfig,
    compute_dtype,
    seq: SeqShard | None = None,
) -> torch.Tensor:
    """The materialized-score formulation (the JAX package's XLA path):
    [B, h, S, S] scores, relative-axis c2p/p2c skewed by :func:`rel_to_abs`,
    pair mask at finfo.min (fp32) or -1e4 (reduced precision), softmax.
    With ``seq``, x holds the rank's tokens ``seq.rows`` and pair_mask their
    rows [B, n, S]: the scores are [B, h, n, S] against the gathered k, v."""
    group = tp_group("attn")
    x, rel_emb = copy_to_model(x, group), copy_to_model(rel_emb, group)
    scale = math.sqrt(cfg.head_dim * (1 + len(cfg.pos_att_type)))
    q, k, v = _qkv(p_attn, x, cfg.head_dim, compute_dtype)
    nh = q.shape[1]
    n, off = q.shape[2], 0
    if seq is not None:
        k, v = all_gather_seq(torch.stack((k, v)), 3, seq.group).unbind(0)
        off = seq.off
    score_dtype = torch.float32 if compute_dtype == torch.float32 else compute_dtype
    scores = divide((q.float() @ k.float().transpose(-1, -2)).to(score_dtype), scale)
    if cfg.relative_attention:
        pos_q_flat, pos_k_flat = _pos_qk(p_attn, rel_emb, cfg, compute_dtype)
        if "c2p" in cfg.pos_att_type:
            pos_k_rel = _split_heads(pos_k_flat, nh).index_select(1, c2p_cols)
            c2p_rel = torch.einsum("bhid,hmd->bhim", q.float(), pos_k_rel.float())
            scores = scores + divide(rel_to_abs(c2p_rel.to(score_dtype), k.shape[2], row_off=off), scale)
        if "p2c" in cfg.pos_att_type:
            pos_q_rel = _split_heads(pos_q_flat, nh).index_select(1, p2c_cols)
            p2c_rel = torch.einsum("bhjd,hmd->bhjm", k.float(), pos_q_rel.float())
            scores = scores + divide(rel_to_abs(p2c_rel.to(score_dtype), n, col_off=off).transpose(-1, -2), scale)
    neg = _NEG_INF if score_dtype == torch.float32 else -1e4
    scores = torch.where(pair_mask[:, None], scores, torch.full_like(scores, neg))
    probs = masked_softmax(scores).to(compute_dtype)
    ctx = (probs.float() @ v.float()).to(compute_dtype)
    return row_linear(p_attn["o"], _merge_heads(ctx), compute_dtype, group)


def encoder_layer(
    p: Params,
    x: torch.Tensor,
    rel_emb: torch.Tensor,
    pair_mask: torch.Tensor,
    c2p_cols: torch.Tensor,
    p2c_cols: torch.Tensor,
    cfg: BackboneConfig,
    compute_dtype,
    key_mask: torch.Tensor,
    route: str,
    seq: SeqShard | None = None,
) -> torch.Tensor:
    """Post-LN transformer layer: attn -> add&norm -> FFN -> add&norm.
    ``route``: a kernel route, or "score" for the score formulation."""
    if route == "score":
        attn_out = score_attention(
            p["attn"], x, rel_emb, pair_mask, c2p_cols, p2c_cols, cfg, compute_dtype, seq
        )
    else:
        attn_out = disentangled_attention(
            p["attn"], x, rel_emb, c2p_cols, p2c_cols, cfg, compute_dtype, key_mask, route, seq
        )
    x = layer_norm(p["attn"]["ln"], attn_out, cfg.layer_norm_eps, residual=x)
    h = fused_ffn(p["ffn"]["up"], p["ffn"]["down"], x, cfg.hidden_act, compute_dtype, tp_group("ffn"))
    return layer_norm(p["ffn"]["ln"], h, cfg.layer_norm_eps, residual=x)


def conv_layer(p: Params, embed_out: torch.Tensor, layer0_out: torch.Tensor,
               attention_mask: torch.Tensor, cfg: BackboneConfig, compute_dtype,
               seq: SeqShard | None = None) -> torch.Tensor:
    """DeBERTa-v2 conv stem (``conv_kernel_size > 0``, the deberta-v2-xlarge
    family), transformers' ``ConvLayer`` after encoder layer 0: a "same"
    padded 1-D conv over the embedding output in the compute dtype with fp32
    sums, bias, padded positions zeroed, activation, residual onto layer 0's
    output, LayerNorm, masked again. The kernel is kept as the JAX package
    keeps it, [k, H_in, H_out].

    The conv is the sum over its k taps of shifted [B, S, H_in] @ [H_in,
    H_out] fp32 products: a plain matmul, so it never goes through cuDNN,
    whose ``allow_tf32`` (True by default) would round fp32 inputs to TF32's
    ten mantissa bits.

    With ``seq`` the inputs hold the rank's tokens ``seq.rows``: the
    embedding output is gathered over the seq group (the taps read (k - 1) /
    2 neighbour rows on each side), and the conv runs for the rank's rows."""
    k = cfg.conv_kernel_size
    if k % 2 == 0:
        raise ValueError("conv_kernel_size must be odd (torch same-padding)")
    n, off = layer0_out.shape[1], 0
    if seq is not None:
        embed_out, off = all_gather_seq(embed_out, 1, seq.group), seq.off
    pad = (k - 1) // 2
    x = F.pad(embed_out.to(compute_dtype).float(), (0, 0, pad, pad))  # [B, S + k - 1, H_in]
    w = p["w"].to(compute_dtype).float()
    out = p["b"].float() + x[:, off : off + n] @ w[0]
    for t in range(1, k):
        out = out + x[:, off + t : off + t + n] @ w[t]
    m = attention_mask[..., None].float()
    out = activation(cfg.conv_act)(out * m).to(compute_dtype)
    y = layer_norm(p["ln"], layer0_out, cfg.layer_norm_eps, residual=out)
    return y * m.to(y.dtype)


def embed(p: Params, input_ids: torch.Tensor, attention_mask: torch.Tensor,
          cfg: BackboneConfig, compute_dtype, pos_off: int = 0) -> torch.Tensor:
    """Word embeddings -> (optional proj) -> LayerNorm -> zero padded
    positions. ``pos_off``: the position of the first token (a seq rank's)."""
    x = p["word"].index_select(0, input_ids.reshape(-1).long())
    x = x.reshape(*input_ids.shape, -1).to(compute_dtype)
    if "pos" in p and cfg.position_biased_input:
        x = x + p["pos"][pos_off : pos_off + input_ids.shape[-1]].to(compute_dtype)
    if "proj" in p:
        x = linear(p["proj"], x, compute_dtype)
    x = layer_norm(p["ln"], x, cfg.layer_norm_eps)
    return x * attention_mask[..., None].to(x.dtype)


def _layer(layers: Params, i: int) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def deberta_encode(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: BackboneConfig,
    compute_dtype=torch.float32,
    attn_route: str = "auto",
    return_all_layers: bool = False,
    seq: SeqShard | None = None,
) -> torch.Tensor:
    """Full encoder forward: [B, S] ids + mask -> [B, S, H] hidden states.
    ``attn_route`` (RuntimeConfig.attn_route) is resolved once for the
    forward's (S, B) and device by ``ops.fused_attention.attention_route``.
    With ``seq`` the states are this seq rank's tokens ``seq.rows`` only,
    [B, S/sp, H] (ids and mask stay whole: the keys are every token).

    With ``return_all_layers`` the states stacked [L+1, B, S, H] in
    transformers' ``output_hidden_states`` order: the embedding output, then
    each layer's output, layer 0's merged with the conv stem where there is
    one (the ``squeeze_layers`` fuser reads them)."""
    B, S = input_ids.shape
    dev = input_ids.device
    rows = seq.rows if seq is not None else slice(None)
    local_mask = attention_mask[:, rows]
    x = embed(params["embeddings"], input_ids[:, rows], local_mask, cfg, compute_dtype,
              seq.off if seq is not None else 0)
    key_mask = attention_mask.to(torch.int32).contiguous()
    mask_b = attention_mask.bool()
    pair_mask = mask_b[:, rows, None] & mask_b[:, None, :]

    max_rel = cfg.max_relative_positions
    if max_rel < 1:
        max_rel = cfg.max_position_embeddings
    att_span = cfg.position_buckets if cfg.position_buckets > 0 else max_rel
    c2p_np, p2c_np = rel_bias_columns(S, att_span, cfg.position_buckets, max_rel)
    c2p_cols = torch.from_numpy(c2p_np.astype(np.int64)).to(dev)
    p2c_cols = torch.from_numpy(p2c_np.astype(np.int64)).to(dev)

    rel_emb = params.get("rel_embeddings")
    if rel_emb is not None:
        rel_emb = rel_emb.to(compute_dtype)
        if cfg.norm_rel_ebd == "layer_norm":
            rel_emb = layer_norm(params["rel_ln"], rel_emb, cfg.layer_norm_eps)
    else:
        rel_emb = torch.zeros((2 * att_span, cfg.hidden_size), dtype=compute_dtype, device=dev)

    route = attention_route(S, B, cfg.head_dim, attn_route, dev) if kernel_route(cfg) else "score"
    layers = params["layers"]
    n_layers = next(iter(layers["attn"]["o"].values())).shape[0]
    states = [x]
    for i in range(n_layers):
        x = encoder_layer(
            _layer(layers, i), x, rel_emb, pair_mask, c2p_cols, p2c_cols, cfg,
            compute_dtype, key_mask, route, seq,
        )
        if i == 0 and cfg.conv_kernel_size > 0:
            x = conv_layer(params["conv"], states[0], x, local_mask, cfg, compute_dtype, seq)
        if return_all_layers:
            states.append(x)
    return torch.stack(states) if return_all_layers else x


# ---------------------------------------------------------------------------
# Initialization (random; real weights come from the converter)
# ---------------------------------------------------------------------------
def init_deberta_params(generator: torch.Generator, cfg: BackboneConfig, dtype=torch.float32,
                        device="cpu") -> Params:
    """Random DeBERTa parameters in the JAX package's tree (its
    ``init_deberta_params``): per-layer leaves stacked [L, ...]; weights
    N(0, 0.02), biases 0, LayerNorms (1, 0); ``rel_embeddings`` and
    ``rel_ln`` with relative attention (``rel_ln`` under ``norm_rel_ebd ==
    "layer_norm"``), ``conv`` with a conv stem."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    max_rel = cfg.max_relative_positions
    if max_rel < 1:
        max_rel = cfg.max_position_embeddings
    att_span = cfg.position_buckets if cfg.position_buckets > 0 else max_rel
    g, kw = generator, dict(dtype=dtype, device=device)
    params: Params = {
        "embeddings": {"word": _init.normal(g, (cfg.vocab_size, H), **kw), "ln": _init.layer_norm(H, **kw)},
        "layers": {
            "attn": {n: _init.dense(g, H, H, lead=(L,), **kw) for n in ("q", "k", "v", "o")}
            | {"ln": _init.layer_norm(H, lead=(L,), **kw)},
            "ffn": {"up": _init.dense(g, H, I, lead=(L,), **kw), "down": _init.dense(g, I, H, lead=(L,), **kw),
                    "ln": _init.layer_norm(H, lead=(L,), **kw)},
        },
    }
    if cfg.relative_attention:
        params["rel_embeddings"] = _init.normal(g, (2 * att_span, H), **kw)
        if cfg.norm_rel_ebd == "layer_norm":
            params["rel_ln"] = _init.layer_norm(H, **kw)
    if cfg.conv_kernel_size > 0:
        params["conv"] = {"w": _init.normal(g, (cfg.conv_kernel_size, H, H), **kw),
                          "b": _init.zeros((H,), **kw), "ln": _init.layer_norm(H, **kw)}
    return params
