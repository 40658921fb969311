"""GLiClass scoring head: label-slot extraction, pooling, projectors, scorer.

The structure follows the HF ``gliclass`` package (GLiClassUniEncoder +
FeaturesProjector + scorers), the upstream of every exported checkpoint;
parameter names match it (text_projector / classes_projector / linear_1 /
linear_2). Besides the head itself: the layer fuser (``squeeze_layers``) and
the BiLSTM (``use_lstm``) that refine the encoder states before it.

Under tensor parallelism the projectors' linear_1/linear_2 and the scorers'
mlp_1/mlp_2 run column- then row-parallel where ``parallel.sharding``
sharded them (``parallel.collectives.tp_group``); the scorers' other
products, the BiLSTM and the fuser are replicated.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..config import GLiClassConfig
from ..ops.layers import activation_per_op, linear, row_linear, wide
from ..parallel.collectives import copy_to_model, tp_group
from . import _init

Params = dict[str, Any]

NEG_LOGIT = -1e4  # logit for padded label slots: sigmoid(-1e4) == 0.0 in fp32


def extract_label_embeddings(
    hidden: torch.Tensor, input_ids: torch.Tensor, class_token_id: int, max_labels: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hidden states at ``<<LABEL>>`` positions, in order, into label slots.

    hidden [B,S,H], input_ids [B,S] -> (label_emb [B,L,H], label_mask [B,L]),
    L = max_labels: the k-th <<LABEL>> of a sequence fills slot k. A one-hot
    [B,S,L] selection contracted with the hidden states (fp32 accumulate)."""
    is_label = input_ids == class_token_id
    ordinal = torch.cumsum(is_label.to(torch.int32), dim=-1) - 1
    slots = torch.arange(max_labels, device=input_ids.device, dtype=torch.int32)
    onehot = (ordinal[..., None] == slots) & is_label[..., None]  # [B,S,L]
    hw = wide(hidden)
    label_emb = torch.einsum("bsl,bsh->blh", onehot.to(hw.dtype), hw).to(hidden.dtype)
    counts = is_label.sum(dim=-1)
    label_mask = slots[None, :] < counts[:, None]
    return label_emb, label_mask


def text_span_mask(
    input_ids: torch.Tensor, attention_mask: torch.Tensor, class_token_id: int,
    sep_token_id: int, prompt_first: bool,
) -> torch.Tensor:
    """Bool mask [B,S] of the raw-text tokens of a packed prompt: strictly
    after the first ``<<SEP>>`` (prompt first) or strictly before the first
    ``<<LABEL>>`` (text first), valid, never a tag. A row with an empty span
    falls back to all valid tokens."""
    valid = attention_mask.bool()
    is_label = input_ids == class_token_id
    is_sep = input_ids == sep_token_id
    if prompt_first:
        cum_sep = torch.cumsum(is_sep.to(torch.int32), dim=-1)
        after_first_sep = (cum_sep - is_sep.to(torch.int32)) >= 1
        span = after_first_sep & valid & ~is_sep & ~is_label
    else:
        before_first_label = torch.cumsum(is_label.to(torch.int32), dim=-1) == 0
        span = before_first_label & valid & ~is_sep
    has_text = span.any(dim=-1, keepdim=True)
    return torch.where(has_text, span, valid)


def pool_text(
    hidden: torch.Tensor, attention_mask: torch.Tensor, strategy: str,
    span: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sequence -> one text representation [B,H]: 'first' (the CLS token, or
    the first span token), or masked 'mean' / 'max' / 'sum'."""
    if strategy == "first":
        if span is None:
            return hidden[:, 0]
        first = span.to(torch.int32).argmax(dim=-1)
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), first]
    m = (attention_mask if span is None else span)[..., None].to(hidden.dtype)
    if strategy == "mean":
        return (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    if strategy == "sum":
        return (hidden * m).sum(dim=1)
    if strategy == "max":
        neg = torch.finfo(hidden.dtype).min
        return torch.where(m > 0, hidden, torch.full_like(hidden, neg)).amax(dim=1)
    raise ValueError(f"unsupported pooling_strategy: {strategy!r}")


def features_projector(p: Params, x: torch.Tensor, act_name: str, compute_dtype, group=None,
                       round_sum: bool = True) -> torch.Tensor:
    """FeaturesProjector: Linear(H -> 4H) -> act -> Linear(4H -> H), the
    activation op by op in reduced precision (:func:`~..ops.layers.
    activation_per_op`); ``group``: the model group its 4H is sharded over
    (None: whole); ``round_sum``: as :func:`~..ops.layers.linear`'s, for
    the last linear."""
    h = activation_per_op(act_name)(linear(p["linear_1"], copy_to_model(x, group), compute_dtype))
    return row_linear(p["linear_2"], h, compute_dtype, group, round_sum)


def score_simple(text_rep: torch.Tensor, label_rep: torch.Tensor) -> torch.Tensor:
    """ScorerDot: logits[b,l] = <text_rep[b], label_rep[b,l]> in fp32."""
    return torch.einsum("bh,blh->bl", wide(text_rep), wide(label_rep))


def score_mlp(p: Params, text_rep: torch.Tensor, label_rep: torch.Tensor,
              compute_dtype) -> torch.Tensor:
    """MLP scorer over [label; text; label*text] features -> fp32 [B, L]."""
    t = text_rep[:, None, :].expand_as(label_rep)
    feats = torch.cat([label_rep, t, label_rep * t], dim=-1)
    group = tp_group("scorer")
    h = F.relu(linear(p["mlp_1"], copy_to_model(feats, group), compute_dtype))
    return wide(row_linear(p["mlp_2"], h, compute_dtype, group)[..., 0])


def score_weighted_dot(p: Params, text_rep: torch.Tensor, label_rep: torch.Tensor,
                       compute_dtype) -> torch.Tensor:
    """ScorerWeightedDot: text and label reps projected to 2H and split in
    halves; an MLP over [text_h0; label_h0; text_h1 * label_h1] -> fp32 [B, L]."""
    H = label_rep.shape[-1]
    t2 = linear(p["proj_text"], text_rep, compute_dtype)  # [B, 2H]
    l2 = linear(p["proj_label"], label_rep, compute_dtype)  # [B, L, 2H]
    t2 = t2[:, None, :].expand_as(l2)
    feats = torch.cat([t2[..., :H], l2[..., :H], t2[..., H:] * l2[..., H:]], dim=-1)
    group = tp_group("scorer")
    h = F.relu(linear(p["mlp_1"], copy_to_model(feats, group), compute_dtype))
    return wide(row_linear(p["mlp_2"], h, compute_dtype, group)[..., 0])


def fuse_layers(p: Params, states: torch.Tensor) -> torch.Tensor:
    """LayersFuser (``squeeze_layers``): softmax(weights)-weighted sum over
    the encoder states [N, B, S, H] (embedding output, then each layer) ->
    [B, S, H] in the states' dtype. A running fp32 sum over the N states,
    so no fp32 copy of the stack is made."""
    w = torch.softmax(p["weights"].float(), dim=0)
    out = w[0] * states[0].float()
    for i in range(1, states.shape[0]):
        out = out + w[i] * states[i].float()
    return out.to(states.dtype)


def _lstm_scan(p: Params, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One LSTM direction with pack_padded semantics over right-padded input:
    at a masked step the state freezes and the output is 0. x fp32 [B, S, H],
    mask bool [B, S] -> fp32 [B, S, h]. torch gate order (i, f, g, o);
    b = b_ih + b_hh. The input projection of every step is one product; the
    recurrence is a loop over S, all in fp32."""
    B, S, _ = x.shape
    w_hh = p["w_hh"].float()
    h_dim = w_hh.shape[0]
    xg = x @ p["w_ih"].float() + p["b"].float()  # [B, S, 4h]
    h = x.new_zeros((B, h_dim))
    c = x.new_zeros((B, h_dim))
    ys = []
    for t in range(S):
        z = xg[:, t] + h @ w_hh
        i, f, g, o = z.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        m = mask[:, t, None]
        h = torch.where(m, h_new, h)
        c = torch.where(m, c_new, c)
        ys.append(torch.where(m, h, 0.0))
    return torch.stack(ys, dim=1)


def bilstm(p: Params, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Bidirectional LSTM over the encoder states (``use_lstm``): H -> H (two
    H/2 directions), as torch's nn.LSTM(bidirectional, batch_first) over
    pack_padded_sequence, without the lengths on the host. The backward
    direction is the masked scan over the flipped padded sequence: its
    leading pad steps carry the zero state, which is "start at the last
    valid token". Arithmetic in fp32; the result in x's dtype."""
    mask = attention_mask.bool()
    xf = x.float()
    y_f = _lstm_scan(p["fwd"], xf, mask)
    y_b = _lstm_scan(p["bwd"], xf.flip(1), mask.flip(1)).flip(1)
    return torch.cat([y_f, y_b], dim=-1).to(x.dtype)


def gliclass_head(
    params: Params,
    hidden: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: GLiClassConfig,
    max_labels: int,
    compute_dtype=torch.float32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """hidden [B,S,H] -> (logits f32 [B,max_labels], label_mask [B,max_labels]).
    Padded label slots get NEG_LOGIT, so their sigmoid is 0."""
    label_emb, label_mask = extract_label_embeddings(
        hidden, input_ids, cfg.class_token_index, max_labels
    )
    span = None
    if cfg.extract_text_features:
        span = text_span_mask(
            input_ids, attention_mask, cfg.class_token_index, cfg.text_token_index,
            cfg.prompt_first,
        )
    text_rep = pool_text(hidden, attention_mask, cfg.pooling_strategy, span=span)
    # The simple scorer's fp32 product takes the projectors' last bias sums
    # as the JAX package's graph feeds them: unrounded.
    round_sum = cfg.scorer_type != "simple" or cfg.normalize_features
    text_rep = features_projector(
        params["text_projector"], text_rep, cfg.projector_hidden_act, compute_dtype, tp_group("text_projector"),
        round_sum,
    )
    label_emb = features_projector(
        params["classes_projector"], label_emb, cfg.projector_hidden_act, compute_dtype,
        tp_group("classes_projector"), round_sum,
    )
    if cfg.normalize_features:
        text_rep = text_rep / torch.clamp(
            torch.linalg.vector_norm(text_rep, dim=-1, keepdim=True), min=1e-12
        )
        label_emb = label_emb / torch.clamp(
            torch.linalg.vector_norm(label_emb, dim=-1, keepdim=True), min=1e-12
        )
    if cfg.scorer_type == "simple":
        logits = score_simple(text_rep, label_emb)
    elif cfg.scorer_type == "mlp":
        logits = score_mlp(params["scorer"], text_rep, label_emb, compute_dtype)
    elif cfg.scorer_type == "weighted-dot":
        logits = score_weighted_dot(params["scorer"], text_rep, label_emb, compute_dtype)
    else:
        raise ValueError(f"unsupported scorer_type: {cfg.scorer_type!r}")
    if "logit_scale" in params:
        # Learned CLIP-style scale, present iff the converted checkpoint had it.
        logits = logits * torch.exp(params["logit_scale"].float())
    logits = wide(logits)
    logits = torch.where(label_mask, logits, torch.full_like(logits, NEG_LOGIT))
    return logits, label_mask


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------
def init_head_params(generator: torch.Generator, cfg: GLiClassConfig, dtype=torch.float32,
                     device="cpu") -> Params:
    """Random head parameters in the JAX package's tree (its
    ``init_head_params``): the two projectors and cfg's scorer, weights
    N(0, 0.02), biases 0."""
    H = cfg.hidden_size
    g, kw = generator, dict(dtype=dtype, device=device)
    proj = lambda: {"linear_1": _init.dense(g, H, 4 * H, **kw), "linear_2": _init.dense(g, 4 * H, H, **kw)}
    params: Params = {"text_projector": proj(), "classes_projector": proj()}
    if cfg.scorer_type == "mlp":
        params["scorer"] = {"mlp_1": _init.dense(g, 3 * H, H, **kw), "mlp_2": _init.dense(g, H, 1, **kw)}
    elif cfg.scorer_type == "weighted-dot":
        params["scorer"] = {"proj_text": _init.dense(g, H, 2 * H, **kw),
                            "proj_label": _init.dense(g, H, 2 * H, **kw),
                            "mlp_1": _init.dense(g, 3 * H, H, **kw), "mlp_2": _init.dense(g, H, 1, **kw)}
    return params


def init_lstm_params(generator: torch.Generator, hidden_size: int, dtype=torch.float32,
                     device="cpu") -> Params:
    """Random BiLSTM parameters (H -> two H/2 directions) in the JAX
    package's tree (its ``init_lstm_params``): w_ih [H, 4h], w_hh [h, 4h]
    ~ N(0, 0.02), b [4h] = 0."""
    h = hidden_size // 2
    g, kw = generator, dict(dtype=dtype, device=device)
    direction = lambda: {"w_ih": _init.normal(g, (hidden_size, 4 * h), **kw),
                         "w_hh": _init.normal(g, (h, 4 * h), **kw), "b": _init.zeros((4 * h,), **kw)}
    return {"fwd": direction(), "bwd": direction()}
