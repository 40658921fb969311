"""GLiClassModel: backbone encoder + scoring head, one forward.

input_ids + attention_mask in, per-label logits out — the I/O contract of the
reference's exported graph (reference ONNX_CONVERTING/convert_to_onnx.py:63-79).
Zero-shot classification is one forward pass per text: labels ride in the
prompt. The backbone is a DeBERTa-v2/v3 encoder or a Llama/Qwen2 decoder
run as a causal encoder.
"""

from __future__ import annotations

from typing import Any

import torch

from ..config import GLiClassConfig
from ..parallel.collectives import all_gather_seq, seq_shard
from .deberta import deberta_encode, init_deberta_params
from .heads import bilstm, fuse_layers, gliclass_head, init_head_params, init_lstm_params
from .llama import init_llama_params, llama_encode

Params = dict[str, Any]


def encode_backbone(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: GLiClassConfig,
    compute_dtype,
    attn_route: str = "auto",
    return_all_layers: bool = False,
    fuser: Params | None = None,
) -> torch.Tensor:
    """[B,S] ids + mask -> [B,S,H] hidden states of the configured backbone
    (with ``return_all_layers``, every state stacked [L+1, B, S, H]; with
    ``fuser``, the ``layers_fuser`` params, every state fused by
    :func:`~.heads.fuse_layers`). ``attn_route`` selects the attention route
    (decoders: "xla"/"table" the score path, any other K5).

    Under ``parallel.collectives.seq_parallel``, at a length the seq group's
    size divides, each seq rank encodes its block of the tokens
    (``seq_shard``); the fuser, which is per token, runs on the block, and
    the states are all-gathered once over the seq group. Other lengths run
    seq-replicated."""
    bb = cfg.backbone
    seq = seq_shard(input_ids.shape[1])
    all_layers = return_all_layers or fuser is not None
    if bb.model_type == "deberta-v2":
        h = deberta_encode(params, input_ids, attention_mask, bb, compute_dtype, attn_route, all_layers, seq)
    elif bb.model_type in ("llama", "qwen2"):
        h = llama_encode(params, input_ids, attention_mask, bb, compute_dtype, attn_route, all_layers, seq)
    else:
        raise ValueError(f"unsupported backbone model_type: {bb.model_type!r}")
    if fuser is not None:
        h = fuse_layers(fuser, h)
    return h if seq is None else all_gather_seq(h, -2, seq.group)


def gliclass_forward(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: GLiClassConfig,
    max_labels: int,
    compute_dtype=torch.float32,
    attn_route: str = "auto",
) -> torch.Tensor:
    """[B,S] ids + mask -> fp32 logits [B, max_labels]. ``squeeze_layers``
    mixes every encoder state with the layer fuser, then ``use_lstm`` refines
    the states with the BiLSTM, before the head (the JAX package's order)."""
    if cfg.architecture_type != "uni-encoder":
        raise ValueError(
            f"unsupported architecture_type: {cfg.architecture_type!r} "
            "(the exporter enforces uni-encoder too; reference "
            "ONNX_CONVERTING/convert_to_onnx.py:48-52)"
        )
    hidden = encode_backbone(
        params["backbone"], input_ids, attention_mask, cfg, compute_dtype, attn_route,
        fuser=params["layers_fuser"] if cfg.squeeze_layers else None,
    )
    if cfg.use_lstm:
        hidden = bilstm(params["lstm"], hidden, attention_mask)
    logits, _ = gliclass_head(
        params["head"], hidden, input_ids, attention_mask, cfg, max_labels, compute_dtype
    )
    return logits


def gliclass_probs(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: GLiClassConfig,
    max_labels: int,
    compute_dtype=torch.float32,
    attn_route: str = "auto",
) -> torch.Tensor:
    """Forward + sigmoid on the device (fp32 [B, max_labels])."""
    return torch.sigmoid(
        gliclass_forward(
            params, input_ids, attention_mask, cfg, max_labels, compute_dtype, attn_route
        )
    )


def init_gliclass_params(generator: torch.Generator, cfg: GLiClassConfig, dtype=torch.float32,
                         device="cpu") -> Params:
    """Random GLiClass parameters in the JAX package's tree (its
    ``init_gliclass_params``), all drawn from ``generator``: the backbone,
    the head, the BiLSTM with ``use_lstm`` and the fuser's weights (zeros of
    [L + 1]) with ``squeeze_layers``."""
    bb = cfg.backbone
    if bb.model_type == "deberta-v2":
        backbone = init_deberta_params(generator, bb, dtype, device)
    elif bb.model_type in ("llama", "qwen2"):
        backbone = init_llama_params(generator, bb, dtype, device)
    else:
        raise ValueError(f"unsupported backbone model_type: {bb.model_type!r}")
    params = {"backbone": backbone, "head": init_head_params(generator, cfg, dtype, device)}
    if cfg.use_lstm:
        params["lstm"] = init_lstm_params(generator, cfg.hidden_size, dtype, device)
    if cfg.squeeze_layers:
        params["layers_fuser"] = {"weights": torch.zeros((bb.num_hidden_layers + 1,), dtype=dtype, device=device)}
    return params
