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
from .deberta import deberta_encode
from .heads import gliclass_head
from .llama import llama_encode

Params = dict[str, Any]


def encode_backbone(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: GLiClassConfig,
    compute_dtype,
) -> torch.Tensor:
    """[B,S] ids + mask -> [B,S,H] hidden states of the configured backbone."""
    bb = cfg.backbone
    if bb.model_type == "deberta-v2":
        return deberta_encode(params, input_ids, attention_mask, bb, compute_dtype)
    if bb.model_type in ("llama", "qwen2"):
        return llama_encode(params, input_ids, attention_mask, bb, compute_dtype)
    raise ValueError(f"unsupported backbone model_type: {bb.model_type!r}")


def gliclass_forward(
    params: Params,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    cfg: GLiClassConfig,
    max_labels: int,
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """[B,S] ids + mask -> fp32 logits [B, max_labels]."""
    if cfg.architecture_type != "uni-encoder":
        raise ValueError(
            f"unsupported architecture_type: {cfg.architecture_type!r} "
            "(the exporter enforces uni-encoder too; reference "
            "ONNX_CONVERTING/convert_to_onnx.py:48-52)"
        )
    hidden = encode_backbone(params["backbone"], input_ids, attention_mask, cfg, compute_dtype)
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
) -> torch.Tensor:
    """Forward + sigmoid on the device (fp32 [B, max_labels])."""
    return torch.sigmoid(
        gliclass_forward(params, input_ids, attention_mask, cfg, max_labels, compute_dtype)
    )
