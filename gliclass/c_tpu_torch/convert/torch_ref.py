"""PyTorch reference implementation of the GLiClass model (offline toolchain).

Role (mirrors reference ONNX_CONVERTING/convert_to_onnx.py:11-28): produce fp32
golden logits that ship inside the weight bundle and gate the engine's
numerics — the same golden-logit regression pattern the reference uses
(config.json "original_logits"; reference ONNX_CONVERTING/test_onnx.py:25-31).
The same model as ``gliclass.c_tpu.convert.torch_ref``, on the port's own
prompting and tokenization.

This is an independent implementation (torch + transformers backbone vs the
port's forward), so agreement between the two is a real parity check.
Module/parameter naming follows the HF ``gliclass`` package
(GLiClassUniEncoder: encoder_model / text_projector / classes_projector /
scorer; FeaturesProjector: linear_1 / linear_2) so that real published
checkpoints load into it via ``load_state_dict``.

``transformers`` is imported lazily, inside :func:`_build_torch_backbone`:
only building a model needs it, not importing this module.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import GLiClassConfig
from ..prompting import pack_prompts
from ..tokenization import PromptTokenizer


def _act(name: str):
    return {"gelu": F.gelu, "relu": F.relu, "silu": F.silu, "tanh": torch.tanh}[name]


def build_torch_gliclass(cfg: GLiClassConfig, seed: int = 0):
    """Construct the torch reference model (random init unless weights loaded)."""
    torch.manual_seed(seed)
    H = cfg.hidden_size

    class FeaturesProjector(nn.Module):
        def __init__(self):
            super().__init__()
            self.linear_1 = nn.Linear(H, H * 4)
            self.act = _act(cfg.projector_hidden_act)
            self.linear_2 = nn.Linear(H * 4, H)

        def forward(self, x):
            return self.linear_2(self.act(self.linear_1(x)))

    class MLPScorer(nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp_1 = nn.Linear(3 * H, H)
            self.mlp_2 = nn.Linear(H, 1)

        def forward(self, text_rep, label_rep):
            B, L, _ = label_rep.shape
            t = text_rep.unsqueeze(1).expand(B, L, H)
            feats = torch.cat([label_rep, t, label_rep * t], dim=-1)
            return self.mlp_2(torch.relu(self.mlp_1(feats))).squeeze(-1)

    class WeightedDotScorer(nn.Module):
        """ScorerWeightedDot reconstruction (GLiNER-family scorer used by the
        gliclass package): 2H projections split in halves, MLP over
        [text_h0; label_h0; text_h1 * label_h1]."""

        def __init__(self):
            super().__init__()
            self.proj_text = nn.Linear(H, 2 * H)
            self.proj_label = nn.Linear(H, 2 * H)
            self.mlp_1 = nn.Linear(3 * H, H)
            self.mlp_2 = nn.Linear(H, 1)

        def forward(self, text_rep, label_rep):
            B, L, _ = label_rep.shape
            t2 = self.proj_text(text_rep).unsqueeze(1).expand(B, L, 2 * H)
            l2 = self.proj_label(label_rep)
            feats = torch.cat(
                [t2[..., :H], l2[..., :H], t2[..., H:] * l2[..., H:]], dim=-1
            )
            return self.mlp_2(torch.relu(self.mlp_1(feats))).squeeze(-1)

    class GLiClassUniEncoder(nn.Module):
        def __init__(self):
            super().__init__()
            self.encoder_model = _build_torch_backbone(cfg)
            self.text_projector = FeaturesProjector()
            self.classes_projector = FeaturesProjector()
            if cfg.scorer_type == "mlp":
                self.scorer = MLPScorer()
            elif cfg.scorer_type == "weighted-dot":
                self.scorer = WeightedDotScorer()
            if cfg.use_lstm:
                # LstmSeq2SeqEncoder reconstruction: 1-layer BiLSTM H -> H.
                self.lstm = nn.LSTM(
                    H, H // 2, num_layers=1, bidirectional=True, batch_first=True
                )
            if cfg.squeeze_layers:
                # LayersFuser reconstruction: softmax-weighted state mix.
                self.layer_weights = nn.Parameter(
                    torch.randn(cfg.backbone.num_hidden_layers + 1)
                )
            if cfg.logit_scale_init_value is not None:
                # CLIP-style learned logit scale (init 2.6592 == ln(1/0.07),
                # CLIP's exact value): logits *= exp(logit_scale). Created
                # from the config init; load_checkpoint_state_dict REMOVES it
                # when the checkpoint carries no trained tensor (evidence the
                # upstream forward never instantiated it) — see
                # convert/convert.py and PARITY.md "logit_scale".
                self.logit_scale = nn.Parameter(
                    torch.tensor(float(cfg.logit_scale_init_value))
                )

        def forward(self, input_ids, attention_mask, max_labels: int):
            enc = self.encoder_model(
                input_ids=input_ids,
                attention_mask=attention_mask,
                output_hidden_states=cfg.squeeze_layers,
            )
            if cfg.squeeze_layers:
                states = torch.stack(enc.hidden_states)  # [L+1,B,S,H]
                w = torch.softmax(self.layer_weights, dim=0)
                hidden = torch.einsum("n,nbsh->bsh", w, states)
            else:
                hidden = enc.last_hidden_state  # [B,S,H]
            if cfg.use_lstm:
                from torch.nn.utils.rnn import (
                    pack_padded_sequence,
                    pad_packed_sequence,
                )

                lengths = attention_mask.sum(dim=1).cpu()
                packed = pack_padded_sequence(
                    hidden, lengths, batch_first=True, enforce_sorted=False
                )
                out, _ = self.lstm(packed)
                hidden, _ = pad_packed_sequence(
                    out, batch_first=True, total_length=hidden.shape[1]
                )
            B, S, _ = hidden.shape

            is_label = input_ids == cfg.class_token_index
            ordinal = torch.cumsum(is_label.long(), dim=-1) - 1
            slots = torch.arange(max_labels)
            onehot = (ordinal.unsqueeze(-1) == slots) & is_label.unsqueeze(-1)
            label_emb = torch.einsum(
                "bsl,bsh->blh", onehot.to(hidden.dtype), hidden
            )
            counts = is_label.sum(-1)
            label_mask = slots.unsqueeze(0) < counts.unsqueeze(1)

            if cfg.extract_text_features:
                # Pool only the raw-text span (mirror of models/heads.py
                # text_span_mask; reconstructed semantics — see PARITY.md).
                valid = attention_mask.bool()
                is_sep = input_ids == cfg.text_token_index
                if cfg.prompt_first:
                    after = (torch.cumsum(is_sep.long(), dim=-1) - is_sep.long()) >= 1
                    span = after & valid & ~is_sep & ~is_label
                else:
                    span = (torch.cumsum(is_label.long(), dim=-1) == 0) & valid & ~is_sep
                has = span.any(-1, keepdim=True)
                span = torch.where(has, span, valid)
                pool_mask = span.long()
            else:
                span = None
                pool_mask = attention_mask

            if cfg.pooling_strategy == "first":
                if span is None:
                    text_rep = hidden[:, 0]
                else:
                    first = span.long().argmax(dim=-1)
                    text_rep = hidden[torch.arange(B), first]
            elif cfg.pooling_strategy == "mean":
                m = pool_mask.unsqueeze(-1).to(hidden.dtype)
                text_rep = (hidden * m).sum(1) / m.sum(1).clamp(min=1.0)
            elif cfg.pooling_strategy == "max":
                m = pool_mask.unsqueeze(-1).bool()
                text_rep = hidden.masked_fill(~m, torch.finfo(hidden.dtype).min).max(1).values
            elif cfg.pooling_strategy == "sum":
                m = pool_mask.unsqueeze(-1).to(hidden.dtype)
                text_rep = (hidden * m).sum(1)
            else:
                raise ValueError(cfg.pooling_strategy)

            text_rep = self.text_projector(text_rep)
            label_emb = self.classes_projector(label_emb)
            if cfg.normalize_features:
                text_rep = torch.nn.functional.normalize(text_rep, dim=-1)
                label_emb = torch.nn.functional.normalize(label_emb, dim=-1)

            if cfg.scorer_type == "simple":
                logits = torch.einsum("bh,blh->bl", text_rep, label_emb)
            elif cfg.scorer_type in ("mlp", "weighted-dot"):
                logits = self.scorer(text_rep, label_emb)
            else:
                raise ValueError(cfg.scorer_type)

            if getattr(self, "logit_scale", None) is not None:
                logits = logits * self.logit_scale.exp()

            return logits.masked_fill(~label_mask, -1e4), label_mask

    return GLiClassUniEncoder().eval()


def _build_torch_backbone(cfg: GLiClassConfig):
    bb = cfg.backbone
    if bb.model_type == "deberta-v2":
        from transformers import DebertaV2Config, DebertaV2Model

        return DebertaV2Model(
            DebertaV2Config(
                vocab_size=bb.vocab_size,
                hidden_size=bb.hidden_size,
                num_hidden_layers=bb.num_hidden_layers,
                num_attention_heads=bb.num_attention_heads,
                intermediate_size=bb.intermediate_size,
                hidden_act=bb.hidden_act,
                max_position_embeddings=bb.max_position_embeddings,
                relative_attention=bb.relative_attention,
                position_buckets=bb.position_buckets,
                max_relative_positions=bb.max_relative_positions,
                pos_att_type=list(bb.pos_att_type),
                share_att_key=bb.share_att_key,
                norm_rel_ebd=bb.norm_rel_ebd,
                position_biased_input=bb.position_biased_input,
                layer_norm_eps=bb.layer_norm_eps,
                pad_token_id=bb.pad_token_id,
                hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0,
                type_vocab_size=0,
                conv_kernel_size=bb.conv_kernel_size,
                conv_act=bb.conv_act,
            )
        )
    if bb.model_type == "llama":
        from transformers import LlamaConfig, LlamaModel

        return LlamaModel(
            LlamaConfig(
                vocab_size=bb.vocab_size,
                hidden_size=bb.hidden_size,
                num_hidden_layers=bb.num_hidden_layers,
                num_attention_heads=bb.num_attention_heads,
                num_key_value_heads=bb.kv_heads,
                intermediate_size=bb.intermediate_size,
                max_position_embeddings=bb.max_position_embeddings,
                rope_theta=bb.rope_theta,
                rms_norm_eps=bb.rms_norm_eps,
                attention_bias=bb.attention_bias,
                attention_dropout=0.0,
            )
        )
    if bb.model_type == "qwen2":
        from transformers import Qwen2Config, Qwen2Model

        return Qwen2Model(
            Qwen2Config(
                vocab_size=bb.vocab_size,
                hidden_size=bb.hidden_size,
                num_hidden_layers=bb.num_hidden_layers,
                num_attention_heads=bb.num_attention_heads,
                num_key_value_heads=bb.kv_heads,
                intermediate_size=bb.intermediate_size,
                max_position_embeddings=bb.max_position_embeddings,
                rope_theta=bb.rope_theta,
                rms_norm_eps=bb.rms_norm_eps,
                attention_dropout=0.0,
            )
        )
    raise ValueError(f"unsupported backbone: {bb.model_type!r}")


def golden_logits(
    model,
    tokenizer,
    cfg: GLiClassConfig,
    texts: Sequence[str],
    labels: Sequence[Sequence[str]],
    same_labels: bool,
    prompt_first: bool,
    max_length: int = 1024,
) -> dict[str, Any]:
    """Run the torch reference on canonical samples -> golden-logit record.

    Mirrors get_original_logits/create_config of the reference exporter
    (reference ONNX_CONVERTING/convert_to_onnx.py:11-28): fp32 logits rounded to
    5 decimals, stored with the inputs that produced them.
    """
    ptok = tokenizer if isinstance(tokenizer, PromptTokenizer) else PromptTokenizer(tokenizer)
    prompts = pack_prompts(texts, labels, same_labels, prompt_first)
    batch = ptok.encode_batch(prompts, max_length=max_length)
    n_labels = max(
        len(labels[0] if same_labels else labels[i]) for i in range(len(texts))
    )
    with torch.no_grad():
        logits, _ = model(
            torch.tensor(batch.input_ids.astype(np.int64)),
            torch.tensor(batch.attention_mask.astype(np.int64)),
            max_labels=n_labels,
        )
    return {
        "texts": list(texts),
        "labels": [list(l) for l in labels],
        "same_labels": same_labels,
        "prompt_first": prompt_first,
        "max_length": max_length,
        "logits": np.round(logits.numpy().astype(np.float64), 5).tolist(),
    }
