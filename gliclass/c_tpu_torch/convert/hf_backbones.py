"""HF (PyTorch) backbone state_dict -> the port's param trees (numpy).

Part of the offline model-production toolchain (the role of reference
ONNX_CONVERTING/convert_to_onnx.py: turning an HF checkpoint into the artifact
the engine executes), as ``gliclass.c_tpu.convert.hf_backbones`` does for the
JAX package, with the same trees; per-layer leaves are stacked with numpy.
The HF config translators (``backbone_config_from_hf*``,
``llama_config_from_hf``) live in the port's ``config``.

Naming convention: torch Linear stores weight [out, in]; our dense params store
"w" as [in, out], so every kernel is transposed once at conversion time.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from ..config import BackboneConfig

Params = dict[str, Any]


def _t(sd: Mapping[str, Any], name: str) -> np.ndarray:
    t = sd[name]
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _dense(sd, prefix: str, bias: bool = True) -> Params:
    p: Params = {"w": _t(sd, f"{prefix}.weight").T.copy()}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = _t(sd, f"{prefix}.bias")
    return p


def _ln(sd, prefix: str) -> Params:
    return {"scale": _t(sd, f"{prefix}.weight"), "bias": _t(sd, f"{prefix}.bias")}


def _stack(layers: list[Params]) -> Params:
    """Stack per-layer trees (same keys) along a new leading [L] axis."""
    if isinstance(layers[0], dict):
        return {k: _stack([layer[k] for layer in layers]) for k in layers[0]}
    return np.stack(layers)


def convert_deberta_state_dict(sd: Mapping[str, Any], cfg: BackboneConfig) -> Params:
    """transformers.DebertaV2Model state_dict -> deberta.py param tree."""
    params: Params = {
        "embeddings": {
            "word": _t(sd, "embeddings.word_embeddings.weight"),
            "ln": _ln(sd, "embeddings.LayerNorm"),
        }
    }
    if "embeddings.position_embeddings.weight" in sd:
        params["embeddings"]["pos"] = _t(sd, "embeddings.position_embeddings.weight")
    if "embeddings.embed_proj.weight" in sd:
        params["embeddings"]["proj"] = _dense(sd, "embeddings.embed_proj", bias=False)

    if cfg.relative_attention:
        params["rel_embeddings"] = _t(sd, "encoder.rel_embeddings.weight")
        if cfg.norm_rel_ebd == "layer_norm":
            params["rel_ln"] = _ln(sd, "encoder.LayerNorm")

    if cfg.conv_kernel_size > 0:
        # torch Conv1d weight is [out, in, k]; our conv stem wants WIO [k, in, out].
        params["conv"] = {
            "w": np.transpose(_t(sd, "encoder.conv.conv.weight"), (2, 1, 0)).copy(),
            "b": _t(sd, "encoder.conv.conv.bias"),
            "ln": _ln(sd, "encoder.conv.LayerNorm"),
        }

    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layer.{i}"
        layer = {
            "attn": {
                "q": _dense(sd, f"{pre}.attention.self.query_proj"),
                "k": _dense(sd, f"{pre}.attention.self.key_proj"),
                "v": _dense(sd, f"{pre}.attention.self.value_proj"),
                "o": _dense(sd, f"{pre}.attention.output.dense"),
                "ln": _ln(sd, f"{pre}.attention.output.LayerNorm"),
            },
            "ffn": {
                "up": _dense(sd, f"{pre}.intermediate.dense"),
                "down": _dense(sd, f"{pre}.output.dense"),
                "ln": _ln(sd, f"{pre}.output.LayerNorm"),
            },
        }
        if not cfg.share_att_key:
            if f"{pre}.attention.self.pos_key_proj.weight" in sd:
                layer["attn"]["pos_k"] = _dense(sd, f"{pre}.attention.self.pos_key_proj")
            if f"{pre}.attention.self.pos_query_proj.weight" in sd:
                layer["attn"]["pos_q"] = _dense(sd, f"{pre}.attention.self.pos_query_proj")
        layers.append(layer)
    params["layers"] = _stack(layers)
    return params


def convert_llama_state_dict(sd: Mapping[str, Any], cfg: BackboneConfig) -> Params:
    """transformers LlamaModel / Qwen2Model state_dict -> llama.py param tree."""
    layers = []
    for i in range(cfg.num_hidden_layers):
        pre = f"layers.{i}"
        layers.append(
            {
                "attn": {
                    "q": _dense(sd, f"{pre}.self_attn.q_proj"),
                    "k": _dense(sd, f"{pre}.self_attn.k_proj"),
                    "v": _dense(sd, f"{pre}.self_attn.v_proj"),
                    "o": _dense(sd, f"{pre}.self_attn.o_proj"),
                },
                "attn_norm": {"scale": _t(sd, f"{pre}.input_layernorm.weight")},
                "mlp": {
                    "gate": _dense(sd, f"{pre}.mlp.gate_proj"),
                    "up": _dense(sd, f"{pre}.mlp.up_proj"),
                    "down": _dense(sd, f"{pre}.mlp.down_proj"),
                },
                "mlp_norm": {
                    "scale": _t(sd, f"{pre}.post_attention_layernorm.weight")
                },
            }
        )
    return {
        "embeddings": {"word": _t(sd, "embed_tokens.weight")},
        "layers": _stack(layers),
        "final_norm": {"scale": _t(sd, "norm.weight")},
    }
