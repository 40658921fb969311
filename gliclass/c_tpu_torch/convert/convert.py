"""Checkpoint converter: (HF gliclass checkpoint | torch reference model) ->
weight bundle, the port's copy of ``gliclass.c_tpu.convert.convert`` (and of
the local half of ``gliclass.c_tpu.fetch``: :func:`convert_checkpoint_dir`).

The analog of reference ONNX_CONVERTING/convert_to_onnx.py end-to-end: load the
torch model, emit the engine artifact (param tree + config + tokenizer +
golden logits + optional INT8 weights) instead of an ONNX graph. The bundle's
files are byte-equal to the JAX package's for the same model.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ..config import GLiClassConfig
from ..ops.quant import quantize_tree
from ..tokenization import PromptTokenizer
from .bundle import read_safetensors, save_bundle
from .hf_backbones import _dense, _t, convert_deberta_state_dict, convert_llama_state_dict
from .torch_ref import build_torch_gliclass, golden_logits

Params = dict[str, Any]

# The reference exporter's canonical QA sample
# (reference ONNX_CONVERTING/convert_to_onnx.py:57-58, test_onnx.py:64-65).
CANONICAL_TEXT = (
    "ONNX is an open-source format designed to enable the interoperability "
    "of AI models across various frameworks and tools."
)
CANONICAL_LABELS = ["format", "model", "tool", "cat"]


def convert_head_state_dict(sd: Mapping, cfg: GLiClassConfig) -> Params:
    """gliclass-package head weights (text_projector/classes_projector/scorer)
    -> heads.py param tree."""
    head: Params = {}
    for proj in ("text_projector", "classes_projector"):
        head[proj] = {
            "linear_1": _dense(sd, f"{proj}.linear_1"),
            "linear_2": _dense(sd, f"{proj}.linear_2"),
        }
    if cfg.scorer_type == "mlp":
        head["scorer"] = {
            "mlp_1": _dense(sd, "scorer.mlp_1"),
            "mlp_2": _dense(sd, "scorer.mlp_2"),
        }
    elif cfg.scorer_type == "weighted-dot":
        head["scorer"] = {
            "proj_text": _dense(sd, "scorer.proj_text"),
            "proj_label": _dense(sd, "scorer.proj_label"),
            "mlp_1": _dense(sd, "scorer.mlp_1"),
            "mlp_2": _dense(sd, "scorer.mlp_2"),
        }
    if "logit_scale" in sd:
        # Learned CLIP-style scale: presence in the state dict is the evidence
        # the upstream forward instantiates it (see config.py
        # logit_scale_init_value); heads.gliclass_head applies exp(logit_scale).
        head["logit_scale"] = _t(sd, "logit_scale").reshape(())
    return head


def convert_lstm_state_dict(sd: Mapping, prefix: str = "lstm") -> Params:
    """torch nn.LSTM (1 layer, bidirectional) -> heads.bilstm param tree.

    torch stores weight_ih_l0 [4h, H] / weight_hh_l0 [4h, h] with gate order
    (i, f, g, o); our scan wants them transposed and the two biases summed.
    """

    def direction(suffix: str) -> Params:
        return {
            "w_ih": _t(sd, f"{prefix}.weight_ih_l0{suffix}").T.copy(),
            "w_hh": _t(sd, f"{prefix}.weight_hh_l0{suffix}").T.copy(),
            "b": (
                _t(sd, f"{prefix}.bias_ih_l0{suffix}")
                + _t(sd, f"{prefix}.bias_hh_l0{suffix}")
            ),
        }

    return {"fwd": direction(""), "bwd": direction("_reverse")}


def convert_gliclass_state_dict(sd: Mapping, cfg: GLiClassConfig) -> Params:
    """Full GLiClassUniEncoder state_dict -> {"backbone": ..., "head": ...}.

    Backbone keys are expected under the ``encoder_model.`` prefix (the
    gliclass-package attribute name).
    """
    bb_sd = {
        k[len("encoder_model.") :]: v
        for k, v in sd.items()
        if k.startswith("encoder_model.")
    }
    bb = cfg.backbone
    if bb.model_type == "deberta-v2":
        backbone = convert_deberta_state_dict(bb_sd, bb)
    elif bb.model_type in ("llama", "qwen2"):
        backbone = convert_llama_state_dict(bb_sd, bb)
    else:
        raise ValueError(f"unsupported backbone: {bb.model_type!r}")
    params = {"backbone": backbone, "head": convert_head_state_dict(sd, cfg)}
    if cfg.use_lstm:
        params["lstm"] = convert_lstm_state_dict(sd)
    if cfg.squeeze_layers:
        params["layers_fuser"] = {"weights": _t(sd, "layer_weights")}
    return params


def load_checkpoint_state_dict(model, sd: Mapping) -> None:
    """Load a published-checkpoint state dict into the torch reference model,
    loudly.

    The published ``GLiClassModel`` wrapper nests the whole uni-encoder under a
    ``model.`` prefix (``model.encoder_model.*``, ``model.text_projector.*``,
    ...); strip it when present. Then require every *parameter* of the model to
    be matched by a same-shaped checkpoint tensor — a silent
    ``strict=False`` load that matches zero keys (the round-1 failure mode)
    becomes a hard error listing what is missing/mismatched. Non-parameter
    buffers (position ids, rotary caches) may legitimately be absent. Extra
    checkpoint keys (poolers, task heads) are ignored, mirroring what the
    reference exporter implicitly drops when tracing only the scoring path.

    ``logit_scale`` is the one evidence-driven exception: the model creates
    the parameter whenever the config carries ``logit_scale_init_value`` (all
    published configs do), but whether the upstream forward actually
    instantiates it is only observable from the checkpoint. A checkpoint
    containing the tensor loads it (and the forward scales by its exp); a
    checkpoint without it proves the upstream never created it, so the
    parameter is REMOVED here (not silently kept at its init value, which
    would scale every converted logit by exp(2.6592) ~= 14.3x)."""
    names = {k for k, _ in model.named_parameters()}
    if not any(k in sd for k in names):
        prefixed = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
        if any(k in prefixed for k in names):
            sd = prefixed
    if "logit_scale" in names and "logit_scale" not in sd:
        print(
            "note: checkpoint has no trained logit_scale tensor — the "
            "config's logit_scale_init_value is unused by the upstream "
            "uni-encoder forward; converting without logit scaling",
            file=sys.stderr,
        )
        del model.logit_scale
        model.logit_scale = None
        names.discard("logit_scale")
    model_sd = model.state_dict()
    missing = sorted(k for k in names if k not in sd)
    mismatched = sorted(
        f"{k}: checkpoint {tuple(sd[k].shape)} vs model {tuple(model_sd[k].shape)}"
        for k in names
        if k in sd and tuple(sd[k].shape) != tuple(model_sd[k].shape)
    )
    if missing or mismatched:
        raise ValueError(
            "checkpoint does not match the GLiClass uni-encoder reconstruction\n"
            + (f"  missing parameters ({len(missing)}): {missing[:8]}...\n" if missing else "")
            + (f"  shape mismatches ({len(mismatched)}): {mismatched[:8]}\n" if mismatched else "")
            + f"  checkpoint keys look like: {sorted(sd)[:4]}"
        )
    model.load_state_dict({k: v for k, v in sd.items() if k in model_sd}, strict=False)


def _floats_to(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor of ``tree`` in ``dtype`` (INT8 leaves kept)."""
    if isinstance(tree, dict):
        return {k: _floats_to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if isinstance(tree, torch.Tensor) and tree.is_floating_point() else tree


def forward_golden_logits(
    cfg: GLiClassConfig,
    params: Params,
    tokenizer,
    texts: Sequence[str],
    labels: Sequence[Sequence[str]],
    same_labels: bool,
    prompt_first: bool | None = None,
    max_length: int = 1024,
    device="cpu",
    dtype: str = "float32",
) -> dict[str, Any]:
    """The golden-logit record of :func:`.torch_ref.golden_logits` from the
    port's own fp32 forward (``params``: numpy or CPU tensors), for a bundle
    made without ``transformers``: the logits of the packed prompts at
    ``max_length``, rounded to 5 decimals. ``prompt_first`` defaults to the
    config's. Goldens are recorded on the host CPU (``device``'s default);
    on the card the same record holds the card's fp32 logits.

    ``dtype`` "float64" runs a decoder backbone's forward in fp64 on the
    CPU: the exact logits to the record's 5 decimals, on any host. An fp32
    forward on the CPU moves with the host's code paths (AVX2 or AVX-512
    sums, threads): at the decoders' real-scale widths, whose logits reach
    |logit| 45, by up to 4e-4 (``scripts/golden_host_spread.py``), near
    the 1e-3 the fp32 ``selftest`` holds the card to."""
    from ..config import RuntimeConfig
    from ..engine import InferenceEngine
    from ..models.gliclass import gliclass_forward
    from ..prompting import pack_prompts

    prompt_first = cfg.prompt_first if prompt_first is None else prompt_first
    ptok = tokenizer if isinstance(tokenizer, PromptTokenizer) else PromptTokenizer(tokenizer)
    batch = ptok.encode_batch(pack_prompts(texts, labels, same_labels, prompt_first), max_length=max_length)
    n_labels = max(len(labels[0] if same_labels else labels[i]) for i in range(len(texts)))
    compute = {"float32": torch.float32, "float64": torch.float64}[dtype]
    if compute == torch.float64 and (torch.device(device).type != "cpu" or cfg.backbone.model_type == "deberta-v2"):
        raise ValueError("float64 goldens: a decoder backbone, on the CPU")
    engine = InferenceEngine(cfg, params, RuntimeConfig(max_length=max_length, compute_dtype="float32"),
                             device=device)
    run_params = _floats_to(engine.params, compute)
    with torch.inference_mode():
        logits = gliclass_forward(run_params, torch.from_numpy(batch.input_ids).to(engine.device),
                                  torch.from_numpy(batch.attention_mask).to(engine.device), cfg, n_labels,
                                  compute).cpu()
    return {
        "texts": list(texts),
        "labels": [list(l) for l in labels],
        "same_labels": same_labels,
        "prompt_first": prompt_first,
        "max_length": max_length,
        "logits": np.round(logits.numpy().astype(np.float64), 5).tolist(),
    }


def export_bundle(
    torch_model,
    cfg: GLiClassConfig,
    tokenizer,
    out_path: str,
    quantize: bool = False,
    golden_samples: Sequence[tuple[Sequence[str], Sequence[Sequence[str]], bool]]
    | None = None,
) -> Params:
    """torch GLiClass model -> saved bundle (+ optional INT8 weights).

    golden_samples: list of (texts, labels, same_labels); defaults to the
    reference's canonical sample in both prompt orders.
    """
    params = convert_gliclass_state_dict(torch_model.state_dict(), cfg)

    ptok = tokenizer if isinstance(tokenizer, PromptTokenizer) else PromptTokenizer(tokenizer)
    if golden_samples is None:
        golden_samples = [([CANONICAL_TEXT], [CANONICAL_LABELS], True)]
    goldens = [
        golden_logits(
            torch_model, ptok, cfg, texts, labels, same, cfg.prompt_first
        )
        for texts, labels, same in golden_samples
    ]

    int8_params = quantize_tree(params) if quantize else None
    tok_json = ptok._tok.to_str()
    save_bundle(
        out_path, cfg, params,
        tokenizer_json=tok_json, goldens=goldens, int8_params=int8_params,
    )
    return params


def convert_checkpoint_dir(
    ckpt_dir: str, bundle_path: str, model_name: str, quantize: bool = True
) -> None:
    """Local HF gliclass checkpoint dir (config.json, tokenizer.json and
    model.safetensors or pytorch_model.bin) -> bundle (the CLI's
    ``convert``). model.safetensors is read with the port's own reader
    (:func:`.bundle.read_safetensors`; BF16 tensors widen to fp32 exactly),
    pytorch_model.bin with ``torch.load(weights_only=True)``."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = GLiClassConfig.from_dict(json.load(f))
    cfg = dataclasses.replace(cfg, original_model_name=model_name)

    tok = PromptTokenizer.from_file(os.path.join(ckpt_dir, "tokenizer.json"))
    if cfg.class_token_index < 0:
        if tok.label_token_id is None or tok.sep_token_id is None:
            raise ValueError(
                "config has no class/text_token_index and the tokenizer does "
                "not define <<LABEL>>/<<SEP>> — not a GLiClass checkpoint?"
            )
        cfg = dataclasses.replace(
            cfg,
            class_token_index=tok.label_token_id,
            text_token_index=tok.sep_token_id,
        )
    elif tok.label_token_id is not None and tok.label_token_id != cfg.class_token_index:
        raise ValueError(
            f"tokenizer <<LABEL>> id {tok.label_token_id} != config "
            f"class_token_index {cfg.class_token_index}: tokenizer.json does "
            "not belong to this checkpoint"
        )

    model = build_torch_gliclass(cfg)
    st = os.path.join(ckpt_dir, "model.safetensors")
    pt = os.path.join(ckpt_dir, "pytorch_model.bin")
    if os.path.exists(st):
        sd = {k: torch.from_numpy(v) for k, v in read_safetensors(st).items()}
    elif os.path.exists(pt):
        sd = torch.load(pt, map_location="cpu", weights_only=True)
    else:
        raise FileNotFoundError(f"no weights file in {ckpt_dir}")
    # Strict, prefix-aware loading: errors on zero-matched or mismatched keys
    # instead of silently baking random-init goldens into the bundle.
    load_checkpoint_state_dict(model, sd)
    export_bundle(model, cfg, tok, bundle_path, quantize=quantize)
