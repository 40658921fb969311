"""Runtime and model configuration of the PyTorch port.

The reference engine (GLiClass.c) splits configuration across three static tiers:
compile-time macros (reference include/configs.h:4-7), CLI argv (reference main.c:54-67),
and the exported model's config.json (reference ONNX_CONVERTING/convert_to_onnx.py:19-28).
Here everything is a runtime dataclass: one :class:`RuntimeConfig` for engine knobs and
one :class:`GLiClassConfig` (+ backbone config) shipped inside the weight bundle. The
bundle ``config.json`` schema is shared with ``gliclass.c_tpu``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np


# Defaults mirror reference include/configs.h:4-7 (BATCH_SIZE 8, MAX_LENGTH 2048,
# THRESHOLD 0.5f, NUM_THREADS 8) but are runtime-configurable, not compile-time.
DEFAULT_BATCH_SIZE = 8
DEFAULT_MAX_LENGTH = 2048
DEFAULT_THRESHOLD = 0.5


# Every value of the JAX package's GLICLASS_TPU_ATTN_ROUTE. "table" and
# "xla" force the materialized-score path (models/deberta.py score_attention).
ATTN_ROUTES = ("auto", "flash", "bias", "row", "tiled", "table", "xla")


def launch_world() -> tuple[str, int, int, int, int] | None:
    """(init_method, world size, rank, local rank, local world size) from
    a launcher's variables, or None when neither set is present: the JAX
    package's ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``, or
    torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``.
    The JAX variables say nothing of hosts: ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``, where set, place the rank on its host; else the
    world is taken as one host."""
    env = os.environ
    if env.get("COORDINATOR_ADDRESS") and env.get("NUM_PROCESSES") and env.get("PROCESS_ID"):
        init = f"tcp://{env['COORDINATOR_ADDRESS']}"
        world, rank = int(env["NUM_PROCESSES"]), int(env["PROCESS_ID"])
    elif all(env.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")):
        init = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return None
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    return init, world, rank, local_rank, local_world


def check_attn_route(route: str) -> str:
    """Validate an attention route name."""
    if route not in ATTN_ROUTES:
        raise ValueError(f"unknown attention route {route!r}; expected one of {ATTN_ROUTES}")
    return route


@dataclass(frozen=True)
class RuntimeConfig:
    """Engine knobs (replaces reference include/configs.h + argv contract).

    ``prompt_first`` mirrors the second CLI argument of the reference binary
    (reference main.c:54-67); in this framework it normally comes from the model
    bundle's config and can be overridden here.
    """

    batch_size: int = DEFAULT_BATCH_SIZE
    max_length: int = DEFAULT_MAX_LENGTH
    threshold: float = DEFAULT_THRESHOLD
    # Pad each batch up to the nearest of these buckets instead of the
    # reference's pad-to-batch-max (reference src/tokenizer.c:44-54): a fixed
    # set of shapes per bucket keeps kernel launch geometries and the
    # host-side planning stable. Tune the ladder to the length distribution
    # of the workload.
    seq_buckets: tuple[int, ...] = (64, 96, 128, 192, 256, 384, 512, 1024, 2048)
    # Bucketing for the number of candidate labels per text (scoring-head width).
    label_buckets: tuple[int, ...] = (4, 8, 16, 32, 64)
    # "float32" for parity testing, "bfloat16" for serving.
    compute_dtype: str = "bfloat16"
    # "none" (use bundle dtype) | "int8" (weight-only INT8 dequant fused into
    # the matmul) | "int8-dynamic" (w8a8: dynamic per-token INT8 activations +
    # int8xint8 products — the reference's ONNX dynamic-quantization
    # execution mode, DynamicQuantizeLinear+MatMulInteger)
    quant_mode: str = "none"
    # Mesh axes sizes (data, tensor, sequence parallel), as in the JAX
    # package: the engine runs over dp_size x sp_size x tp_size ranks of an
    # initialised torch.distributed world (parallel/mesh.py); a seq bucket
    # that sp_size does not divide runs seq-replicated.
    dp_size: int = 1
    tp_size: int = 1
    sp_size: int = 1
    # Tokenizer worker processes for large jobs (tokenization.PromptTokenizer
    # .pool): at most this many, and never more than this rank's share of
    # the host's cores allows (effective_tokenizer_workers).
    tokenizer_workers: int = 8
    # Overlap tokenization with device execution (scheduler.plan_and_run_
    # overlapped): tokenize on a producer thread while this thread assembles
    # and dispatches. "off" restores the barrier plan (tokenize everything,
    # then dispatch; the reference's three-phase design, main.c:116-155).
    overlap_tokenize: str = "auto"  # auto | on | off

    def overlap_enabled(self) -> bool:
        return self.overlap_tokenize != "off"

    def effective_tokenizer_workers(self) -> int:
        """Tokenizer worker processes: ``tokenizer_workers``, capped at this
        rank's share of the cores this process may run on less two, which
        stay free for its dispatching thread and the CUDA runtime's own
        threads; at least one. Every rank of a launch runs the whole batch
        plane (each encodes the whole job), so the cores are shared among
        the launch's ranks on this host (:func:`launch_world`)."""
        world = launch_world()
        ranks = 1 if world is None else max(1, world[4])
        cpus = len(os.sched_getaffinity(0))
        return max(1, min(self.tokenizer_workers, cpus // ranks - 2))

    # Use the native C++ host ops (prompt packing / batch assembly) when built.
    use_native_host_ops: bool = True
    # Fuse q/k/v projections into one wide matmul at engine load
    # (engine.fuse_qkv_params). Math-identical.
    fuse_qkv: bool = False
    # DeBERTa attention route: "auto" (ops.fused_attention.attention_route
    # picks by shape), "flash" (K1 everywhere), "bias" (tables + bias
    # products + K7 at every 8-aligned length), "row" (K8 at 8-aligned
    # lengths up to 512), "tiled" (windowed tables K9 + K10 at lengths that
    # are multiples of 32; other lengths of these three run K1), or "table"
    # / "xla" (the materialized-score path, no attention kernel). The JAX
    # package reads the same choice from GLICLASS_TPU_ATTN_ROUTE at trace
    # time; the port's CLI fills this field from that variable.
    attn_route: str = "auto"

    def __post_init__(self):
        check_attn_route(self.attn_route)

    def bucket_for_seq(self, length: int) -> int:
        for b in self.seq_buckets:
            if length <= b:
                return b
        return self.seq_buckets[-1]

    def bucket_for_labels(self, n: int) -> int:
        for b in self.label_buckets:
            if n <= b:
                return b
        return self.label_buckets[-1]


def suggest_seq_buckets(
    lengths,
    max_length: int = 512,
    budget: int = 10,
    granularity: int = 16,
) -> tuple[int, ...]:
    """Propose a seq-bucket ladder for a MEASURED prompt-length distribution.

    The JAX package's ladder rule, with every bucket capped at
    ``max_length`` (the JAX rule can return one above it): fine-grained buckets
    (multiples of ``granularity``) through the POPULATED range between the
    p5 and p95 of the distribution, then a coarse power-of-two-ish tail up
    to ``max_length`` for stragglers. ``budget`` caps the ladder size:
    every bucket is one more forward shape (and, on the card, one more set
    of kernel launch geometries) per (labels, rows) combination.

    Deployment recipe: tokenize a traffic sample (``PromptTokenizer
    .encode_batch(...).lengths``), pass the lengths here, set
    ``RuntimeConfig(seq_buckets=...)``. Streaming serving should stay on a
    coarse ladder instead: fine ladders fragment micro-batches.
    """
    L = np.asarray(lengths)
    if L.size == 0:
        raise ValueError("lengths is empty")
    if not (L > 0).any():
        raise ValueError("lengths must contain positive values")
    L = np.minimum(L, max_length)
    g = max(8, int(granularity))

    def up(x: float) -> int:
        return int(-(-int(x) // g) * g)

    # Every bucket is at most max_length (the JAX rule's lo is not capped:
    # all lengths 100 at max_length 100, granularity 16, gave (100, 112)).
    lo = min(max_length, max(g, up(np.quantile(L, 0.05))))
    # hi >= lo guarantees the coarse-tail loop below always advances
    # (up(t * 1.5) > t for any t >= g; lo < g only when lo == max_length,
    # where the loop does not run) even for degenerate distributions
    hi = max(lo, min(max_length, up(np.quantile(L, 0.95))))
    fine = list(range(lo, hi + 1, g))
    # coarse tail: double-ish steps covering the p95..max_length stragglers
    tail = []
    t = hi
    while t < max_length:
        t = min(max_length, up(t * 1.5))
        tail.append(t)
    ladder = sorted(set(fine + tail + [max_length]))
    # trim to budget: drop the fine buckets with the FEWEST samples first
    # (each removal merges its texts into the next bucket up — least padding
    # added where the fewest texts live)
    while len(ladder) > max(2, budget):
        counts = []
        prev = 0
        for b in ladder:
            counts.append(((L > prev) & (L <= b)).sum())
            prev = b
        # never drop the last bucket (the max_length cap)
        drop = int(np.argmin(counts[:-1]))
        ladder.pop(drop)
    return tuple(ladder)


@dataclass(frozen=True)
class BackboneConfig:
    """Hyperparameters for the encoder backbone.

    ``model_type`` selects the architecture family:
      - "deberta-v2": DeBERTa-v2/v3 disentangled-attention encoders
        (knowledgator/gliclass-{small,base,large}-v1.0 backbones)
      - "llama": Llama-style decoder backbone (gliclass-llama-1.3B-v1.0)
      - "qwen2": Qwen2-style decoder backbone (gliclass-qwen-1.5B-v1.0)

    The reference engine cannot run the decoder-backbone models through its
    launcher at all (reference Readme.md:91-95); supporting them natively here is
    a capability addition.
    """

    model_type: str = "deberta-v2"
    vocab_size: int = 128100
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-7
    pad_token_id: int = 0

    # --- deberta-v2 specific ---
    relative_attention: bool = True
    position_buckets: int = 256
    max_relative_positions: int = -1
    pos_att_type: tuple[str, ...] = ("p2c", "c2p")
    share_att_key: bool = True
    norm_rel_ebd: str = "layer_norm"
    position_biased_input: bool = False
    conv_kernel_size: int = 0
    conv_act: str = "tanh"

    # --- llama/qwen2 specific ---
    num_key_value_heads: int = 0  # 0 => = num_attention_heads
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-6
    attention_bias: bool = False  # qwen2 uses bias on qkv
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_attention_heads


@dataclass(frozen=True)
class GLiClassConfig:
    """GLiClass model-bundle config.

    Field names follow the HF ``gliclass`` package config so that converted
    checkpoints round-trip; the exported subset mirrors what the reference ONNX
    exporter records (reference ONNX_CONVERTING/convert_to_onnx.py:19-28:
    original_model_name, architecture_type, prompt_first, original_logits).
    """

    original_model_name: str = "unknown"
    architecture_type: str = "uni-encoder"
    prompt_first: bool = True
    # Head hyperparameters (from the HF gliclass package config).
    hidden_size: int = 768  # projector width; equals backbone hidden size
    projector_hidden_act: str = "gelu"
    pooling_strategy: str = "first"  # first | mean | max | sum
    scorer_type: str = "simple"  # simple | mlp | weighted-dot
    normalize_features: bool = False
    extract_text_features: bool = False
    squeeze_layers: bool = False
    use_lstm: bool = False
    # CLIP-style init of a LEARNED ``logit_scale`` parameter (the published
    # default 2.6592 == ln(1/0.07), exactly CLIP's). This field only seeds the
    # torch reference's parameter; whether converted logits are actually
    # scaled by exp(logit_scale) is decided by EVIDENCE at conversion time —
    # the trained tensor's presence in the checkpoint state dict (a checkpoint
    # from an upstream that instantiates the parameter always contains it;
    # one that doesn't, never does). See convert/convert.py
    # load_checkpoint_state_dict and PARITY.md "logit_scale".
    logit_scale_init_value: float | None = None
    class_token_index: int = -1  # token id of <<LABEL>> (set by converter)
    text_token_index: int = -1  # token id of <<SEP>>  (set by converter)
    max_num_classes: int = 25
    backbone: BackboneConfig = field(default_factory=BackboneConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "GLiClassConfig":
        d = dict(d)
        # Published HF gliclass checkpoints (knowledgator/gliclass-*) ship a
        # composite config: model_type "GLiClass" with the full transformers
        # encoder config nested under "encoder_config" (the schema the
        # reference exporter consumes via GLiClassModel.from_pretrained,
        # reference ONNX_CONVERTING/convert_to_onnx.py:48-52). Detect that
        # schema and translate it; our own bundle configs use "backbone".
        if "backbone" not in d and (
            "encoder_config" in d or d.get("model_type") == "GLiClass"
        ):
            return _gliclass_config_from_hf_dict(d)
        bb = d.pop("backbone", {})
        if isinstance(bb, dict):
            bb = dict(bb)
            if "pos_att_type" in bb and isinstance(bb["pos_att_type"], list):
                bb["pos_att_type"] = tuple(bb["pos_att_type"])
            known = {f.name for f in dataclasses.fields(BackboneConfig)}
            bb = BackboneConfig(**{k: v for k, v in bb.items() if k in known})
        known = {f.name for f in dataclasses.fields(GLiClassConfig)}
        d = {k: v for k, v in d.items() if k in known}
        return GLiClassConfig(backbone=bb, **d)

    @staticmethod
    def from_json(s: str) -> "GLiClassConfig":
        return GLiClassConfig.from_dict(json.loads(s))


# Audit of the published HF gliclass config surface. Every field of a real
# checkpoint's config.json must be accounted for: either MAPPED into
# GLiClassConfig (it shapes the forward pass) or listed TRAINING_ONLY
# (loss hyperparameters / serialization metadata with no effect on inference).
# Anything else errors instead of silently vanishing — the reference gets this
# guarantee for free by importing the real package
# (reference ONNX_CONVERTING/convert_to_onnx.py:48-62); this repo must earn it.
_HF_MAPPED_FIELDS = frozenset({
    "architecture_type", "encoder_config", "prompt_first", "hidden_size",
    "projector_hidden_act", "pooling_strategy", "scorer_type",
    "normalize_features", "extract_text_features", "squeeze_layers",
    "use_lstm", "class_token_index", "text_token_index", "max_num_classes",
    "original_model_name", "_name_or_path", "encoder_model_name",
    "logit_scale_init_value",
})
_HF_TRAINING_ONLY_FIELDS = frozenset({
    "architectures", "model_type", "contrastive_loss_coef",
    "focal_loss_alpha", "focal_loss_gamma", "ignore_index",
    "initializer_range", "problem_type", "torch_dtype",
    "transformers_version", "vocab_size",
})


def _gliclass_config_from_hf_dict(d: dict[str, Any]) -> GLiClassConfig:
    """Published HF gliclass ``config.json`` dict -> GLiClassConfig.

    Field names follow the gliclass package's GLiClassModelConfig
    (architecture_type / prompt_first / pooling_strategy / scorer_type /
    class_token_index / text_token_index / encoder_config / ...). Every field
    must be mapped or known training-only (see :data:`_HF_MAPPED_FIELDS` /
    :data:`_HF_TRAINING_ONLY_FIELDS`); an unrecognized field raises instead of
    being dropped, so a semantic knob this engine does not implement can never
    silently produce wrong probabilities. Set GLICLASS_ALLOW_UNKNOWN_CONFIG=1
    to downgrade the error to a stderr warning (at your own risk). Mirrors the
    reference exporter's uni-encoder gate
    (reference ONNX_CONVERTING/convert_to_onnx.py:48-52)."""
    unknown = sorted(set(d) - _HF_MAPPED_FIELDS - _HF_TRAINING_ONLY_FIELDS)
    if unknown:
        import os
        import sys

        msg = (
            f"HF gliclass config has unrecognized field(s) {unknown}: each "
            "could change the forward pass in a way this engine does not "
            "implement. Map it (config.py _HF_MAPPED_FIELDS) or, if it is "
            "training-only, add it to _HF_TRAINING_ONLY_FIELDS. Set "
            "GLICLASS_ALLOW_UNKNOWN_CONFIG=1 to proceed anyway."
        )
        if os.environ.get("GLICLASS_ALLOW_UNKNOWN_CONFIG") == "1":
            print(f"warning: {msg}", file=sys.stderr)
        else:
            raise ValueError(msg)
    arch = d.get("architecture_type", "uni-encoder")
    if arch != "uni-encoder":
        raise ValueError(
            f"unsupported architecture_type: {arch!r} — only 'uni-encoder' "
            "checkpoints are supported (same gate as the reference exporter, "
            "reference ONNX_CONVERTING/convert_to_onnx.py:48-52)"
        )
    enc = d.get("encoder_config")
    if not isinstance(enc, dict):
        name = d.get("encoder_model_name")
        raise ValueError(
            "HF gliclass config has no embedded 'encoder_config' dict"
            + (f" (encoder_model_name={name!r})" if name else "")
            + "; re-save the checkpoint config with the encoder config "
            "embedded, or provide a native bundle config with 'backbone'"
        )
    backbone = backbone_config_from_hf_dict(enc)
    return GLiClassConfig(
        original_model_name=str(
            d.get("original_model_name") or d.get("_name_or_path") or "unknown"
        ),
        architecture_type="uni-encoder",
        # gliclass-package default is prompt_first=False (unlike our bundle
        # default True, which follows the reference CLI's sample usage).
        prompt_first=bool(d.get("prompt_first", False)),
        hidden_size=int(d.get("hidden_size") or backbone.hidden_size),
        projector_hidden_act=d.get("projector_hidden_act") or "gelu",
        pooling_strategy=d.get("pooling_strategy") or "first",
        scorer_type=d.get("scorer_type") or "simple",
        normalize_features=bool(d.get("normalize_features", False)),
        extract_text_features=bool(d.get("extract_text_features", False)),
        squeeze_layers=bool(d.get("squeeze_layers", False)),
        use_lstm=bool(d.get("use_lstm", False)),
        logit_scale_init_value=(
            float(d["logit_scale_init_value"])
            if d.get("logit_scale_init_value") is not None
            else None
        ),
        class_token_index=int(d.get("class_token_index", -1)),
        text_token_index=int(d.get("text_token_index", -1)),
        max_num_classes=int(d.get("max_num_classes", 25)),
        backbone=backbone,
    )


# Ready-made backbone configs for the published GLiClass family
# (hyperparameters of the public backbones).
def deberta_v3_config(size: str) -> BackboneConfig:
    sizes = {
        # microsoft/deberta-v3-{small,base,large} geometry
        "small": dict(hidden_size=768, num_hidden_layers=6, num_attention_heads=12, intermediate_size=3072),
        "base": dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12, intermediate_size=3072),
        "large": dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096),
    }
    return BackboneConfig(model_type="deberta-v2", **sizes[size])


def qwen2_config(size: str = "1.5b") -> BackboneConfig:
    """Qwen2 decoder geometry (the gliclass-qwen-1.5B-v1.0 backbone)."""
    sizes = {
        # Qwen/Qwen2-1.5B geometry
        "1.5b": dict(
            hidden_size=1536, num_hidden_layers=28, num_attention_heads=12,
            num_key_value_heads=2, intermediate_size=8960, vocab_size=151936,
            max_position_embeddings=32768, rope_theta=1_000_000.0,
            hidden_act="silu", rms_norm_eps=1e-6,
        ),
    }
    return BackboneConfig(model_type="qwen2", relative_attention=False, **sizes[size])


def llama_config(size: str = "1.3b") -> BackboneConfig:
    """Llama decoder geometry (the gliclass-llama-1.3B-v1.0 backbone,
    Sheared-LLaMA-1.3B)."""
    sizes = {
        # princeton-nlp/Sheared-LLaMA-1.3B geometry
        "1.3b": dict(
            hidden_size=2048, num_hidden_layers=24, num_attention_heads=16,
            num_key_value_heads=16, intermediate_size=5504, vocab_size=32000,
            max_position_embeddings=4096, rope_theta=10000.0,
            hidden_act="silu", rms_norm_eps=1e-5,
        ),
    }
    return BackboneConfig(model_type="llama", relative_attention=False, **sizes[size])


# HF encoder config -> BackboneConfig (attribute-based, no transformers import).
def llama_config_from_hf(hf_cfg, model_type: str) -> BackboneConfig:
    """transformers LlamaConfig / Qwen2Config -> BackboneConfig."""
    heads = getattr(hf_cfg, "num_attention_heads", 32)
    return BackboneConfig(
        model_type=model_type,
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=heads,
        num_key_value_heads=getattr(hf_cfg, "num_key_value_heads", 0) or heads,
        intermediate_size=hf_cfg.intermediate_size,
        max_position_embeddings=getattr(hf_cfg, "max_position_embeddings", 2048),
        rope_theta=getattr(hf_cfg, "rope_theta", 10000.0),
        rms_norm_eps=getattr(hf_cfg, "rms_norm_eps", 1e-6),
        attention_bias=bool(getattr(hf_cfg, "attention_bias", False))
        or model_type == "qwen2",
        pad_token_id=getattr(hf_cfg, "pad_token_id", 0) or 0,
        tie_word_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
    )


def backbone_config_from_hf(hf_cfg) -> BackboneConfig:
    """transformers DebertaV2Config -> BackboneConfig.

    Every optional field falls back to the transformers DebertaV2Config
    default, so this also accepts partially-specified configs (e.g. a nested
    ``encoder_config`` dict wrapped in a namespace)."""
    pos_att = getattr(hf_cfg, "pos_att_type", None) or ()
    if isinstance(pos_att, str):
        # transformers accepts the "p2c|c2p" string form too.
        pos_att = [p.strip() for p in pos_att.split("|") if p.strip()]
    return BackboneConfig(
        model_type="deberta-v2",
        vocab_size=hf_cfg.vocab_size,
        hidden_size=hf_cfg.hidden_size,
        num_hidden_layers=hf_cfg.num_hidden_layers,
        num_attention_heads=hf_cfg.num_attention_heads,
        intermediate_size=hf_cfg.intermediate_size,
        hidden_act=getattr(hf_cfg, "hidden_act", "gelu"),
        max_position_embeddings=getattr(hf_cfg, "max_position_embeddings", 512),
        layer_norm_eps=getattr(hf_cfg, "layer_norm_eps", 1e-7),
        pad_token_id=getattr(hf_cfg, "pad_token_id", 0) or 0,
        relative_attention=getattr(hf_cfg, "relative_attention", False),
        position_buckets=getattr(hf_cfg, "position_buckets", -1),
        max_relative_positions=getattr(hf_cfg, "max_relative_positions", -1),
        pos_att_type=tuple(pos_att),
        share_att_key=getattr(hf_cfg, "share_att_key", False),
        norm_rel_ebd=getattr(hf_cfg, "norm_rel_ebd", "none"),
        position_biased_input=getattr(hf_cfg, "position_biased_input", True),
        conv_kernel_size=getattr(hf_cfg, "conv_kernel_size", 0) or 0,
        conv_act=getattr(hf_cfg, "conv_act", "tanh") or "tanh",
    )


def backbone_config_from_hf_dict(enc: Mapping[str, Any]) -> BackboneConfig:
    """Nested ``encoder_config`` dict (as serialized inside a published HF
    gliclass ``config.json``) -> BackboneConfig.

    The real checkpoints embed the full transformers config of the encoder
    under ``encoder_config`` with a ``model_type`` discriminator (the composite
    config the reference's exporter loads via ``GLiClassModel.from_pretrained``,
    reference ONNX_CONVERTING/convert_to_onnx.py:48-52). Dispatch on
    ``model_type`` and reuse the attribute-based converters via a namespace
    wrapper — no transformers import needed."""
    from types import SimpleNamespace

    model_type = enc.get("model_type", "deberta-v2")
    ns = SimpleNamespace(**{k: v for k, v in enc.items() if v is not None})
    if model_type == "deberta-v2":
        return backbone_config_from_hf(ns)
    if model_type in ("llama", "qwen2"):
        return llama_config_from_hf(ns, model_type)
    raise ValueError(
        f"unsupported encoder_config model_type: {model_type!r} "
        "(supported: deberta-v2, llama, qwen2)"
    )
