"""Real-scale artifacts: a bundle shaped like a fetched-and-converted
``knowledgator/gliclass-base-v1.0`` checkpoint, built by the port alone.

The port's counterpart of ``gliclass.c_tpu.utils.realscale``: the same
variants, geometry, tokenizer training and cache layout, built without
``jax``, ``tokenizers`` or ``transformers``. A bundle holds

* a byte-level BPE tokenizer trained over the machine's own Python and doc
  sources (no download): 128,100 pieces for the DeBERTa-v3 family, as the
  real checkpoint's vocabulary has, so the merge table, the host-side
  tokenize cost and the segmentation (about one token a word) are those of
  the real artifact. :mod:`..tokenizer.trainers` trains it; its
  ``tokenizer.json`` is byte-equal to the one ``tokenizers``' trainer makes
  from the same files;
* the model at full geometry with random weights (186 M parameters for
  ``base``; 128,100 x 768 embeddings), its INT8 weights, and golden logits,
  written as a bundle that ``pipeline.from_bundle`` and the CLI load like a
  converted checkpoint.

How it differs from the JAX package's artifact:

* the weights come from ``models.gliclass.init_gliclass_params`` with
  ``torch.Generator().manual_seed(0)`` on the CPU (the JAX module draws them
  from the ``transformers`` reference model), so a bundle is the same
  wherever it is built, and is not the JAX package's;
* the goldens are the port's own logits on the CPU
  (``convert.convert.forward_golden_logits``), in the converter's record
  schema: fp32 for DeBERTa, fp64 for the decoders (qwen, llama), whose
  logits reach |logit| 38, where an fp32 forward on the CPU moves with the
  host; the JAX package reads such a bundle and reproduces them;
* the cache is ``<root>/torch/`` under the same root
  (``GLICLASS_REALSCALE_DIR``, default ``~/.cache/gliclass_realscale``),
  so neither package ever takes the other's bundle for its own; the
  tokenizer paths under it are the JAX module's;
* the build is host work and touches no device; the bundle it returns runs
  on the card by default (``pipeline.from_bundle``, the CLI).

Build one: ``python -c "from gliclass.c_tpu_torch.utils.realscale import
ensure_realscale_bundle; print(ensure_realscale_bundle())"`` (or
``scripts/realscale_build.py --variant base``).
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import sys
import time

REALSCALE_VOCAB = 128100  # vocab_size of microsoft/deberta-v3-base (and the
# gliclass-{small,base,large}-v1.0 checkpoints built on it)
QWEN_VOCAB = 151936  # vocab_size of Qwen/Qwen2-1.5B (gliclass-qwen-1.5B)
LLAMA_VOCAB = 32000  # vocab_size of Sheared-LLaMA-1.3B (gliclass-llama-1.3B)

_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "<<LABEL>>", "<<SEP>>"]

VARIANTS = ("base", "small", "large", "qwen", "llama")

_NAME = "(geometry; offline random init — no hub access in this environment)"

# The goldens' samples: the reference exporter's canonical one and two more.
GOLDEN_SAMPLES = [
    (["ONNX is an open-source format designed to enable the interoperability of AI models across various "
      "frameworks and tools."], [["format", "model", "tool", "cat"]], True),
    (["the quick brown fox jumps over the lazy dog", "open source ai frameworks run fast on accelerators"],
     [["animal", "science", "sports"]], True),
]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _corpus_files(max_bytes: int) -> list[str]:
    """Local text corpus: Python/doc sources from the standard library's and
    numpy's install roots, files of 256 bytes or more, until ``max_bytes``.
    Deterministic order."""
    roots = [os.path.dirname(os.path.dirname(os.__file__))]
    try:
        import numpy

        roots.append(os.path.dirname(os.path.dirname(numpy.__file__)))
    except Exception:
        pass
    files: list[str] = []
    total = 0
    for root in roots:
        for ext in ("py", "txt", "md", "rst"):
            for f in sorted(glob.glob(f"{root}/**/*.{ext}", recursive=True)):
                try:
                    sz = os.path.getsize(f)
                except OSError:
                    continue
                if sz < 256:
                    continue
                files.append(f)
                total += sz
                if total >= max_bytes:
                    return files
    return files


def build_realscale_tokenizer(path: str, vocab_size: int = REALSCALE_VOCAB, max_mb: int = 96) -> dict:
    """Train and save a byte-level BPE ``tokenizer.json`` with ``vocab_size``
    pieces over :func:`_corpus_files` of ``max_mb`` MiB. Returns what the
    build did: files, bytes, distinct words, pieces, the sha256 of the file
    and the seconds of each stage (listing, counting, merging, writing)."""
    from ..tokenizer import trainers

    t0 = time.perf_counter()
    files = _corpus_files(max_mb * 1024 * 1024)
    t_list = time.perf_counter()
    n_bytes = 0

    def texts():
        nonlocal n_bytes
        for f in files:
            try:
                with open(f, encoding="utf-8", errors="ignore") as fh:
                    text = fh.read()
            except OSError:
                continue
            n_bytes += len(text.encode())
            yield text

    trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=_SPECIALS,
                                  initial_alphabet=trainers.byte_level_alphabet(), show_progress=False)
    tok = trainers.train_from_iterator(texts(), trainer, unk_token="[UNK]")
    t_train = time.perf_counter()
    tok = trainers.cls_sep_template(tok)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tok.save(path)
    with open(path, "rb") as f:
        sha = hashlib.sha256(f.read()).hexdigest()
    rep = trainer.report
    return {"files": len(files), "bytes": n_bytes, "distinct_words": rep["distinct_words"],
            "pieces": tok.get_vocab_size(), "sha256": sha, "list_s": t_list - t0, "count_s": rep["count_s"],
            "merge_s": rep["merge_s"], "write_s": time.perf_counter() - t_train}


def variant_spec(variant: str):
    """``variant`` -> (vocabulary size, tokenizer path relative to the
    cache root, backbone config, ``original_model_name``, head width)."""
    from ..config import deberta_v3_config, llama_config, qwen2_config

    if variant not in VARIANTS:
        raise ValueError(f"unknown real-scale variant {variant!r}; one of {VARIANTS}")
    if variant == "qwen":
        bb = qwen2_config("1.5b")
        return QWEN_VOCAB, os.path.join("qwen", "tokenizer.json"), bb, \
            f"knowledgator/gliclass-qwen-1.5B-v1.0 {_NAME}", bb.hidden_size
    if variant == "llama":
        bb = llama_config("1.3b")
        return LLAMA_VOCAB, os.path.join("llama", "tokenizer.json"), bb, \
            f"knowledgator/gliclass-llama-1.3B-v1.0 {_NAME}", bb.hidden_size
    # gliclass-{small,large}-v1.0 share the DeBERTa-v3 128,100-piece
    # vocabulary: they reuse the base artifact's tokenizer (one build).
    bb = deberta_v3_config(variant)
    return REALSCALE_VOCAB, "tokenizer.json", bb, f"knowledgator/gliclass-{variant}-v1.0 {_NAME}", bb.hidden_size


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.numpy()


def write_bundle(path: str, cfg, tokenizer) -> dict:
    """The bundle of ``cfg`` at ``path``: weights from
    ``init_gliclass_params`` (``torch.Generator().manual_seed(0)``, CPU),
    INT8 weights by ``quantize_tree``, the port's CPU goldens of
    ``GOLDEN_SAMPLES`` (fp64 for a decoder), ``tokenizer``'s ``to_str()``
    as tokenizer.json.
    Returns the seconds of each stage and the bundle's bytes."""
    import torch

    from ..convert.bundle import save_bundle
    from ..convert.convert import forward_golden_logits
    from ..models.gliclass import init_gliclass_params
    from ..ops.quant import quantize_tree

    t0 = time.perf_counter()
    params = _to_numpy(init_gliclass_params(torch.Generator().manual_seed(0), cfg))
    t_init = time.perf_counter()
    int8 = quantize_tree(params)
    t_quant = time.perf_counter()
    # A decoder's logits reach |logit| 38 here: its goldens in fp64, the
    # same on every host (forward_golden_logits).
    dtype = "float32" if cfg.backbone.model_type == "deberta-v2" else "float64"
    goldens = [forward_golden_logits(cfg, params, tokenizer, texts, labels, same, dtype=dtype)
               for texts, labels, same in GOLDEN_SAMPLES]
    t_gold = time.perf_counter()
    save_bundle(path, cfg, params, tokenizer_json=tokenizer._tok.to_str(), goldens=goldens, int8_params=int8)
    t_write = time.perf_counter()
    size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    return {"init_s": t_init - t0, "quantize_s": t_quant - t_init, "goldens_s": t_gold - t_quant,
            "write_s": t_write - t_gold, "bytes": size}


def realscale_root(root: str | None = None) -> str:
    """The port's cache directory: ``<root>/torch``."""
    root = root or os.environ.get("GLICLASS_REALSCALE_DIR",
                                  os.path.join(os.path.expanduser("~"), ".cache", "gliclass_realscale"))
    return os.path.join(root, "torch")


def ensure_realscale_bundle(root: str | None = None, log=None, variant: str = "base") -> str:
    """Build (once) and return the path of the real-scale bundle.

    ``variant``: "base", "small", "large" = knowledgator/gliclass-{base,
    small,large}-v1.0 geometry (DeBERTa-v3 backbones, one shared
    128,100-piece tokenizer trained over 96 MiB); "qwen" =
    gliclass-qwen-1.5B-v1.0 geometry (Qwen2-1.5B, a 151,936-piece
    tokenizer over 160 MiB); "llama" = gliclass-llama-1.3B-v1.0 geometry
    (Sheared-LLaMA-1.3B, 32,000 pieces over 160 MiB).

    Cached under :func:`realscale_root` (``<root>/torch``); a bundle with
    its ``.complete`` marker is returned at once."""
    log = log or _log
    base = realscale_root(root)
    vocab, tok_rel, backbone, name, hidden = variant_spec(variant)
    sub = "" if variant == "base" else variant
    bundle = os.path.join(base, sub, "bundle")
    done = os.path.join(bundle, ".complete")
    if os.path.exists(done):
        return bundle

    from ..config import GLiClassConfig
    from ..tokenization import PromptTokenizer

    tok_path = os.path.join(base, tok_rel)
    if not os.path.exists(tok_path):
        log(f"[realscale] training {vocab}-piece BPE tokenizer (one-time, a few minutes)...")
        # small/large reuse the base tokenizer, so its corpus size must not
        # depend on which variant builds it first.
        rep = build_realscale_tokenizer(tok_path, vocab_size=vocab,
                                        max_mb=96 if variant in ("base", "small", "large") else 160)
        log(f"[realscale] tokenizer: {json.dumps(rep)}")
    log(f"[realscale] building the {variant} bundle (random init, INT8, goldens)...")
    ptok = PromptTokenizer.from_file(tok_path)
    cfg = GLiClassConfig(original_model_name=name, hidden_size=hidden, prompt_first=True,
                         class_token_index=ptok.label_token_id, text_token_index=ptok.sep_token_id,
                         backbone=backbone)
    if cfg.backbone.vocab_size != vocab:
        raise ValueError(f"{variant}: backbone vocab_size {cfg.backbone.vocab_size} != {vocab}")
    rep = write_bundle(bundle, cfg, ptok)
    log(f"[realscale] bundle: {json.dumps(rep)}")
    with open(done, "w") as f:
        f.write("ok")
    log(f"[realscale] bundle ready at {bundle}")
    return bundle
