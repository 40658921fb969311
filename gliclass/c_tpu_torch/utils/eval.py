"""Evaluation metrics and the accuracy gates of ``cli selftest``.

The golden-logit check replays a bundle's recorded samples (fp32 torch
reference logits) through the port and compares logits (the JAX package
compares inverted probabilities); the INT8 gate compares micro-F1 of the
INT8 and fp32 paths over a deterministic synthetic eval set (BASELINE.md:
delta <= 0.5%). Otherwise the functions and results of
``gliclass.c_tpu.utils.eval``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class F1Result:
    micro_f1: float
    macro_f1: float
    precision: float
    recall: float
    tp: int
    fp: int
    fn: int


def multilabel_f1(
    predictions: Sequence[Sequence[int | str]],
    references: Sequence[Sequence[int | str]],
) -> F1Result:
    """Micro/macro F1 over per-text label sets (ids or strings)."""
    if len(predictions) != len(references):
        raise ValueError("predictions and references must align")
    tp = fp = fn = 0
    per_text_f1 = []
    for p, r in zip(map(set, predictions), map(set, references)):
        tpi, fpi, fni = len(p & r), len(p - r), len(r - p)
        tp, fp, fn = tp + tpi, fp + fpi, fn + fni
        denom = 2 * tpi + fpi + fni
        per_text_f1.append(2 * tpi / denom if denom else 1.0)
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    rec = tp / (tp + fn) if (tp + fn) else 0.0
    micro = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
    macro = sum(per_text_f1) / len(per_text_f1) if per_text_f1 else 0.0
    return F1Result(micro, macro, prec, rec, tp, fp, fn)


def f1_delta(
    predictions_a: Sequence[Sequence[int | str]],
    predictions_b: Sequence[Sequence[int | str]],
    references: Sequence[Sequence[int | str]],
) -> float:
    """|micro-F1(a) - micro-F1(b)|: the INT8-vs-fp32 accuracy gate."""
    return abs(
        multilabel_f1(predictions_a, references).micro_f1
        - multilabel_f1(predictions_b, references).micro_f1
    )


def decisions_to_label_sets(results) -> list[list[str]]:
    """TextResult list -> per-text predicted label lists."""
    return [[d.label for d in r.decisions] for r in results]


# Each label has signature words; a text's reference labels are exactly the
# labels whose signature words were mixed into it: deterministic and
# self-labelling, with no network needed.
EVAL_LABELS = ("science", "sports", "news", "market")
_SIGNATURES = {
    "science": ["science", "model", "format", "research"],
    "sports": ["sports", "running", "game", "races"],
    "news": ["news", "politics", "question", "report"],
    "market": ["market", "business", "open", "trade"],
}
_FILLER = ["the", "quick", "brown", "fox", "dog", "travel", "health", "why"]


def synthetic_eval_set(n_texts: int = 512, seed: int = 0) -> tuple[list[str], list[str], list[list[str]]]:
    """Returns (texts, label_list, per-text reference label lists)."""
    rng = np.random.default_rng(seed)
    labels = list(EVAL_LABELS)
    texts, refs = [], []
    for _ in range(n_texts):
        k = int(rng.integers(0, 3))
        chosen = list(rng.choice(labels, size=k, replace=False))
        words: list[str] = []
        for c in chosen:
            words += list(rng.choice(_SIGNATURES[c], size=2))
        words += list(rng.choice(_FILLER, size=int(rng.integers(2, 6))))
        rng.shuffle(words)
        texts.append(" ".join(words))
        refs.append(chosen)
    return texts, labels, refs


def golden_logit_check(pipe, goldens, runtime) -> float:
    """Replay a bundle's golden samples through ``pipe`` and return the worst
    |logit delta| against the recorded reference logits.

    Each golden replays under the conditions it was recorded at (max_length,
    prompt_first). The logits are the engine's own, read before the sigmoid
    (``pipeline.predict_logits``), so the check holds at any magnitude: the
    JAX package inverts fp32 probabilities clipped at 1e-12, which cannot
    tell logits past about 17 (where the fp32 sigmoid reaches 1) or below
    -27.6 apart. Hard-masked label slots (logit -1e4) are excluded."""
    from ..pipeline import ZeroShotClassificationPipeline

    worst = 0.0
    for rec in goldens:
        rt = dataclasses.replace(runtime, max_length=int(rec.get("max_length", runtime.max_length)))
        rpipe = ZeroShotClassificationPipeline(
            pipe.engine, pipe.tokenizer, rt, prompt_first=rec.get("prompt_first")
        )
        got = rpipe.predict_logits(rec["texts"], rec["labels"], rec["same_labels"])
        golden = np.asarray(rec["logits"], dtype=np.float64)
        width = golden.shape[1]
        real = golden > -9.99e3
        delta = np.abs(got[:, :width].astype(np.float64) - golden)[real]
        worst = max(worst, float(delta.max()) if delta.size else 0.0)
    return worst


def int8_f1_gate(pipe_fp32, pipe_int8, n_texts: int = 512, threshold: float = 0.5, seed: int = 0) -> dict:
    """Run both pipelines over the synthetic eval set and compare micro-F1.

    Returns {"f1_fp32", "f1_int8", "delta", "positives_fp32", "cells",
    "max_prob_delta"}; the gate is delta <= 0.005. ``max_prob_delta`` shows
    that the INT8 path really quantizes (a no-op gives exactly 0)."""
    from ..postprocess import decide_batch

    texts, labels, refs = synthetic_eval_set(n_texts, seed)
    nv = [len(labels)] * len(texts)
    p32 = pipe_fp32.predict_probs(texts, [labels], True)
    p8 = pipe_int8.predict_probs(texts, [labels], True)
    d32 = decisions_to_label_sets(decide_batch(p32, texts, [labels], True, "multi-label", threshold, num_valid=nv))
    d8 = decisions_to_label_sets(decide_batch(p8, texts, [labels], True, "multi-label", threshold, num_valid=nv))
    f32 = multilabel_f1(d32, refs)
    f8 = multilabel_f1(d8, refs)
    return {
        "f1_fp32": f32.micro_f1,
        "f1_int8": f8.micro_f1,
        "delta": abs(f32.micro_f1 - f8.micro_f1),
        "positives_fp32": sum(len(d) for d in d32),
        "cells": len(texts) * len(labels),
        "max_prob_delta": float(np.abs(p32 - p8).max()),
    }
