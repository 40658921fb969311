"""Training input pipeline: records -> shuffled, bucketed, fixed-shape batches.

A copy of ``gliclass.c_tpu.training.data`` (numpy only) over the port's own
``prompting`` and ``tokenization``. The records are the upstream gliclass
package's training schema

    {"text": ..., "all_labels": [l1, l2, ...], "true_labels": [l1, ...]}

Every candidate label goes into the packed prompt (the prompt the serving
path builds) and the target is 1 for the true subset. Host work (pack +
tokenize) is the serving code; batches are bucketed by sequence length so the
set of shapes stays small; the arrays are fixed-shape: ids/mask
[B, S_bucket] int32, targets/target_mask [B, max_labels], ready for
``train.make_train_step`` (including its ``accum_steps`` micro-batch split).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from ..prompting import pack_prompt
from ..tokenization import PromptTokenizer


@dataclass
class TrainExample:
    text: str
    all_labels: list[str]
    true_labels: list[str]


def parse_train_records(records: Sequence[dict]) -> list[TrainExample]:
    """Schema-checked ingestion (the fail-loud policy of data.parse_job)."""
    out: list[TrainExample] = []
    for i, r in enumerate(records):
        if not isinstance(r.get("text"), str):
            raise ValueError(f"record {i}: 'text' must be a string")
        alls = r.get("all_labels")
        trues = r.get("true_labels", [])
        if not isinstance(alls, list) or not alls:
            raise ValueError(f"record {i}: 'all_labels' must be a non-empty list")
        if not isinstance(trues, list):
            raise ValueError(f"record {i}: 'true_labels' must be a list")
        unknown = set(trues) - set(alls)
        if unknown:
            raise ValueError(
                f"record {i}: true_labels not in all_labels: {sorted(unknown)}"
            )
        out.append(TrainExample(r["text"], list(alls), list(trues)))
    return out


@dataclass
class TrainBatch:
    input_ids: np.ndarray  # int32 [B, S_bucket]
    attention_mask: np.ndarray  # int32 [B, S_bucket]
    targets: np.ndarray  # float32 [B, max_labels]
    target_mask: np.ndarray  # bool [B, max_labels]


def train_batches(
    examples: Sequence[TrainExample],
    tokenizer: PromptTokenizer,
    batch_size: int,
    max_labels: int,
    max_length: int = 512,
    seq_buckets: Sequence[int] = (64, 128, 256, 512),
    prompt_first: bool = True,
    shuffle_rng: np.random.Generator | None = None,
    drop_remainder: bool = False,
    encode_chunk: int = 1024,
) -> Iterator[TrainBatch]:
    """One epoch of bucketed fixed-shape train batches.

    Examples with more than ``max_labels`` candidate labels are rejected
    (the label slots are a fixed shape); a tail batch
    smaller than ``batch_size`` is emitted unless ``drop_remainder`` (set it
    when accum_steps needs exact divisibility).
    """
    for i, ex in enumerate(examples):
        if len(ex.all_labels) > max_labels:
            raise ValueError(
                f"example {i}: {len(ex.all_labels)} labels > max_labels "
                f"{max_labels}"
            )
    order = np.arange(len(examples))
    if shuffle_rng is not None:
        shuffle_rng.shuffle(order)

    buckets = sorted(seq_buckets)
    if not buckets:
        raise ValueError("seq_buckets must be non-empty")

    def bucket_for(L: int) -> int:
        for b in buckets:
            if L <= b:
                return b
        return buckets[-1]

    pending: dict[int, list[tuple[int, np.ndarray, int]]] = {}

    def emit(b: int) -> TrainBatch:
        rows = pending.pop(b)
        n = len(rows)
        ids = np.full((n, b), tokenizer.pad_token_id, dtype=np.int32)
        mask = np.zeros((n, b), dtype=np.int32)
        targets = np.zeros((n, max_labels), dtype=np.float32)
        tmask = np.zeros((n, max_labels), dtype=bool)
        for row, (gi, enc_row, L) in enumerate(rows):
            ids[row, :L] = enc_row[:L]
            mask[row, :L] = 1
            ex = examples[gi]
            nl = len(ex.all_labels)
            tmask[row, :nl] = True
            true = set(ex.true_labels)
            for j, lab in enumerate(ex.all_labels):
                if lab in true:
                    targets[row, j] = 1.0
        return TrainBatch(ids, mask, targets, tmask)

    # Chunked encode: one encode_batch per chunk, batches streamed out as
    # buckets fill.
    for c0 in range(0, len(order), encode_chunk):
        idxs = order[c0 : c0 + encode_chunk]
        prompts = [
            pack_prompt(examples[g].text, examples[g].all_labels, prompt_first)
            for g in idxs
        ]
        enc = tokenizer.encode_batch(prompts, max_length=max_length, pad_to=None)
        for j, gi in enumerate(idxs):
            L = int(enc.lengths[j])
            b = bucket_for(L)
            pending.setdefault(b, []).append(
                (int(gi), enc.input_ids[j], min(L, b))
            )
            if len(pending[b]) == batch_size:
                yield emit(b)
    for b in sorted(pending):
        if drop_remainder and len(pending[b]) < batch_size:
            pending.pop(b)
            continue
        yield emit(b)
