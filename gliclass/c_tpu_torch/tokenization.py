"""Tokenization of packed prompts into fixed-shape device-ready batches.

Replaces reference src/tokenizer.c (C shim over the Rust ``tokenizers`` crate via
tokenizers-cpp). The JAX package wraps the ``tokenizers`` Python binding; the
port reads ``tokenizer.json`` itself (:mod:`.tokenizer`, plain Python), so
a bundle loads on a machine without ``tokenizers``, and every device runs
the same reader.

Contract parity (reference src/tokenizer.c:19-91):
  * batch encode with ``add_special_tokens=True`` (reference src/tokenizer.c:32-33)
  * truncate each sequence at ``max_length`` (reference src/tokenizer.c:44-49)
  * attention_mask 1 for real tokens, 0 for padding (reference src/tokenizer.c:75-82)
  * ``token_type_ids`` is NOT produced: the reference computes it but never feeds
    it to the model (reference src/tokenizer.c:66,76 vs src/model.c:168) — dropped.

Deliberate divergence (documented per SURVEY §7 step 2): the reference pads to the
longest post-truncation sequence in the batch (reference src/tokenizer.c:50-54),
which is a dynamic shape per batch — one new shape (and one new set of kernel
launch geometries) per distinct length. We pad to a fixed bucket from ``RuntimeConfig.seq_buckets`` instead.
Padded positions are fully masked so logits are unchanged.

Pad token id: the reference hardcodes 0 (reference src/tokenizer.c:79); we read it
from the tokenizer when available and fall back to 0.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from .prompting import LABEL_TAG, SEP_TAG
from .tokenizer import Tokenizer
from .utils import metrics

# Below this many rows the python fill loop wins (the flat-list build
# dominates the native call); above it the threaded native fill takes over.
# Chunked tokenization
# (encode_batch_parallel) stays below this, so the native fill engages only
# for large direct encode_batch calls (eval/golden runs).
_NATIVE_PAD_MIN_ROWS = 4096


@dataclass(frozen=True)
class TokenizedBatch:
    """Fixed-shape batch ready for device transfer."""

    input_ids: np.ndarray  # int32 [B, L]
    attention_mask: np.ndarray  # int32 [B, L]
    lengths: np.ndarray  # int32 [B] true (post-truncation) lengths

    @property
    def batch_size(self) -> int:
        return self.input_ids.shape[0]

    @property
    def seq_length(self) -> int:
        return self.input_ids.shape[1]


class PromptTokenizer:
    """Wrapper over a tokenizer with the ``tokenizers.Tokenizer`` surface:
    the port's :class:`.tokenizer.Tokenizer` from :meth:`from_file`, or any
    object with ``encode``/``encode_batch`` (``.ids``), ``token_to_id`` and
    ``padding`` (the tests hand it ``tokenizers.Tokenizer`` objects)."""

    def __init__(self, tokenizer, pad_token_id: int | None = None):
        self._tok = tokenizer
        if pad_token_id is None:
            pad = getattr(tokenizer, "padding", None)
            pad_token_id = pad["pad_id"] if pad else 0
        self.pad_token_id = int(pad_token_id)
        # Special-token ids used by the GLiClass head to locate label slots.
        self.label_token_id = tokenizer.token_to_id(LABEL_TAG)
        self.sep_token_id = tokenizer.token_to_id(SEP_TAG)

    @classmethod
    def from_file(cls, path: str, pad_token_id: int | None = None) -> "PromptTokenizer":
        """The port's reader of ``tokenizer.json``, on every device."""
        return cls(Tokenizer.from_file(path), pad_token_id=pad_token_id)

    def encode_batch(
        self,
        prompts: Sequence[str],
        max_length: int,
        pad_to: int | None = None,
    ) -> TokenizedBatch:
        """Encode, truncate at ``max_length``, pad to ``pad_to`` (or batch max).

        ``pad_to=None`` reproduces the reference's pad-to-batch-max behaviour
        (reference src/tokenizer.c:44-54) for parity tests; production passes a
        bucket size for shape stability. With the recorder on, a ``tokenize``
        span with the texts and their tokens.
        """
        rec = metrics.RECORDER
        if rec is None:
            return self._encode(prompts, max_length, pad_to)
        with rec.span("tokenize", texts=len(prompts)) as sp:
            out = self._encode(prompts, max_length, pad_to)
            sp.attrs["tokens"] = int(out.lengths.sum())
        return out

    def _encode(self, prompts: Sequence[str], max_length: int, pad_to: int | None) -> TokenizedBatch:
        encs = self._tok.encode_batch(list(prompts), add_special_tokens=True)
        lengths = np.array(
            [min(len(e.ids), max_length) for e in encs], dtype=np.int32
        )
        target = int(pad_to) if pad_to is not None else int(lengths.max(initial=1))
        if lengths.max(initial=0) > target:
            raise ValueError(
                f"pad_to={target} is smaller than longest truncated sequence "
                f"({int(lengths.max())}); pick a larger bucket"
            )
        n = len(encs)
        if n >= _NATIVE_PAD_MIN_ROWS:
            # Threaded C++ fill (native/host_ops.cpp gct_pad_batch): one flat
            # int32 array + row offsets in, padded [n, target] ids/mask out.
            # Falls through to the loop when the library is not built.
            from . import native_ops

            if native_ops.available():
                flat: list[int] = []
                for i, e in enumerate(encs):
                    flat.extend(e.ids[: lengths[i]])
                offsets = np.zeros(n + 1, dtype=np.int64)
                np.cumsum(lengths, out=offsets[1:])
                out = native_ops.pad_batch_native(
                    np.asarray(flat, dtype=np.int32), offsets, target,
                    self.pad_token_id,
                )
                if out is not None:
                    return TokenizedBatch(out[0], out[1], lengths)
        input_ids = np.full((n, target), self.pad_token_id, dtype=np.int32)
        attention_mask = np.zeros((n, target), dtype=np.int32)
        for i, e in enumerate(encs):
            L = lengths[i]
            input_ids[i, :L] = e.ids[:L]
            attention_mask[i, :L] = 1
        return TokenizedBatch(input_ids, attention_mask, lengths)

    def encode_batch_parallel(
        self,
        prompts: Sequence[str],
        max_length: int,
        pad_to: int | None = None,
        chunk_size: int = 512,
        workers: int | None = None,
    ) -> TokenizedBatch:
        """Chunked parallel encode for large jobs (replaces the OpenMP fan-out of
        reference src/parallel_processor.c:25-50 on the host side).

        The pool was chosen for the Rust tokenizer core, which releases the
        GIL. The port's reader is Python and holds it, so the threads now
        take turns and gain nothing over one; the chunking and the result
        are unchanged.
        """
        if len(prompts) <= chunk_size:
            return self.encode_batch(prompts, max_length, pad_to)
        workers = workers or min(8, os.cpu_count() or 1)
        chunks = [prompts[i : i + chunk_size] for i in range(0, len(prompts), chunk_size)]
        with ThreadPoolExecutor(max_workers=workers) as ex:
            parts = list(
                ex.map(lambda c: self.encode_batch(c, max_length, pad_to), chunks)
            )
        if pad_to is None:
            target = max(p.seq_length for p in parts)
            parts = [_repad(p, target, self.pad_token_id) for p in parts]
        return TokenizedBatch(
            np.concatenate([p.input_ids for p in parts]),
            np.concatenate([p.attention_mask for p in parts]),
            np.concatenate([p.lengths for p in parts]),
        )


def _repad(batch: TokenizedBatch, target: int, pad_id: int) -> TokenizedBatch:
    if batch.seq_length == target:
        return batch
    n, L = batch.input_ids.shape
    ids = np.full((n, target), pad_id, dtype=np.int32)
    mask = np.zeros((n, target), dtype=np.int32)
    ids[:, :L] = batch.input_ids
    mask[:, :L] = batch.attention_mask
    return TokenizedBatch(ids, mask, batch.lengths)


class AffixEncoder:
    """Shared-affix fast tokenizer for same-labels jobs.

    A same-labels job packs the IDENTICAL label block into every prompt
    (``<<LABEL>>l1<<LABEL>>l2<<SEP>>`` + text with prompt_first, text +
    block otherwise — reference src/preprocessor.c:23-43), and the batch
    path tokenizes that block once PER TEXT. Because ``<<LABEL>>`` /
    ``<<SEP>>`` are special tokens, the BPE pre-tokenizer splits the prompt
    at them — no merge ever crosses the affix/text boundary — so the block
    can be encoded ONCE and composed per text:

        ids = bos + prefix_ids + enc(text) + suffix_ids + eos

    (bos/eos are the tokenizer's post-processor template, recovered by
    subsequence-matching a probe encode). Composition is VERIFIED at
    construction — UNTRUNCATED, against full-string encodes of a fixed
    NON-EMPTY multi-word probe and of ``validate_text`` (the probe keeps
    the check meaningful when the sample text is empty or would truncate;
    it exercises the affix/text word boundary where position-dependent
    pre-tokenizers like ByteLevel(add_prefix_space=True) break the
    identity); any tokenizer that breaks it falls back to plain
    ``encode_batch`` permanently (``self.exact`` False) — the fast
    path can never change ids. A ``tokenizer.json`` with a ``truncation``
    block is never exact: it cuts the segments and the whole prompt at
    different points, which no short probe shows.

    Truncation matches the full path: keep the first ``max_length`` tokens
    of the composed sequence (reference src/tokenizer.c:44-49).
    """

    # Fixed validation probe: non-empty, multi-word, starts mid-alphabet —
    # exercises the affix/text word boundary and the string-start position
    # (where add_prefix_space-style pre-tokenizers diverge).
    _PROBE = "probe boundary text"

    def __init__(
        self,
        tokenizer: PromptTokenizer,
        prefix: str,
        suffix: str,
        validate_text: str,
        validate_prompt: str,
        max_length: int,
        validate_packer=None,
    ):
        """``validate_packer(text) -> full prompt string``: when given, the
        probe text is also validated (untruncated) — REQUIRED for a
        non-vacuous check when ``validate_text`` may be empty or truncating.
        Prefer :meth:`for_labels`, which wires it automatically."""
        self.tok = tokenizer
        t = tokenizer._tok
        if getattr(t, "truncation", None):
            # The file's own truncation cuts each segment encode and the
            # full-string encode at different points, so composition cannot
            # be checked on short probes: the full-string path serves all.
            self.exact = False
            self._why = "tokenizer.json sets truncation"
            return
        # Recover the post-processor template: probe a plain word.
        probe = "a"
        core = t.encode(probe, add_special_tokens=False).ids
        full = t.encode(probe, add_special_tokens=True).ids
        start = _find_subseq(full, core)
        if start is None:
            self.exact = False
            self._why = "post-processor template not recoverable"
            return
        self.bos = full[:start]
        self.eos = full[start + len(core):]
        self.pre = (
            t.encode(prefix, add_special_tokens=False).ids if prefix else []
        )
        self.suf = (
            t.encode(suffix, add_special_tokens=False).ids if suffix else []
        )

        def composed_ids(text: str) -> list:
            return (
                self.bos
                + self.pre
                + t.encode(text, add_special_tokens=False).ids
                + self.suf
                + self.eos
            )

        # UNTRUNCATED comparisons: identical full sequences imply identical
        # truncations, while a truncated compare can pass vacuously (e.g.
        # both cut before the text/suffix boundary).
        checks = [(validate_text, validate_prompt)]
        if validate_packer is not None:
            checks.append((self._PROBE, validate_packer(self._PROBE)))
        self.exact = all(
            composed_ids(text)
            == t.encode(prompt, add_special_tokens=True).ids
            for text, prompt in checks
        )
        self._why = "" if self.exact else "composition != full-string encode"

    @classmethod
    def for_labels(
        cls,
        tokenizer: PromptTokenizer,
        labels: Sequence[str],
        prompt_first: bool,
        max_length: int,
        sample_text: str | None = None,
    ) -> "AffixEncoder":
        """The one construction used by both the batch pipeline and the
        streaming scheduler: affix from the packed label block, validation
        against the fixed probe AND the caller's sample text."""
        from .prompting import pack_prompt

        labels = list(labels)
        affix = pack_prompt("", labels, prompt_first)
        prefix, suffix = (affix, "") if prompt_first else ("", affix)
        sample = sample_text if sample_text else cls._PROBE
        return cls(
            tokenizer, prefix, suffix,
            validate_text=sample,
            validate_prompt=pack_prompt(sample, labels, prompt_first),
            max_length=max_length,
            validate_packer=lambda text: pack_prompt(
                text, labels, prompt_first
            ),
        )

    def encode_batch(
        self,
        texts: Sequence[str],
        max_length: int,
        pad_to: int | None = None,
        fallback_prompts: Sequence[str] | None = None,
    ) -> TokenizedBatch:
        """Composed encode; ``fallback_prompts`` (full packed prompts) are
        used when the exactness check failed at construction. With the
        recorder on, a ``tokenize`` span with the texts and their tokens."""
        if not self.exact:
            if fallback_prompts is None:
                raise ValueError(
                    f"AffixEncoder inexact ({self._why}) and no "
                    "fallback_prompts given"
                )
            return self.tok.encode_batch(fallback_prompts, max_length, pad_to)
        rec = metrics.RECORDER
        if rec is None:
            return self._compose(texts, max_length, pad_to)
        with rec.span("tokenize", texts=len(texts)) as sp:
            out = self._compose(texts, max_length, pad_to)
            sp.attrs["tokens"] = int(out.lengths.sum())
        return out

    def _compose(self, texts: Sequence[str], max_length: int, pad_to: int | None) -> TokenizedBatch:
        t = self.tok._tok
        encs = t.encode_batch(list(texts), add_special_tokens=False)
        n_fixed = len(self.bos) + len(self.pre) + len(self.suf) + len(self.eos)
        lengths = np.array(
            [min(len(e.ids) + n_fixed, max_length) for e in encs],
            dtype=np.int32,
        )
        target = int(pad_to) if pad_to is not None else int(lengths.max(initial=1))
        if lengths.max(initial=0) > target:
            raise ValueError(
                f"pad_to={target} is smaller than longest truncated sequence "
                f"({int(lengths.max())}); pick a larger bucket"
            )
        n = len(encs)
        head = np.asarray(self.bos + self.pre, dtype=np.int32)
        tail = np.asarray(self.suf + self.eos, dtype=np.int32)
        input_ids = np.full((n, target), self.tok.pad_token_id, dtype=np.int32)
        attention_mask = np.zeros((n, target), dtype=np.int32)
        for i, e in enumerate(encs):
            row = np.concatenate(
                [head, np.asarray(e.ids, dtype=np.int32), tail]
            )[: lengths[i]]
            input_ids[i, : len(row)] = row
            attention_mask[i, : len(row)] = 1
        return TokenizedBatch(input_ids, attention_mask, lengths)


def _find_subseq(hay: list, needle: list) -> int | None:
    if not needle:
        return None
    for i in range(len(hay) - len(needle) + 1):
        if hay[i : i + len(needle)] == needle:
            return i
    return None
