"""Seeded text, label and tokenizer generation: the benchmark's one traffic generator.

Everything a cell feeds the program is made here from ``--seed`` and the
parameters of a traffic file (``traffic/<name>.json``) and a configuration
file (``configs/<name>.json``):

* a lexicon of Zipf-frequency words and, from it, a SentencePiece Unigram
  ``tokenizer.json`` of the published DeBERTa-v3 tokenizer's type
  (``Metaspace`` pre-tokenizer, ``[CLS] $A [SEP]`` template, the GLiClass
  ``<<LABEL>>``/``<<SEP>>`` tags as added tokens), with whole-word pieces for
  the lexicon and sub-word and character pieces so that any word segments;
* texts whose word counts follow a stated distribution, a share of them
  words that are in no lexicon (so the tokenizer's word cache cannot hide
  its cost), and label phrases from a seeded topic pool.

Sizes are drawn by stratified quantiles: every seed gets the same multiset
of lengths, gaps and request sizes, in another order, so that two seeds
differ in content and order but not in the amount of work.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import string

import numpy as np

SPACE = "▁"  # SentencePiece's word-boundary mark
SPECIALS = ["[PAD]", "[CLS]", "[SEP]", "[UNK]"]
MASK = "[MASK]"
LABEL_TAG = "<<LABEL>>"
SEP_TAG = "<<SEP>>"

# English letter frequencies (percent), for words that look like words.
_LETTERS = np.array(list(string.ascii_lowercase))
_FREQ = np.array([8.2, 1.5, 2.8, 4.3, 12.7, 2.2, 2.0, 6.1, 7.0, 0.15, 0.77, 4.0, 2.4,
                  6.7, 7.5, 1.9, 0.095, 6.0, 6.3, 9.1, 2.8, 0.98, 2.4, 0.15, 2.0, 0.074])
_FREQ = _FREQ / _FREQ.sum()


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A numpy generator for one purpose of one seed (``tags`` name it)."""
    return np.random.default_rng([int(seed) % (1 << 63), *tags])


def _random_words(rng: np.random.Generator, n: int, lo: int, hi: int) -> list[str]:
    lengths = rng.integers(lo, hi + 1, size=n)
    chars = rng.choice(_LETTERS, size=int(lengths.sum()), p=_FREQ)
    ends = np.cumsum(lengths)
    flat = "".join(chars.tolist())
    starts = ends - lengths
    return [flat[a:b] for a, b in zip(starts.tolist(), ends.tolist())]


class Lexicon:
    """Words with Zipf frequencies, and the Unigram pieces built from them."""

    def __init__(self, seed: int, spec: dict):
        rng = rng_for(seed, 1)
        n_words = int(spec["words"])
        words: dict[str, None] = {}
        while len(words) < n_words:
            for w in _random_words(rng, n_words, spec["word_min_chars"], spec["word_max_chars"]):
                words.setdefault(w)
                if len(words) == n_words:
                    break
        self.words = list(words)
        ranks = np.arange(1, n_words + 1, dtype=np.float64)
        p = ranks ** -float(spec["zipf_s"])
        self.word_p = p / p.sum()
        self.word_cdf = np.cumsum(self.word_p)
        self.vocab_size = int(spec["vocab_size"])
        self._pieces = self._build_pieces(rng, spec)

    def _build_pieces(self, rng: np.random.Generator, spec: dict) -> list[tuple[str, float]]:
        """[(piece, score)], ids in order: the specials, the lexicon's whole
        words, sub-word pieces, then characters, [MASK] last; the GLiClass
        tags are added tokens after them."""
        n_model = self.vocab_size - 2  # the two GLiClass tags are added tokens
        pieces: dict[str, float] = {s: 0.0 for s in SPECIALS}
        # Characters, alone and word-initial: every word segments.
        chars = list(string.ascii_lowercase + string.digits + ".,;:!?'-")
        char_score = -14.0
        for c in chars:
            pieces[SPACE + c] = char_score - 0.5
            pieces[c] = char_score
        pieces[SPACE] = char_score - 1.0
        # Whole words, scored by log frequency.
        logp = np.log(self.word_p)
        for w, lp in zip(self.words, logp.tolist()):
            pieces.setdefault(SPACE + w, lp)
        # Sub-word pieces: frequent chunks of lexicon words, word-initial or
        # inside a word, scored below the whole words they come from.
        room = n_model - 1 - len(pieces)
        grams: dict[str, float] = {}
        sample = rng.choice(len(self.words), size=min(len(self.words), 4 * room), p=self.word_p)
        for i in sample.tolist():
            w = self.words[i]
            n = int(rng.integers(2, min(6, len(w)) + 1)) if len(w) >= 2 else 1
            a = int(rng.integers(0, len(w) - n + 1))
            g = (SPACE if a == 0 else "") + w[a:a + n]
            grams[g] = grams.get(g, 0.0) + 1.0
        ordered = sorted(grams.items(), key=lambda kv: (-kv[1], kv[0]))
        total = sum(c for _, c in ordered)
        for g, c in ordered:
            if len(pieces) >= n_model - 1:
                break
            if g not in pieces:
                pieces[g] = math.log(c / total) - 4.0
        k = 0
        while len(pieces) < n_model - 1:  # pad with rare chunks, never met first
            pieces.setdefault(f"{SPACE}zz{k:06d}", -20.0)
            k += 1
        pieces[MASK] = 0.0
        return list(pieces.items())

    def tokenizer_json(self) -> str:
        """The ``tokenizer.json`` text (deterministic for a seed)."""
        n_model = len(self._pieces)
        added = [
            {"id": i, "content": s, "single_word": False, "lstrip": False, "rstrip": False,
             "normalized": False, "special": True}
            for i, s in enumerate(SPECIALS)
        ]
        added.append({"id": n_model - 1, "content": MASK, "single_word": False, "lstrip": False,
                      "rstrip": False, "normalized": False, "special": True})
        for j, tag in enumerate((LABEL_TAG, SEP_TAG)):
            added.append({"id": n_model + j, "content": tag, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True})
        spec = {
            "version": "1.0",
            "truncation": None,
            "padding": None,
            "added_tokens": added,
            "normalizer": None,
            "pre_tokenizer": {"type": "Metaspace", "replacement": SPACE,
                              "prepend_scheme": "always", "split": True},
            "post_processor": {
                "type": "TemplateProcessing",
                "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                           {"Sequence": {"id": "A", "type_id": 0}},
                           {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
                "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                         {"Sequence": {"id": "A", "type_id": 0}},
                         {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                         {"Sequence": {"id": "B", "type_id": 1}},
                         {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
                "special_tokens": {s: {"id": s, "ids": [i], "tokens": [s]}
                                   for i, s in ((1, "[CLS]"), (2, "[SEP]"))},
            },
            "decoder": {"type": "Metaspace", "replacement": SPACE, "prepend_scheme": "always",
                        "split": True},
            "model": {"type": "Unigram", "unk_id": 3, "byte_fallback": False,
                      "vocab": [[p, s] for p, s in self._pieces]},
        }
        return json.dumps(spec, ensure_ascii=False)


def write_tokenizer(lex: Lexicon, path: str) -> str:
    """Write ``tokenizer.json`` to ``path``; return its sha256."""
    text = lex.tokenizer_json().encode()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(text)
    return hashlib.sha256(text).hexdigest()


def stratified(dist: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` values of a distribution at the midpoints of ``n`` equal
    quantile bins (the same multiset for every seed), shuffled by ``rng``.

    ``dist``: {"kind": "lognormal", "median", "sigma", "min", "max"} |
    {"kind": "uniform", "min", "max"} | {"kind": "loguniform", "min", "max"};
    integer-valued (rounded), clipped to [min, max]."""
    u = (np.arange(n) + 0.5) / n
    kind = dist["kind"]
    lo, hi = float(dist["min"]), float(dist["max"])
    if kind == "lognormal":
        from statistics import NormalDist

        z = np.array([NormalDist().inv_cdf(x) for x in u.tolist()])
        v = float(dist["median"]) * np.exp(float(dist["sigma"]) * z)
    elif kind == "uniform":
        v = lo + u * (hi + 1 - lo) - 0.5
    elif kind == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo))) - 0.5
    else:
        raise ValueError(f"unknown distribution kind {kind!r}")
    v = np.clip(np.rint(v), lo, hi).astype(np.int64)
    return rng.permutation(v)


class TextMaker:
    """Texts and label phrases for one seed over one lexicon."""

    def __init__(self, lex: Lexicon, traffic: dict, seed: int):
        self.lex = lex
        self.fresh_share = float(traffic.get("fresh_word_share", 0.0))
        self.punct_share = float(traffic.get("punct_share", 0.0))
        prng = rng_for(seed, 2)
        n_pool = int(traffic["label_pool"])
        self.label_pool = []
        seen = set()
        # Topic words: mid-frequency ranks, as a taxonomy's terms are.
        lo, hi = len(lex.words) // 100, max(len(lex.words) // 5, len(lex.words) // 100 + 2)
        while len(self.label_pool) < n_pool:
            k = int(prng.integers(1, 4))
            idx = prng.integers(lo, hi, size=k)
            phrase = " ".join(lex.words[i] for i in idx.tolist())
            if phrase not in seen:
                seen.add(phrase)
                self.label_pool.append(phrase)
        self._words = set(lex.words)

    def labels(self, rng: np.random.Generator, n: int) -> list[str]:
        return [self.label_pool[i] for i in rng.choice(len(self.label_pool), size=n, replace=False).tolist()]

    def texts(self, rng: np.random.Generator, word_counts: np.ndarray) -> list[str]:
        """One text per entry of ``word_counts``."""
        total = int(word_counts.sum())
        idx = np.minimum(np.searchsorted(self.lex.word_cdf, rng.random(total)), len(self.lex.words) - 1)
        words = [self.lex.words[i] for i in idx.tolist()]
        if self.fresh_share > 0:
            where = np.flatnonzero(rng.random(total) < self.fresh_share)
            fresh = _random_words(rng, len(where), 5, 11)
            for i, w in zip(where.tolist(), fresh):
                words[i] = w if w not in self._words else w + "q"
        if self.punct_share > 0:
            where = np.flatnonzero(rng.random(total) < self.punct_share)
            marks = rng.choice(np.array([".", ",", ".", "?", ";"]), size=len(where))
            for i, m in zip(where.tolist(), marks.tolist()):
                words[i] = words[i] + m
        out = []
        pos = 0
        for n in word_counts.tolist():
            out.append(" ".join(words[pos:pos + n]))
            pos += n
        return out
