"""A byte-level BPE trainer: the port's counterpart of ``tokenizers``'
``BpeTrainer`` and ``Tokenizer.train_from_iterator``.

It trains the one configuration that the model-production scripts use (a
``BPE`` model with an unknown token, the ``ByteLevel`` pre-tokeniser with
GPT-2's pattern, special tokens, an initial alphabet, a vocabulary size)
and writes a ``tokenizer.json`` whose ``to_str()`` is byte-equal to the one
``tokenizers`` (0.22) writes for the same texts. Any other trainer option
raises ``NotImplementedError`` naming it.

The training follows ``tokenizers``' ``BpeTrainer::do_train``:

1. the special tokens take the first ids, in their order;
2. the alphabet (every character of the words and the initial alphabet)
   comes next, sorted by code point;
3. each distinct word becomes a list of character ids; the count of a pair
   is the sum of the counts of the words it occurs in, once per occurrence;
4. a max-heap of ``(count, pair, word positions)`` entries pops the largest
   count first and, on a tie, the smaller ``(id_a, id_b)``; an entry whose
   count is stale goes back with the current count; a current one is merged
   in its own positions only, adds a merge even when the merged string is
   already in the vocabulary (it keeps its id), and the new pairs of those
   words are pushed as one entry per pair;
5. merging a pair changes the counts of its neighbours' pairs, not its own
   (its heap entry is gone); the loop ends at ``vocab_size`` pieces, on an
   empty heap, or when the popped count is below 1.

A pair merged twice keeps its last rank in the file, as ``tokenizers``' merge
map does. The words are the pre-tokeniser's pieces of each text, with no
added-token split: special tokens are added after training, so a literal
``[CLS]`` in a text is cut as any other text.
"""

from __future__ import annotations

import heapq
import itertools
import re
import time
from collections import Counter
from typing import Iterable, Iterator

from . import Tokenizer
from . import patterns as P
from .pre_tokenizers import BYTES_CHAR, GPT2_PATTERN

# Pair (a, b) as one int a * _PAIR + b: its order is (a, b)'s.
_PAIR = 1 << 32

# tokenizers' BpeTrainer options and their defaults; the trainer implements
# the default of each.
_DEFAULTS = {"min_frequency": 0, "limit_alphabet": None, "continuing_subword_prefix": None,
             "end_of_word_suffix": None, "max_token_length": None}


def byte_level_alphabet() -> list[str]:
    """``pre_tokenizers.ByteLevel.alphabet()``: the 256 characters of the
    byte-level map."""
    return sorted(BYTES_CHAR.values())


class BpeTrainer:
    """``tokenizers.trainers.BpeTrainer`` with ``vocab_size``,
    ``special_tokens`` (strings: special, not normalised) and
    ``initial_alphabet``; ``show_progress`` is accepted and unused. After a
    training, ``report`` holds its counts and stage times."""

    def __init__(self, vocab_size: int = 30000, special_tokens: Iterable[str] = (),
                 initial_alphabet: Iterable[str] = (), show_progress: bool = True, **options):
        for name, value in options.items():
            if name not in _DEFAULTS:
                raise TypeError(f"BpeTrainer got an unexpected option {name!r}")
            if value != _DEFAULTS[name]:
                raise NotImplementedError(f"BpeTrainer option {name}={value!r}: the port's trainer implements "
                                          f"only its default, {_DEFAULTS[name]!r}")
        self.vocab_size = int(vocab_size)
        self.special_tokens = [_special(t) for t in special_tokens]
        alphabet = set()
        for c in initial_alphabet:
            if len(c) != 1:  # tokenizers keeps the first character of each string
                if not c:
                    continue
                c = c[0]
            alphabet.add(c)
        self.initial_alphabet = alphabet
        self.report: dict = {}

    # ----------------------------------------------------------- training
    def train(self, word_counts: dict[str, int]) -> tuple[dict[str, int], list[tuple[str, str]]]:
        """Byte-level word -> count to (vocab, merges in rank order)."""
        t0 = time.perf_counter()
        w2id: dict[str, int] = {}
        id2w: list[str] = []

        def add(s: str) -> None:
            if s not in w2id:
                w2id[s] = len(id2w)
                id2w.append(s)

        for s in self.special_tokens:
            add(s)
        alphabet = set(self.initial_alphabet)
        for w in word_counts:
            alphabet.update(w)
        for c in sorted(alphabet):
            add(c)

        words = [[w2id[c] for c in w] for w in word_counts]
        counts = list(word_counts.values())
        pair_counts: dict[int, int] = {}
        occurs: dict[int, list[int]] = {}
        for i, (w, n) in enumerate(zip(words, counts)):
            for a, b in zip(w, w[1:]):
                key = a * _PAIR + b
                pair_counts[key] = pair_counts.get(key, 0) + n
                pos = occurs.get(key)
                if pos is None:
                    occurs[key] = [i]
                elif pos[-1] != i:
                    pos.append(i)
        seq = itertools.count()
        heap = [(-pair_counts[k], k, next(seq), pos) for k, pos in occurs.items()]
        del occurs
        heapq.heapify(heap)
        merges: list[tuple[int, int]] = []
        reused = 0
        while len(w2id) < self.vocab_size and heap:
            neg, key, _, pos = heapq.heappop(heap)
            count = pair_counts[key]
            if -neg != count:
                heapq.heappush(heap, (-count, key, next(seq), pos))
                continue
            if count < 1:
                break
            a, b = divmod(key, _PAIR)
            s = id2w[a] + id2w[b]
            new = w2id.get(s)
            if new is None:
                new = w2id[s] = len(id2w)
                id2w.append(s)
            else:
                reused += 1
            merges.append((a, b))
            changes, gained = _merge_words(words, counts, pos, a, b, new)
            for k, d in changes.items():
                pair_counts[k] = pair_counts.get(k, 0) + d
            for k, p in gained.items():
                c = pair_counts[k]
                if c > 0:
                    heapq.heappush(heap, (-c, k, next(seq), p))
        # A pair merged more than once keeps its last rank.
        ranked = list(dict.fromkeys(reversed(merges)))[::-1]
        self.report.update(merges=len(merges), reused=reused, pieces=len(id2w), merge_s=time.perf_counter() - t0)
        return w2id, [(id2w[a], id2w[b]) for a, b in ranked]


def _special(token) -> str:
    if not isinstance(token, str):
        raise NotImplementedError(f"BpeTrainer special token {token!r}: the port's trainer takes strings "
                                  "(special, not normalised)")
    return token


def _merge_words(words: list[list[int]], counts: list[int], positions: list[int], a: int, b: int,
                 new: int) -> tuple[dict[int, int], dict[int, list[int]]]:
    """Merge ``(a, b)`` into ``new`` in the words at ``positions``, left to
    right in each (``Word::merge``). Returns the weighted count change of
    each pair and, for each pair that gained an occurrence, the words where
    it did (each once, in order)."""
    changes: dict[int, int] = {}
    where: dict[int, list[int]] = {}
    get = changes.get

    def gained(key: int, i: int) -> None:
        pos = where.get(key)
        if pos is None:
            where[key] = [i]
        elif pos[-1] != i:
            pos.append(i)

    for i in positions:
        w = words[i]
        n = len(w)
        j = 0
        cnt = counts[i]
        while True:
            try:
                j = w.index(a, j, n - 1)
            except ValueError:
                break
            if w[j + 1] == b:
                if j > 0:
                    p = w[j - 1] * _PAIR
                    changes[p + a] = get(p + a, 0) - cnt
                    changes[p + new] = get(p + new, 0) + cnt
                    gained(p + new, i)
                w[j:j + 2] = (new,)
                n -= 1
                if j < n - 1:
                    q = w[j + 1]
                    changes[b * _PAIR + q] = get(b * _PAIR + q, 0) - cnt
                    changes[new * _PAIR + q] = get(new * _PAIR + q, 0) + cnt
                    gained(new * _PAIR + q, i)
            j += 1
    return changes, where


# ---------------------------------------------------------------- counting
def _texts(iterator) -> Iterator[str]:
    """The texts of ``train_from_iterator``'s iterator: strings, or
    iterables of strings (batches)."""
    for item in iterator:
        if isinstance(item, str):
            yield item
        else:
            for s in item:
                if not isinstance(s, str):
                    raise TypeError(f"train_from_iterator takes strings, not {type(s).__name__}")
                yield s


def _count_words(texts: Iterable[str]) -> Counter:
    """Raw (not yet byte-mapped) pre-tokeniser pieces of ``texts`` and their
    counts: the matches of GPT-2's pattern, which leaves no gap (every
    character is whitespace, a letter, a number or none of these)."""
    regex: re.Pattern = P.compile_onig(GPT2_PATTERN)
    counts: Counter = Counter()
    for text in texts:
        counts.update(regex.findall(text))
    return counts


def _byte_level_counts(raw: Counter) -> dict[str, int]:
    """Raw pieces -> byte-level words (the map is one to one)."""
    return {s.encode().decode("latin-1").translate(BYTES_CHAR): n for s, n in raw.items()}


# ------------------------------------------------------------ tokenizer.json
def _bpe_spec(vocab: dict[str, int], merges: list[tuple[str, str]], unk_token: str | None) -> dict:
    return {"type": "BPE", "dropout": None, "unk_token": unk_token, "continuing_subword_prefix": None,
            "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
            "vocab": dict(sorted(vocab.items(), key=lambda kv: kv[1])), "merges": [list(m) for m in merges]}


def _added_token(content: str, tid: int) -> dict:
    return {"id": tid, "content": content, "single_word": False, "lstrip": False, "rstrip": False,
            "normalized": False, "special": True}


def _tokenizer_spec(vocab: dict[str, int], merges: list[tuple[str, str]], special_tokens: list[str],
                    unk_token: str | None) -> dict:
    """The ``tokenizer.json`` of a trained byte-level BPE, in ``tokenizers``'
    key order (no post-processor yet)."""
    added = {}
    for t in special_tokens:
        added.setdefault(t, vocab[t])
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [_added_token(t, i) for t, i in sorted(added.items(), key=lambda kv: kv[1])],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True},
        "post_processor": None, "decoder": None,
        "model": _bpe_spec(vocab, merges, unk_token),
    }


def train_from_iterator(iterator, trainer: BpeTrainer, unk_token: str | None = None) -> Tokenizer:
    """``Tokenizer(models.BPE(unk_token=unk_token))`` with
    ``pre_tokenizer = ByteLevel(add_prefix_space=False)``, then
    ``train_from_iterator(iterator, trainer)``: the trained tokenizer. The
    iterator yields texts or iterables of texts (batches)."""
    t0 = time.perf_counter()
    words = _byte_level_counts(_count_words(_texts(iterator)))
    count_s = time.perf_counter() - t0
    trainer.report = {"distinct_words": len(words), "count_s": count_s}
    vocab, merges = trainer.train(words)
    return Tokenizer(_tokenizer_spec(vocab, merges, trainer.special_tokens, unk_token))


# ---------------------------------------------------------- post-processor
def cls_sep_template(tokenizer: Tokenizer) -> Tokenizer:
    """``tokenizer`` with the post-processor the real-scale artifact sets:
    ``processors.TemplateProcessing(single="[CLS] $A [SEP]", pair="[CLS] $A
    [SEP] $B [SEP]", special_tokens=[("[CLS]", id), ("[SEP]", id)])``, the
    ids being the tokenizer's own."""
    cls_, sep = ({"SpecialToken": {"id": t, "type_id": 0}} for t in ("[CLS]", "[SEP]"))
    a, b = ({"Sequence": {"id": s, "type_id": 0}} for s in "AB")
    specials = {t: {"id": t, "ids": [tokenizer.token_to_id(t)], "tokens": [t]} for t in ("[CLS]", "[SEP]")}
    spec = {"type": "TemplateProcessing", "single": [cls_, a, sep], "pair": [cls_, a, sep, b, sep],
            "special_tokens": specials}
    return Tokenizer(dict(tokenizer._spec, post_processor=spec))


__all__ = ["BpeTrainer", "byte_level_alphabet", "cls_sep_template", "train_from_iterator"]
