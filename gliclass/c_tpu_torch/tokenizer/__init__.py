"""A reader and encoder of Hugging Face ``tokenizer.json`` in plain Python.

The port's counterpart of the ``tokenizers.Tokenizer`` that the JAX
package's ``tokenization.py`` wraps, with the surface the port uses:
``from_file``/``from_str``, ``encode``/``encode_batch`` (objects with
``.ids``), ``token_to_id``, ``id_to_token``, ``get_vocab_size``,
``padding`` and ``to_str``; a ``truncation`` block is honoured. It needs neither ``tokenizers``
nor ``regex``, so a bundle's tokenizer loads on a machine that has neither.

An encode runs the stages of ``tokenizers``, in its order:

1. the added-token split (:mod:`.added_tokens`), raw tokens first;
2. the normaliser (:mod:`.normalizers`) on each remaining segment, then the
   split at the normalised added tokens;
3. the pre-tokeniser (:mod:`.pre_tokenizers`);
4. the model on each piece (:mod:`.models`: BPE, Unigram, WordLevel);
5. truncation, the post-processor (:mod:`.post_processors`), padding.

Read: normalisers ``Sequence``, ``NFC``, ``NFD``, ``NFKC``, ``NFKD``,
``Lowercase``, ``Strip``, ``Replace``, ``Prepend``, ``Precompiled``;
pre-tokenisers ``ByteLevel``, ``Metaspace``, ``Split``, ``Whitespace``,
``WhitespaceSplit``, ``Punctuation``, ``Digits``, ``Sequence``; models
``BPE`` (dropout null), ``Unigram``, ``WordLevel``; post-processors
``TemplateProcessing`` (single template), ``BertProcessing``,
``RobertaProcessing``, ``ByteLevel``, ``Sequence``. Any other type (a
``WordPiece`` model, a ``BertPreTokenizer``, ...) raises
``NotImplementedError`` at load, naming the type and the file. Decoders are
read and ignored: encoding does not use them.
"""

from __future__ import annotations

import json
import math

from . import models, normalizers, post_processors, pre_tokenizers
from .added_tokens import AddedVocabulary


class Encoding:
    __slots__ = ("ids",)

    def __init__(self, ids: list[int]):
        self.ids = ids


class Tokenizer:
    def __init__(self, spec: dict, where: str = "<tokenizer.json string>"):
        self._spec = spec
        try:
            self.normalizer = normalizers.from_spec(spec.get("normalizer"), where)
            self.pre_tokenizer = pre_tokenizers.from_spec(spec.get("pre_tokenizer"), where)
        except NotImplementedError as e:  # a regex feature, named without the file
            if where in str(e):
                raise
            raise NotImplementedError(f"{e} in {where} is not supported by the port's reader") from None
        self.model = models.from_spec(spec["model"], where)
        self.post_processor = post_processors.from_spec(spec.get("post_processor"), where)
        size = len(self.model.pieces) if isinstance(self.model, models.Unigram) else len(self.model.vocab)
        self.added = AddedVocabulary(spec.get("added_tokens") or [], self.model.vocab, size, self.normalizer)
        self._model_size = size
        self._id_tokens = {i: t for t, i in self.model.vocab.items()}
        self._truncation = _truncation(spec.get("truncation"), where)
        self._padding = _padding(spec.get("padding"))

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f, parse_float=serde_f64), where=path)

    @classmethod
    def from_str(cls, s: str) -> "Tokenizer":
        return cls(json.loads(s, parse_float=serde_f64))

    # ------------------------------------------------------------ vocabulary
    def token_to_id(self, token: str) -> int | None:
        tid = self.added.token_ids.get(token)
        return tid if tid is not None else self.model.vocab.get(token)

    def id_to_token(self, tid: int) -> str | None:
        tok = self.added.id_tokens.get(tid)
        return tok if tok is not None else self._id_tokens.get(tid)

    def get_vocab_size(self, with_added_tokens: bool = True) -> int:
        if not with_added_tokens:
            return self._model_size
        return len(self.model.vocab.keys() | self.added.token_ids.keys())

    @property
    def padding(self) -> dict | None:
        """As ``tokenizers.Tokenizer.padding``: None, or the pad parameters."""
        return None if self._padding is None else dict(self._padding)

    # --------------------------------------------------------------- encode
    def _tokens(self, text: str) -> list[int]:
        ids: list[int] = []
        model, pre, norm = self.model, self.pre_tokenizer, self.normalizer
        for seg, tid, origin in self.added.raw.split(text, True):
            if tid is not None:
                ids.append(tid)
                continue
            moved = False
            if norm is not None:
                seg, moved = norm.normalize(seg)
            for piece, tid2, origin2 in self.added.normalized.split(seg, origin and not moved):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                words = pre.pre_tokenize([(piece, origin2)]) if pre is not None else [(piece, origin2)]
                for w, _ in words:
                    ids.extend(model.tokenize(w))
        return ids

    def _encode(self, text: str, add_special_tokens: bool) -> list[int]:
        ids = self._tokens(text)
        trunc = self._truncation
        if trunc is not None:
            n = trunc["max_length"]
            if add_special_tokens:
                n = max(n - self.post_processor.added(), 0)
            if len(ids) > n:
                ids = ids[:n] if trunc["direction"] == "right" else ids[len(ids) - n:]
        return self.post_processor.process(ids, add_special_tokens)

    def encode(self, text: str, add_special_tokens: bool = True) -> Encoding:
        if not isinstance(text, str):
            raise TypeError(f"encode takes a str, not {type(text).__name__}")
        return self._pad([Encoding(self._encode(text, add_special_tokens))])[0]

    def encode_batch(self, texts, add_special_tokens: bool = True) -> list[Encoding]:
        return self._pad([Encoding(self._encode(t, add_special_tokens)) for t in texts])

    def _pad(self, encs: list[Encoding]) -> list[Encoding]:
        pad = self._padding
        if pad is None or not encs:
            return encs
        n = pad["length"] if pad["length"] is not None else max(len(e.ids) for e in encs)
        m = pad["pad_to_multiple_of"]
        if m and n % m:
            n += m - n % m
        for e in encs:
            if len(e.ids) < n:
                fill = [pad["pad_id"]] * (n - len(e.ids))
                e.ids = e.ids + fill if pad["direction"] == "right" else fill + e.ids
        return encs

    # -------------------------------------------------------------- to_str
    def to_str(self) -> str:
        """The file as ``tokenizers.Tokenizer.to_str()`` writes it: compact
        JSON in the file's key order, floats as Rust's ``ryu`` prints them,
        BPE merges as pairs."""
        spec = self._spec
        model = spec["model"]
        if any(isinstance(m, str) for m in model.get("merges", ())):
            model = dict(model, merges=[m.split(" ", 1) if isinstance(m, str) else m for m in model["merges"]])
            spec = dict(spec, model=model)
        return _dumps(spec)


def _truncation(spec: dict | None, where: str) -> dict | None:
    if spec is None:
        return None
    strategy = spec.get("strategy", "LongestFirst")
    if strategy not in ("LongestFirst", "OnlyFirst"):
        raise NotImplementedError(f"truncation strategy {strategy!r} in {where}: a single sequence "
                                  "has no second sequence to truncate")
    return {"max_length": int(spec["max_length"]), "direction": spec.get("direction", "Right").lower()}


def _padding(spec: dict | None) -> dict | None:
    if spec is None:
        return None
    strategy = spec.get("strategy", "BatchLongest")
    return {"length": strategy["Fixed"] if isinstance(strategy, dict) else None,
            "pad_to_multiple_of": spec.get("pad_to_multiple_of"), "pad_id": spec.get("pad_id", 0),
            "pad_token": spec.get("pad_token", "[PAD]"), "pad_type_id": spec.get("pad_type_id", 0),
            "direction": spec.get("direction", "Right").lower()}


_U64_MAX = 2**64 - 1


def serde_f64(text: str) -> float:
    """A JSON number as ``serde_json`` (without ``float_roundtrip``) reads it
    into an f64, which ``tokenizers`` does: the digits into a u64 while they
    fit (later ones dropped, those before the point counted in the
    exponent), the u64 rounded to f64, then one multiplication or division
    by a power of ten. That can be an ulp off the correctly rounded value;
    Unigram scores are read so, and the lattice adds them."""
    neg = text.startswith("-")
    mant, _, exp = text.lstrip("-").replace("E", "e").partition("e")
    whole, _, frac = mant.partition(".")
    sig, e10, full = 0, 0, False
    for d in whole:
        if full or sig >= _U64_MAX // 10 and (sig > _U64_MAX // 10 or int(d) > _U64_MAX % 10):
            full = True
            e10 += 1
        else:
            sig = sig * 10 + int(d)
    for d in frac:
        if full or sig >= _U64_MAX // 10 and (sig > _U64_MAX // 10 or int(d) > _U64_MAX % 10):
            full = True
        else:
            sig = sig * 10 + int(d)
            e10 -= 1
    e10 += int(exp or 0)
    f = float(sig)
    while True:
        if abs(e10) <= 308:
            f = f * float(f"1e{abs(e10)}") if e10 >= 0 else f / float(f"1e{-e10}")
            break
        if f == 0.0 or e10 >= 0:
            break
        f /= 1e308
        e10 += 308
    return -f if neg else f


def _float(x: float) -> str:
    """``x`` as serde_json writes an f64 (the ``ryu`` crate's format)."""
    if not math.isfinite(x):
        return "null"
    r = repr(x)
    sign = "-" if r.startswith("-") else ""
    r = r.lstrip("-")
    mant, _, exp = r.partition("e")
    ip, _, fp = mant.partition(".")
    digits = (ip + fp).lstrip("0")
    k = int(exp or 0) - len(fp)
    if not digits:
        return sign + "0.0"
    stripped = digits.rstrip("0")
    k += len(digits) - len(stripped)
    digits = stripped
    n = len(digits)
    kk = n + k
    if 0 <= k and kk <= 16:
        body = digits + "0" * k + ".0"
    elif 0 < kk <= 16:
        body = digits[:kk] + "." + digits[kk:]
    elif -5 < kk <= 0:
        body = "0." + "0" * -kk + digits
    elif n == 1:
        body = f"{digits}e{kk - 1}"
    else:
        body = f"{digits[0]}.{digits[1:]}e{kk - 1}"
    return sign + body


def _dumps(v) -> str:
    if isinstance(v, dict):
        return "{" + ",".join(f"{json.dumps(k, ensure_ascii=False)}:{_dumps(x)}" for k, x in v.items()) + "}"
    if isinstance(v, list | tuple):
        return "[" + ",".join(_dumps(x) for x in v) + "]"
    if isinstance(v, float):
        return _float(v)
    return json.dumps(v, ensure_ascii=False)


__all__ = ["Encoding", "Tokenizer"]
