"""Pre-tokenisers of ``tokenizer.json``.

A pre-tokeniser maps a list of pieces to a list of pieces. A piece is
``(text, at_origin)``: ``at_origin`` says that the piece starts at the
original text's first character, which is what ``Metaspace`` with
``prepend_scheme="first"`` tests (``offsets_original().0 == 0``). A piece
cut at a later offset is never at the origin. Empty pieces are dropped, as
``PreTokenizedString::split`` drops them.
"""

from __future__ import annotations

import re
import string
import unicodedata

from . import patterns as P

# GPT-2's pattern, which ByteLevel(use_regex=true) splits with.
GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(
        range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


# Also the str.translate table from UTF-8 bytes decoded as latin-1 to
# ByteLevel text.
BYTES_CHAR = _bytes_to_unicode()

Piece = tuple[str, bool]


def _cut(pieces: list[Piece], cut) -> list[Piece]:
    """Apply ``cut(text) -> [(start, end)]`` to every piece; the piece at
    offset 0 keeps its origin flag."""
    out = []
    for s, origin in pieces:
        for a, b in cut(s):
            if b > a:
                out.append((s[a:b], origin and a == 0))
    return out


class PreTokenizer:
    def pre_tokenize(self, pieces: list[Piece]) -> list[Piece]:
        raise NotImplementedError


class Sequence(PreTokenizer):
    def __init__(self, items: list[PreTokenizer]):
        self.items = items

    def pre_tokenize(self, pieces):
        for p in self.items:
            pieces = p.pre_tokenize(pieces)
        return pieces


class ByteLevel(PreTokenizer):
    def __init__(self, add_prefix_space: bool, use_regex: bool):
        self.add_prefix_space = add_prefix_space
        self.regex = P.compile_onig(GPT2_PATTERN) if use_regex else None

    def pre_tokenize(self, pieces):
        if self.add_prefix_space:
            pieces = [(s if s.startswith(" ") else " " + s, o) for s, o in pieces]
        if self.regex is not None:
            regex = self.regex
            pieces = _cut(pieces, lambda s: P.split(s, P.find_matches(regex, s), "Isolated"))
        return [(s.encode().decode("latin-1").translate(BYTES_CHAR), o) for s, o in pieces]


class Metaspace(PreTokenizer):
    def __init__(self, replacement: str, prepend_scheme: str, split: bool):
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme
        self.split = split

    def pre_tokenize(self, pieces):
        rep = self.replacement
        out = []
        for s, origin in pieces:
            s = s.replace(" ", rep)
            if not s.startswith(rep) and (self.prepend_scheme == "always"
                                          or self.prepend_scheme == "first" and origin):
                s = rep + s
            out.append((s, origin))
        if self.split:
            out = _cut(out, lambda s: P.split(s, P.find_char_matches(lambda c: c == rep, s), "MergedWithNext"))
        return out


class Split(PreTokenizer):
    def __init__(self, pattern: dict, behavior: str, invert: bool):
        if "String" in pattern:
            self.regex = re.compile(re.escape(pattern["String"]))
        else:
            self.regex = P.compile_onig(pattern["Regex"])
        self.behavior, self.invert = behavior, invert

    def _cut(self, s):
        matches = P.find_matches(self.regex, s)
        if self.invert:
            matches = [(a, b, not m) for a, b, m in matches]
        return P.split(s, matches, self.behavior)

    def pre_tokenize(self, pieces):
        return _cut(pieces, self._cut)


class Whitespace(PreTokenizer):
    """``\\w+|[^\\w\\s]+`` (Rust's ``regex``), the rest removed."""

    def __init__(self):
        w, s = P.render(P.word_class()), P.render(P.WHITE_SPACE)
        self.regex = re.compile(f"[{w}]+|[^{w}{s}]+")

    def pre_tokenize(self, pieces):
        regex = self.regex
        return _cut(pieces, lambda s: P.split(s, [(a, b, not m) for a, b, m in P.find_matches(regex, s)],
                                              "Removed"))


class WhitespaceSplit(PreTokenizer):
    def pre_tokenize(self, pieces):
        return _cut(pieces, lambda s: P.split(s, P.find_char_matches(P.is_whitespace, s), "Removed"))


def _is_punctuation(c: str) -> bool:
    return c in string.punctuation or unicodedata.category(c).startswith("P")


class Punctuation(PreTokenizer):
    def __init__(self, behavior: str):
        self.behavior = behavior

    def pre_tokenize(self, pieces):
        return _cut(pieces, lambda s: P.split(s, P.find_char_matches(_is_punctuation, s), self.behavior))


def _is_numeric(c: str) -> bool:
    return unicodedata.category(c) in ("Nd", "Nl", "No")


class Digits(PreTokenizer):
    def __init__(self, individual_digits: bool):
        self.behavior = "Isolated" if individual_digits else "Contiguous"

    def pre_tokenize(self, pieces):
        return _cut(pieces, lambda s: P.split(s, P.find_char_matches(_is_numeric, s), self.behavior))


def from_spec(spec: dict | None, where: str) -> PreTokenizer | None:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        return Sequence([from_spec(p, where) for p in spec["pretokenizers"]])
    if kind == "ByteLevel":
        return ByteLevel(spec.get("add_prefix_space", True), spec.get("use_regex", True))
    if kind == "Metaspace":
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # files written before tokenizers 0.19
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        return Metaspace(spec.get("replacement", "▁"), scheme, spec.get("split", True))
    if kind == "Split":
        return Split(spec["pattern"], spec["behavior"], spec.get("invert", False))
    if kind == "Whitespace":
        return Whitespace()
    if kind == "WhitespaceSplit":
        return WhitespaceSplit()
    if kind == "Punctuation":
        return Punctuation(spec.get("behavior", "Isolated"))
    if kind == "Digits":
        return Digits(spec.get("individual_digits", False))
    raise NotImplementedError(f"pre_tokenizer type {kind!r} in {where} is not supported by the port's reader")
