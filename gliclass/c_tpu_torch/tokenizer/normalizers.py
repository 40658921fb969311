"""Normalisers of ``tokenizer.json``.

Each normaliser maps a string to a string and says whether it moved the
first character's alignment off the segment's original start (``tokenizers``
keeps byte alignments; the reader keeps only this bit, which
``Metaspace(prepend_scheme="first")`` reads through the segment's original
offset). Strip and Replace can move it; the others keep it.
"""

from __future__ import annotations

import base64
import functools
import re
import struct
import unicodedata

from .patterns import compile_onig, find_matches, is_whitespace, render


class Normalizer:
    def normalize(self, s: str) -> tuple[str, bool]:
        raise NotImplementedError


class Sequence(Normalizer):
    def __init__(self, normalizers: list[Normalizer]):
        self.normalizers = normalizers

    def normalize(self, s: str) -> tuple[str, bool]:
        moved = False
        for n in self.normalizers:
            s, m = n.normalize(s)
            moved = moved or m
        return s, moved


# Code points that ``tokenizers``' Unicode normalisation does not know.
# ``tokenizers`` normalises with the ``unicode-normalization-alignments``
# crate, whose tables are Unicode 9.0: to it these characters, assigned
# later and given a combining class or a decomposition in Python's
# database, are unassigned (class 0, no decomposition, no composition).
# U+11930 and U+11935 compose to U+11938 in Python's database only. The
# reader cuts the text at them and normalises the runs between;
# tests/test_torch_tokenizer.py finds the same set with ``tokenizers``.
UNKNOWN_TO_NORMALIZATION = (
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8D3), (0x9FE, 0x9FE), (0xC3C, 0xC3C), (0xD3B, 0xD3C),
    (0xEBA, 0xEBA), (0x1715, 0x1715), (0x1ABF, 0x1ACE), (0x1DF6, 0x1DFA), (0x32FF, 0x32FF),
    (0xA7F2, 0xA7F4), (0xA82C, 0xA82C), (0xAB69, 0xAB69), (0x10781, 0x10785), (0x10787, 0x107B0),
    (0x107B2, 0x107BA), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC), (0x10EFD, 0x10EFF), (0x10F46, 0x10F50),
    (0x10F82, 0x10F85), (0x11070, 0x11070), (0x1133B, 0x1133B), (0x1145E, 0x1145E), (0x11839, 0x1183A),
    (0x11930, 0x11930), (0x11935, 0x11935), (0x11938, 0x11938), (0x1193D, 0x1193E), (0x11943, 0x11943),
    (0x119E0, 0x119E0), (0x11A34, 0x11A34), (0x11A47, 0x11A47), (0x11A99, 0x11A99), (0x11D42, 0x11D42),
    (0x11D44, 0x11D45), (0x11D97, 0x11D97), (0x11F41, 0x11F42), (0x16FF0, 0x16FF1), (0x1E030, 0x1E06D),
    (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF),
    (0x1F16C, 0x1F16C), (0x1FBF0, 0x1FBF9))
_UNKNOWN = re.compile(f"([{render(UNKNOWN_TO_NORMALIZATION)}])")


class Unicode(Normalizer):
    """NFC, NFD, NFKC or NFKD, with :data:`UNKNOWN_TO_NORMALIZATION` left
    as they are."""

    def __init__(self, form: str):
        self.form = form

    def normalize(self, s: str) -> tuple[str, bool]:
        if s.isascii():
            return s, False
        parts = _UNKNOWN.split(s)
        parts[::2] = [unicodedata.normalize(self.form, p) for p in parts[::2]]
        return "".join(parts), False


class Lowercase(Normalizer):
    """Rust's ``char::to_lowercase`` character by character: no final-sigma
    context, unlike ``str.lower`` on a whole string."""

    def normalize(self, s: str) -> tuple[str, bool]:
        if s.isascii():
            return s.lower(), False
        return "".join(_lower(c) for c in s), False


@functools.cache
def _lower(c: str) -> str:
    return c.lower()


class Strip(Normalizer):
    def __init__(self, left: bool, right: bool):
        self.left, self.right = left, right

    def normalize(self, s: str) -> tuple[str, bool]:
        a, b = 0, len(s)
        if self.left:
            while a < b and is_whitespace(s[a]):
                a += 1
        if self.right:
            while b > a and is_whitespace(s[b - 1]):
                b -= 1
        return s[a:b], a > 0


class Replace(Normalizer):
    """Every non-overlapping match of a string or an Oniguruma regex."""

    def __init__(self, pattern: dict, content: str):
        if "String" in pattern:
            self.literal, self.regex = pattern["String"], None
        else:
            self.literal, self.regex = None, compile_onig(pattern["Regex"])
        self.content = content

    def normalize(self, s: str) -> tuple[str, bool]:
        if self.regex is None:
            if not self.literal or self.literal not in s:
                return s, False
            # A replacement of the first character keeps its alignment when
            # the match is one character and the content is not empty: the
            # inserted text takes the alignment of the match's last character.
            moved = s.startswith(self.literal) and (len(self.literal) > 1 or not self.content)
            return s.replace(self.literal, self.content), moved
        out, moved = [], False
        for a, b, m in find_matches(self.regex, s):
            if m:
                out.append(self.content)
                moved = moved or (a == 0 and b > a and (b - a > 1 or not self.content))
            else:
                out.append(s[a:b])
        return "".join(out), moved


class Prepend(Normalizer):
    def __init__(self, prepend: str):
        self.prepend = prepend

    def normalize(self, s: str) -> tuple[str, bool]:
        return (self.prepend + s if s else s), False


class Precompiled(Normalizer):
    """sentencepiece's ``precompiled_charsmap``, as the ``spm_precompiled``
    crate applies it: a darts-clone double array over UTF-8 keys whose values
    are offsets into a block of NUL-terminated replacements.

    The text is cut into extended grapheme clusters. A cluster shorter than
    6 bytes is looked up whole, and the FIRST (shortest) key that is a prefix
    of it replaces the whole cluster; otherwise, and when no key matched,
    each character is looked up on its own. Python has no grapheme
    segmentation, so :func:`graphemes` forms clusters from the UAX #29 rules
    it can state from ``unicodedata`` and the lists below: CR LF; a base
    followed by Extend (Mn, Me, Other_Grapheme_Extend, emoji modifiers),
    ZWJ and SpacingMark (Mc but the listed exceptions, plus U+0E33/U+0EB3);
    Prepend before a base; Hangul L/V/T/LV/LVT runs; regional-indicator
    pairs; emoji ZWJ sequences (Extended_Pictographic Extend* ZWJ x
    Extended_Pictographic). Not formed: the Indic conjunct rule (GB9c,
    Unicode 15.1), and the Control class of unassigned default-ignorable
    code points."""

    def __init__(self, charsmap: bytes):
        self.units: tuple[int, ...] = ()
        self.replacements = b""
        if charsmap:
            (size,) = struct.unpack_from("<I", charsmap)
            self.units = struct.unpack_from(f"<{size // 4}I", charsmap, 4)
            self.replacements = charsmap[4 + size:]
        self._starts: dict[str, bool] = {}
        self._cache: dict[str, str | None] = {}

    def transform(self, chunk: str) -> str | None:
        """The replacement of the shortest key that is a prefix of ``chunk``."""
        if chunk in self._cache:
            return self._cache[chunk]
        units, n = self.units, len(self.units)
        out = None
        if n:
            pos = _offset(units[0])
            for c in chunk.encode():
                if c == 0:
                    break
                pos ^= c
                if pos >= n:
                    break
                u = units[pos]
                if u & 0x800000FF != c:
                    break
                pos ^= _offset(u)
                if (u >> 8) & 1:
                    start = units[pos] & 0x7FFFFFFF
                    end = self.replacements.index(b"\0", start)
                    out = self.replacements[start:end].decode()
                    break
        self._cache[chunk] = out
        return out

    def _begins_key(self, c: str) -> bool:
        """Whether some key begins with the character ``c``."""
        hit = self._starts.get(c)
        if hit is None:
            units, n = self.units, len(self.units)
            hit = bool(n)
            if n:
                pos = _offset(units[0])
                for b in c.encode():
                    pos ^= b
                    if b == 0 or pos >= n or units[pos] & 0x800000FF != b:
                        hit = False
                        break
                    pos ^= _offset(units[pos])
            self._starts[c] = hit
        return hit

    def normalize(self, s: str) -> tuple[str, bool]:
        if not any(self._begins_key(c) for c in set(s)):
            return s, False
        out = []
        for g in graphemes(s):
            if len(g.encode()) < 6:
                t = self.transform(g)
                if t is not None:
                    out.append(t)
                    continue
            for c in g:
                t = self.transform(c)
                out.append(c if t is None else t)
        return "".join(out), False


def _offset(u: int) -> int:
    return (u >> 10) << ((u & (1 << 9)) >> 6)


# ---------------------------------------------------------------- graphemes

_OTHER_GRAPHEME_EXTEND = ((0x09BE, 0x09BE), (0x09D7, 0x09D7), (0x0B3E, 0x0B3E), (0x0B57, 0x0B57),
                          (0x0BBE, 0x0BBE), (0x0BD7, 0x0BD7), (0x0CC2, 0x0CC2), (0x0CD5, 0x0CD6),
                          (0x0D3E, 0x0D3E), (0x0D57, 0x0D57), (0x0DCF, 0x0DCF), (0x0DDF, 0x0DDF),
                          (0x1B35, 0x1B35), (0x200C, 0x200C), (0x302E, 0x302F), (0xFF9E, 0xFF9F),
                          (0x1133E, 0x1133E), (0x11357, 0x11357), (0x114B0, 0x114B0), (0x114BD, 0x114BD),
                          (0x115AF, 0x115AF), (0x11930, 0x11930), (0x1D165, 0x1D165), (0x1D16E, 0x1D172),
                          (0xE0020, 0xE007F), (0x1F3FB, 0x1F3FF))
_NOT_SPACING_MARK = ((0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064), (0x1067, 0x106D),
                     (0x1083, 0x1083), (0x1087, 0x108C), (0x108F, 0x108F), (0x109A, 0x109C),
                     (0x1A61, 0x1A61), (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
                     (0x11720, 0x11721))
_PREPEND = ((0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F), (0x0890, 0x0891), (0x08E2, 0x08E2),
            (0x0D4E, 0x0D4E), (0x110BD, 0x110BD), (0x110CD, 0x110CD), (0x111C2, 0x111C3),
            (0x1193F, 0x1193F), (0x11941, 0x11941), (0x11A3A, 0x11A3A), (0x11A84, 0x11A89),
            (0x11D46, 0x11D46), (0x11F02, 0x11F02))
_EXTENDED_PICTOGRAPHIC = (
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122),
    (0x2139, 0x2139), (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B), (0x2328, 0x2328),
    (0x2388, 0x2388), (0x23CF, 0x23CF), (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2),
    (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0), (0x25FB, 0x25FE), (0x2600, 0x2605),
    (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712), (0x2714, 0x2714),
    (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721), (0x2728, 0x2728), (0x2733, 0x2734),
    (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755),
    (0x2757, 0x2757), (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0),
    (0x27BF, 0x27BF), (0x2934, 0x2935), (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50),
    (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D), (0x3297, 0x3297), (0x3299, 0x3299),
    (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
    (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5),
    (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A), (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A),
    (0x1F23C, 0x1F23F), (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
    (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF), (0x1F80C, 0x1F80F),
    (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF),
    (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))


def _in(ranges, cp: int) -> bool:
    return any(a <= cp <= b for a, b in ranges)


@functools.cache
def _gcb(c: str) -> str:
    """Grapheme_Cluster_Break of ``c`` (``Other`` for the rest), plus
    ``ExtPict`` for Extended_Pictographic characters of class Other."""
    cp = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if cp == 0x200D:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or _in(_OTHER_GRAPHEME_EXTEND, cp):
        return "Extend"
    if _in(_PREPEND, cp):
        return "Prepend"
    if cat in ("Cc", "Zl", "Zp", "Cf"):
        return "Control"
    if (cat == "Mc" and not _in(_NOT_SPACING_MARK, cp)) or cp in (0x0E33, 0x0EB3):
        return "SpacingMark"
    if _in(_EXTENDED_PICTOGRAPHIC, cp):
        return "ExtPict"
    return "Other"


def graphemes(s: str) -> list[str]:
    """Extended grapheme clusters of ``s`` (see :class:`Precompiled`)."""
    out: list[str] = []
    start = 0
    prev = None
    ri_run = 0  # regional indicators in a row, ending at prev
    emoji = 0  # 1: ExtPict Extend*, 2: ExtPict Extend* ZWJ
    for i, c in enumerate(s):
        cur = _gcb(c)
        if prev is None:
            join = False
        elif prev == "CR" and cur == "LF":
            join = True
        elif prev in ("Control", "CR", "LF") or cur in ("Control", "CR", "LF"):
            join = False
        elif prev == "L" and cur in ("L", "V", "LV", "LVT"):
            join = True
        elif prev in ("LV", "V") and cur in ("V", "T"):
            join = True
        elif prev in ("LVT", "T") and cur == "T":
            join = True
        elif cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            join = True
        elif emoji == 2 and cur == "ExtPict":
            join = True
        elif prev == "RI" and cur == "RI":
            join = ri_run % 2 == 1
        else:
            join = False
        if not join and i > start:
            out.append(s[start:i])
            start = i
        ri_run = ri_run + 1 if cur == "RI" else 0
        if cur == "ExtPict":
            emoji = 1
        elif cur == "Extend" and emoji == 1:
            emoji = 1
        elif cur == "ZWJ" and emoji == 1:
            emoji = 2
        else:
            emoji = 0
        prev = cur
    if start < len(s):
        out.append(s[start:])
    return out


# ------------------------------------------------------------------- loading

def from_spec(spec: dict | None, where: str) -> Normalizer | None:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        return Sequence([from_spec(n, where) for n in spec["normalizers"]])
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return Unicode(kind)
    if kind == "Lowercase":
        return Lowercase()
    if kind == "Strip":
        return Strip(spec.get("strip_left", True), spec.get("strip_right", True))
    if kind == "Replace":
        return Replace(spec["pattern"], spec["content"])
    if kind == "Prepend":
        return Prepend(spec["prepend"])
    if kind == "Precompiled":
        blob = spec.get("precompiled_charsmap") or ""
        return Precompiled(base64.b64decode(blob) if isinstance(blob, str) else bytes(blob))
    raise NotImplementedError(f"normalizer type {kind!r} in {where} is not supported by the port's reader")
