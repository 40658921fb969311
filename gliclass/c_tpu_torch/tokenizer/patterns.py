"""Patterns and character classes of ``tokenizer.json``, on Python's ``re``.

``tokenizers`` matches its regexes with Oniguruma (``Split``, ``Replace``,
``ByteLevel``'s GPT-2 pattern) or Rust's ``regex`` crate (``Whitespace``),
and tests characters with Rust's ``char`` predicates. Python's ``re`` has no
``\\p{...}``, and its ``\\s``/``\\w`` are not Oniguruma's, so every class is
spelt out here from ``unicodedata``, built once per process:

* ``\\p{L}``, ``\\p{N}``, ``\\p{Lu}``, ... and ``\\P{...}``/``\\p{^...}``:
  the general categories of Python's Unicode database;
* ``\\s``: the White_Space property (Rust's ``char::is_whitespace``), which,
  unlike ``str.isspace``, leaves out U+001C..U+001F;
* ``\\w``: Alphabetic + Mark + Nd + Pc + Join_Control (Rust's ``regex`` and
  ``is_word_character`` of the added-token split), which, unlike Python's,
  leaves out No and holds the marks;
* ``\\d``: Nd.

Oniguruma's ``^``/``$`` are line anchors. Escapes that mean another thing
in ``re`` (``\\b``, ``\\Z``, ...) or that ``re`` lacks, nested classes,
class intersection and POSIX brackets are refused.
"""

from __future__ import annotations

import functools
import re
import unicodedata

_MAX = 0x10FFFF

WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680),
               (0x2000, 0x200A), (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F),
               (0x3000, 0x3000))
_WHITE_SPACE_CHARS = frozenset(chr(c) for a, b in WHITE_SPACE for c in range(a, b + 1))

# Other_Alphabetic code points outside the marks (circled and squared letters).
_OTHER_ALPHABETIC_SO = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))
_JOIN_CONTROL = ((0x200C, 0x200D),)


@functools.cache
def _category_ranges() -> dict[str, tuple[tuple[int, int], ...]]:
    """Two-letter general category -> sorted code point ranges (one pass)."""
    runs: dict[str, list[list[int]]] = {}
    cat = unicodedata.category
    prev, start = cat("\0"), 0
    for cp in range(1, _MAX + 2):
        c = cat(chr(cp)) if cp <= _MAX else None
        if c != prev:
            runs.setdefault(prev, []).append([start, cp - 1])
            prev, start = c, cp
    return {k: tuple(map(tuple, v)) for k, v in runs.items()}


def _merge(ranges) -> tuple[tuple[int, int], ...]:
    out: list[list[int]] = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return tuple(map(tuple, out))


def _complement(ranges) -> tuple[tuple[int, int], ...]:
    out, nxt = [], 0
    for a, b in ranges:
        if a > nxt:
            out.append((nxt, a - 1))
        nxt = b + 1
    if nxt <= _MAX:
        out.append((nxt, _MAX))
    return tuple(out)


@functools.cache
def category(name: str) -> tuple[tuple[int, int], ...]:
    """Ranges of a general category by its one- or two-letter name (``L``,
    ``Lu``, ...)."""
    cats = _category_ranges()
    if len(name) == 1:
        keys = [k for k in cats if k and k[0] == name]
        if not keys:
            raise NotImplementedError(f"unicode property {name!r}")
        return _merge(r for k in keys for r in cats[k])
    if name not in cats and name not in {"Cs", "Co", "Zl", "Zp"}:
        raise NotImplementedError(f"unicode property {name!r}")
    return cats.get(name, ())


@functools.cache
def word_class() -> tuple[tuple[int, int], ...]:
    return _merge(category("L") + category("Nl") + category("M") + category("Nd") + category("Pc")
                  + _OTHER_ALPHABETIC_SO + _JOIN_CONTROL)


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}"


def render(ranges) -> str:
    """Ranges as the body of a ``re`` character class."""
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}" for a, b in ranges)


def _property(body: str, negate: bool) -> tuple[tuple[int, int], ...]:
    if body.startswith("^"):
        body, negate = body[1:], not negate
    ranges = category(body)
    return _complement(ranges) if negate else ranges


_SHORTHAND = {
    "s": lambda: WHITE_SPACE,
    "w": word_class,
    "d": lambda: category("Nd"),
}
# Escapes whose meaning differs between Oniguruma and ``re`` (or that ``re``
# lacks) outside a class: refused rather than read differently.
_REFUSED_ESCAPES = "bBzZhHGKRXyYkgO"


def _class_escape(p: str, i: int):
    """The class of the escape at ``p[i] == '\\'`` and the index after it,
    or ``(None, i)`` when the escape is not a class."""
    c = p[i + 1] if i + 1 < len(p) else ""
    if c in "pP":
        if i + 2 < len(p) and p[i + 2] == "{":
            end = p.index("}", i + 3)
            return _property(p[i + 3:end], c == "P"), end + 1
        return _property(p[i + 2], c == "P"), i + 3
    if c.lower() in _SHORTHAND:
        ranges = _SHORTHAND[c.lower()]()
        return (_complement(ranges) if c.isupper() else ranges), i + 2
    return None, i


def _plain_escape(p: str, i: int) -> tuple[str, int]:
    c = p[i + 1]
    if c in _REFUSED_ESCAPES or c.isdigit() and c != "0" or p.startswith("x{", i + 1):
        raise NotImplementedError(f"regex escape \\{c} in {p!r}")
    return p[i:i + 2], i + 2


def translate(pattern: str) -> str:
    """An Oniguruma pattern as the equivalent Python ``re`` pattern."""
    out, i, n = [], 0, len(pattern)
    while i < n:
        c = pattern[i]
        if c == "\\":
            ranges, j = _class_escape(pattern, i)
            if ranges is not None:
                out.append(f"[{render(ranges)}]")
                i = j
            else:
                text, i = _plain_escape(pattern, i)
                out.append(text)
        elif c == "[":
            text, i = _translate_class(pattern, i)
            out.append(text)
        elif c == "^":
            out.append("(?m:^)")
            i += 1
        elif c == "$":
            out.append("(?m:$)")
            i += 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _translate_class(p: str, i: int) -> tuple[str, int]:
    """``p[i] == '['``: the class, with escapes spelt out, and the index
    after its ``]``."""
    j = i + 1
    negate = p.startswith("^", j)
    if negate:
        j += 1
    body = []
    first = True
    while True:
        if j >= len(p):
            raise ValueError(f"unterminated character class in {p!r}")
        c = p[j]
        if c == "]" and not first:
            break
        if c == "[":
            raise NotImplementedError(f"nested class or POSIX bracket in {p!r}")
        if c == "&" and p.startswith("&&", j):
            raise NotImplementedError(f"class intersection in {p!r}")
        if c == "\\":
            ranges, k = _class_escape(p, j)
            if ranges is not None:
                body.append(render(ranges))
                j = k
            else:
                body.append(p[j:j + 2])
                j += 2
        else:
            body.append("\\]" if c == "]" else c)
            j += 1
        first = False
    return f"[{'^' if negate else ''}{''.join(body)}]", j + 1


@functools.cache
def compile_onig(pattern: str) -> re.Pattern:
    return re.compile(translate(pattern))


def is_whitespace(c: str) -> bool:
    """Rust's ``char::is_whitespace``."""
    return c in _WHITE_SPACE_CHARS


def _in(ranges, cp: int) -> bool:
    lo, hi = 0, len(ranges)
    while lo < hi:
        mid = (lo + hi) // 2
        a, b = ranges[mid]
        if cp < a:
            hi = mid
        elif cp > b:
            lo = mid + 1
        else:
            return True
    return False


@functools.cache
def is_word_character(c: str) -> bool:
    """``\\w`` as above (``tokenizers``' single-word test)."""
    return _in(word_class(), ord(c))


def find_matches(regex: re.Pattern, s: str) -> list[tuple[int, int, bool]]:
    """``tokenizers``' ``Pattern::find_matches`` for a regex: the string cut
    into ``(start, end, is_match)`` pieces, in order. Matches come from
    ``onig``'s ``find_iter``, which drops an empty match that ends where the
    previous match ended (Python's ``finditer`` keeps it): when ``finditer``
    gives an empty match, the search is redone step by step."""
    if not s:
        return [(0, 0, False)]
    spans = [m.span() for m in regex.finditer(s)]
    if any(a == b for a, b in spans):
        spans = _onig_find_iter(regex, s)
    out, prev = [], 0
    for a, b in spans:
        if prev != a:
            out.append((prev, a, False))
        out.append((a, b, True))
        prev = b
    if prev != len(s):
        out.append((prev, len(s), False))
    return out


def _onig_find_iter(regex: re.Pattern, s: str) -> list[tuple[int, int]]:
    spans, pos, last_end = [], 0, None
    while pos <= len(s):
        m = regex.search(s, pos)
        if m is None:
            break
        a, b = m.span()
        if a == b and last_end == b:
            pos += 1
            continue
        spans.append((a, b))
        pos = last_end = b
    return spans


def find_char_matches(pred, s: str) -> list[tuple[int, int, bool]]:
    """``find_matches`` for a character predicate: every character that
    satisfies it is a match of its own."""
    if not s:
        return [(0, 0, False)]
    out, last = [], 0
    for i, c in enumerate(s):
        if pred(c):
            if last < i:
                out.append((last, i, False))
            out.append((i, i + 1, True))
            last = i + 1
    if last < len(s):
        out.append((last, len(s), False))
    return out


def split(s: str, matches: list[tuple[int, int, bool]], behavior: str) -> list[tuple[int, int]]:
    """``NormalizedString::split``: the ``(start, end)`` pieces that a split
    behaviour keeps (empty ones included; callers drop them)."""
    if behavior == "Removed":
        return [(a, b) for a, b, m in matches if not m]
    if behavior == "Isolated":
        return [(a, b) for a, b, _ in matches]
    out: list[list[int]] = []
    prev = False
    if behavior == "Contiguous":
        for a, b, m in matches:
            if m == prev and out:
                out[-1][1] = b
            else:
                out.append([a, b])
            prev = m
    elif behavior == "MergedWithPrevious":
        for a, b, m in matches:
            if m and not prev and out:
                out[-1][1] = b
            else:
                out.append([a, b])
            prev = m
    elif behavior == "MergedWithNext":
        for a, b, m in reversed(matches):
            if m and not prev and out:
                out[-1][0] = a
            else:
                out.append([a, b])
            prev = m
        out.reverse()
    else:
        raise NotImplementedError(f"split behavior {behavior!r}")
    return [(a, b) for a, b in out]
