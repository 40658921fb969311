"""The added-token split of ``tokenizers``' ``AddedVocabulary``.

Added tokens are cut out of the input before anything else:

* first the ``normalized: false`` tokens, matched on the raw text;
* then, in each remaining segment after normalisation, the
  ``normalized: true`` tokens, matched by their normalised content.

Matching is leftmost-longest (``aho-corasick``'s ``LeftmostLongest``):
an alternation of the contents, longest first, gives the same matches.
``single_word`` drops a match with a word character (``\\w``) on either
side; ``lstrip``/``rstrip`` take the whitespace before/after the match into
it. ``special`` changes no id: ``add_special_tokens=False`` still splits out
and keeps every added token (it only leaves out the post-processor's), as
``tokenizers`` does; only decoding reads it.

Ids are assigned as ``tokenizers`` assigns them when it loads a file: the
model's id when the content is in its vocabulary, else the next free id
above it; the ``id`` field of the file is not read.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from .patterns import is_whitespace, is_word_character


@dataclass(frozen=True)
class AddedToken:
    content: str
    single_word: bool = False
    lstrip: bool = False
    rstrip: bool = False
    normalized: bool = True
    special: bool = False


class _Matcher:
    def __init__(self, tokens: list[tuple[str, AddedToken, int]]):
        """``tokens``: (pattern, token, id) in ``tokenizers``' order."""
        self.by_pattern: dict[str, tuple[AddedToken, int]] = {}
        for pat, tok, tid in tokens:
            if pat:
                self.by_pattern.setdefault(pat, (tok, tid))
        pats = sorted(self.by_pattern, key=len, reverse=True)
        self.regex = re.compile("|".join(map(re.escape, pats))) if pats else None

    def split(self, s: str, origin: bool) -> list[tuple[str, int | None, bool]]:
        """``s`` cut at the tokens: ``(text, id or None, at_origin)``, empty
        text pieces dropped."""
        if self.regex is None or not s:
            return [(s, None, origin)] if s else []
        out: list[tuple[str, int | None, bool]] = []
        done = 0
        for m in self.regex.finditer(s):
            a, b = m.span()
            tok, tid = self.by_pattern[m.group()]
            if tok.single_word and not (
                    (a == 0 or not is_word_character(s[a - 1]))
                    and (b == len(s) or not is_word_character(s[b]))):
                continue
            if tok.lstrip:
                k = a
                while k > 0 and is_whitespace(s[k - 1]):
                    k -= 1
                a = max(k, done)
            if tok.rstrip:
                while b < len(s) and is_whitespace(s[b]):
                    b += 1
            if done < a:
                out.append((s[done:a], None, origin and done == 0))
            out.append((s[a:b], tid, False))
            done = b
        if done < len(s):
            out.append((s[done:], None, origin and done == 0))
        return out


class AddedVocabulary:
    def __init__(self, entries: list[dict], model_vocab: dict[str, int], model_size: int, normalizer):
        """``model_size``: the model's ``get_vocab_size()`` (a Unigram counts
        every piece, repeated ones too)."""
        self.token_ids: dict[str, int] = {}
        self.id_tokens: dict[int, str] = {}
        specials: list[tuple[AddedToken, int]] = []
        plain: list[tuple[AddedToken, int]] = []
        for e in entries:
            tok = AddedToken(e["content"], e.get("single_word", False), e.get("lstrip", False),
                             e.get("rstrip", False), e.get("normalized", not e.get("special", False)),
                             e.get("special", False))
            if not tok.content or tok.content in self.token_ids:
                continue
            tid = model_vocab.get(tok.content)
            if tid is None:
                top, n = max(self.token_ids.values(), default=None), model_size
                tid = n if top is None else (top + 1 if top >= n or n == 0 else n)
            self.token_ids[tok.content] = tid
            self.id_tokens[tid] = tok.content
            (specials if tok.special else plain).append((tok, tid))
        ordered = specials + plain
        self.raw = _Matcher([(t.content, t, i) for t, i in ordered if not t.normalized])
        norm = (lambda s: normalizer.normalize(s)[0]) if normalizer is not None else (lambda s: s)
        self.normalized = _Matcher([(norm(t.content), t, i) for t, i in ordered if t.normalized])
