"""Post-processors of ``tokenizer.json``: the special tokens around one
sequence (the ``single`` template; the port never encodes pairs)."""

from __future__ import annotations


class PostProcessor:
    """No special tokens (also ``ByteLevel``, which changes offsets only)."""

    def added(self) -> int:
        """Special tokens the single template adds."""
        return 0

    def process(self, ids: list[int], add_special_tokens: bool) -> list[int]:
        return ids


class Affix(PostProcessor):
    """Fixed ids before and after the sequence: ``TemplateProcessing``'s
    single template, ``BertProcessing`` and ``RobertaProcessing``."""

    def __init__(self, head: list[int], tail: list[int]):
        self.head, self.tail = head, tail

    def added(self) -> int:
        return len(self.head) + len(self.tail)

    def process(self, ids, add_special_tokens):
        return self.head + ids + self.tail if add_special_tokens else ids


class Sequence(PostProcessor):
    def __init__(self, items: list[PostProcessor]):
        self.items = items

    def added(self) -> int:
        return sum(p.added() for p in self.items)

    def process(self, ids, add_special_tokens):
        for p in self.items:
            ids = p.process(ids, add_special_tokens)
        return ids


def _template(spec: dict, where: str) -> Affix:
    single = spec["single"]
    specials = spec.get("special_tokens", {})
    head: list[int] = []
    tail: list[int] = []
    seen = False
    for piece in single:
        if "Sequence" in piece:
            if piece["Sequence"]["id"] != "A" or seen:
                raise NotImplementedError(f"TemplateProcessing single template {single} in {where}")
            seen = True
        else:
            (head if not seen else tail).extend(specials[piece["SpecialToken"]["id"]]["ids"])
    if not seen:
        raise NotImplementedError(f"TemplateProcessing single template without $A in {where}")
    return Affix(head, tail)


def from_spec(spec: dict | None, where: str) -> PostProcessor:
    if spec is None:
        return PostProcessor()
    kind = spec.get("type")
    if kind == "TemplateProcessing":
        return _template(spec, where)
    if kind in ("BertProcessing", "RobertaProcessing"):
        return Affix([spec["cls"][1]], [spec["sep"][1]])
    if kind == "ByteLevel":
        return PostProcessor()
    if kind == "Sequence":
        return Sequence([from_spec(p, where) for p in spec["processors"]])
    raise NotImplementedError(f"post_processor type {kind!r} in {where} is not supported by the port's reader")
