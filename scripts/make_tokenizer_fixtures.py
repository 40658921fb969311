"""Build the tokenizer fixtures of ``tests/data/tokenizers/`` (needs ``tokenizers``).

Writes four small ``tokenizer.json`` schemas that the port's reader
(``gliclass/c_tpu_torch/tokenizer/``) is held to, and ``expected_ids.json``:
the ids ``tokenizers`` gives for a fixed text list, with and without special
tokens, for every fixture. The committed files were made with ``tokenizers``
0.22.2. Each vocabulary is trained on text in the repository (the JAX
package's sources, which are frozen, and ``SURVEY.md``/``PAPER.md``), so a
rebuild reads nothing from site-packages. The Unigram trainer's result
varies from run to run, so a rebuild rewrites the fixtures and
``expected_ids.json`` together.

  a_bytelevel_bpe.json      byte-level BPE of ``tests/helpers.build_tiny_tokenizer``
                            and ``utils/realscale.py`` at 8,000 pieces, the
                            GLiClass specials, ``[CLS] $A [SEP]``
  b_deberta_unigram.json    DeBERTa-v3-shaped Unigram: ``Sequence[Strip,
                            Precompiled, Replace(" {2,}", " ")]``, ``Metaspace``
                            (``prepend_scheme="always"``), ``[CLS] $A [SEP]``,
                            ``[MASK]`` with ``lstrip``; ``<<LABEL>>``/``<<SEP>>``
                            as normalized, non-special added tokens
  c_llama_bpe_normalizer.json
  c_llama_bpe_metaspace.json
                            Sheared-LLaMA-shaped BPE with ``byte_fallback`` in
                            both published forms: normaliser ``Prepend("▁")`` +
                            ``Replace(" ", "▁")``, and ``Metaspace(prepend_scheme=
                            "first", split=false)``; ``<s> $A``
  d_qwen2_bytelevel_bpe.json
                            Qwen2-shaped byte-level BPE: ``NFC``, Qwen2's published
                            ``Split`` regex (isolated) + ``ByteLevel(use_regex=
                            false)``, no template

Run from the repository root: ``python scripts/make_tokenizer_fixtures.py``.
"""

from __future__ import annotations

import glob
import json
import os
import struct
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "tokenizers")
sys.path.insert(0, ROOT)

from gliclass.c_tpu_torch.prompting import pack_prompt  # noqa: E402

CANONICAL_TEXT = (
    "ONNX is an open-source format designed to enable the interoperability "
    "of AI models across various frameworks and tools."
)
CANONICAL_LABELS = ["format", "model", "tool", "cat"]
GOLDEN_TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "open source ai frameworks run fast on accelerators",
]
GOLDEN_LABELS = ["animal", "science", "sports"]

QWEN2_SPLIT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*"
    r"|\s*[\r\n]+|\s+(?!\S)|\s+"
)

# The DeBERTa-shaped charsmap: full-width letters and digits, ligatures,
# NBSP-like spaces, combining sequences composed, a key that is a prefix of
# another (half-width ka, ka + voiced mark), control characters turned into
# a space, zero-width characters deleted.
CHARSMAP = {
    **{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},
    **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},
    **{chr(0xFF10 + i): chr(0x30 + i) for i in range(10)},
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl", "ﬃ": "ffi", "ﬄ": "ffl",
    " ": " ", "　": " ", " ": " ", "\t": " ", "\n": " ", "\r": " ",
    "é": "é", "à": "à", "Å": "Å",
    "ｶ": "カ", "ｶﾞ": "ガ",
    "​": "", "­": "",
    "①": "1", "…": "...", "™": "TM", "½": "1⁄2", "Ⅻ": "XII",
}


def texts() -> list[str]:
    """The fixed text list of ``expected_ids.json``."""
    out = [CANONICAL_TEXT, *GOLDEN_TEXTS]
    for first in (True, False):
        out.append(pack_prompt(CANONICAL_TEXT, CANONICAL_LABELS, first))
        out.append(pack_prompt(GOLDEN_TEXTS[0], GOLDEN_LABELS, first))
        out.append(pack_prompt("Science Fiction  and   Travel", ["Sci-Fi", "travel guide", "Ünïcode"], first))
    out += [
        "", " ", "   ", "\t\t", "\n\n", " a  b   c ", "tab\there\nnew line\r\nwindows\r\n",
        "trailing   ", "  leading", " \t \n mixed   　 spaces",
        "1234567890 3.14159 2026-10-17 42nd 1,000,000", "٣٤٥ ²³ ⅕",
        "日本語のテキスト分類", "中文文本分类测试", "한국어 텍스트 분류", "ｶﾞｷﾞ ｶ ﾞ",
        "I love 🤖 and 👩‍💻! 🇺🇦🇺🇦 👍🏽 ❤️",
        "café naïve é́ Ａ́ Å à",
        "a\x00b\x01c\x1fd\x7fe bell\x07 and \x1c sep \x85 next",
        "Ｆｕｌｌ－ｗｉｄｔｈ ＡＢＣ １２３",
        "ﬁne ﬂow ﬃ x y　z ①②③ ™ ½ Ⅻ …",
        "zero​width soft­hyphen",
        "Don't you'll we've I'M SHE'S it'S they'RE",
        "<<LABEL>> spaced <<SEP>> tokens<<LABEL>><<LABEL>>x<<SEP>>",
        "[MASK] masked  [MASK]x [CLS] [SEP] <s> </s> <unk> <|endoftext|><|im_start|>",
        "email@example.com https://example.org/path?q=1&x=%20 $5.99 #tag @user",
        "Ǆemo ß ẞ İstanbul ΣΑΣ ſtraße",
        "def f(x):\n    return x ** 2  # comment\n\n\tpass",
    ]
    return out


def corpus() -> list[str]:
    """Non-blank lines of the JAX package's sources and of SURVEY.md and
    PAPER.md, less those that name a path of the machine they were written
    on."""
    files = sorted(glob.glob(os.path.join(ROOT, "gliclass", "c_tpu", "**", "*.py"), recursive=True))
    files += [os.path.join(ROOT, "SURVEY.md"), os.path.join(ROOT, "PAPER.md")]
    out = []
    for f in files:
        with open(f, encoding="utf-8") as fh:
            out.extend(line for line in fh.read().splitlines() if line.strip() and "/root" not in line)
    return out


def build_charsmap(mapping: dict[str, str]) -> bytes:
    """sentencepiece ``precompiled_charsmap``: a little-endian u32 byte count
    of the trie, the trie's u32 units (darts-clone, XOR addressing: a node's
    unit is ``label | offset << 10 | has_leaf << 8``; its children sit at
    ``base ^ label`` with ``base = pos ^ offset``; a key's value unit, bit 31
    set, at ``base ^ 0``), then the NUL-terminated replacements. A greedy
    breadth-first placement: every node gets a base of its own, and the array
    covers ``base ^ 255`` of every base so a lookup never leaves it."""
    blob, offsets = b"", {}
    for tgt in sorted(set(mapping.values())):
        offsets[tgt] = len(blob)
        blob += tgt.encode() + b"\0"
    root: dict = {}
    for src, tgt in mapping.items():
        node = root
        for b in src.encode():
            node = node.setdefault(b, {})
        node[None] = offsets[tgt]
    units: dict[int, int] = {}
    used, bases = {0}, set()
    queue = [(root, 0)]
    while queue:
        node, pos = queue.pop(0)
        labels = [lb for lb in node if lb is not None] + ([0] if None in node else [])
        base = 1
        while base in bases or any((base ^ lb) in used for lb in labels):
            base += 1
        bases.add(base)
        used.update(base ^ lb for lb in labels)
        units[pos] = units.get(pos, 0) | ((pos ^ base) << 10)
        if None in node:
            units[pos] |= 1 << 8
            units[base] = (1 << 31) | node[None]
        for lb in sorted(lb for lb in node if lb is not None):
            units[base ^ lb] = lb
            queue.append((node[lb], base ^ lb))
    size = (max(bases | set(units)) | 0xFF) + 1
    trie = struct.pack(f"<{size}I", *(units.get(i, 0) for i in range(size)))
    return struct.pack("<I", len(trie)) + trie + blob


def bytelevel_bpe(lines):
    from tokenizers import Tokenizer, models, pre_tokenizers, processors, trainers

    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "<<LABEL>>", "<<SEP>>"]
    tok = Tokenizer(models.BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(vocab_size=8000, special_tokens=specials,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False)
    tok.train_from_iterator(lines, trainer)
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", tok.token_to_id("[CLS]")), ("[SEP]", tok.token_to_id("[SEP]"))],
    )
    return tok


def deberta_unigram(lines):
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers
    from tokenizers import processors, trainers

    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.Sequence([
        normalizers.Strip(), normalizers.Precompiled(build_charsmap(CHARSMAP)),
        normalizers.Replace(Regex(" {2,}"), " "),
    ])
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    trainer = trainers.UnigramTrainer(vocab_size=4000, special_tokens=["[PAD]", "[CLS]", "[SEP]", "[UNK]"],
                                      unk_token="[UNK]", show_progress=False)
    tok.train_from_iterator(lines, trainer)
    tok.add_special_tokens([AddedToken("[MASK]", lstrip=True, rstrip=False, normalized=False, special=True)])
    tok.add_tokens([AddedToken("<<LABEL>>", normalized=True, special=False),
                    AddedToken("<<SEP>>", normalized=True, special=False)])
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", tok.token_to_id("[CLS]")), ("[SEP]", tok.token_to_id("[SEP]"))],
    )
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    return tok


def _trained_bpe(lines, pre_tokenizer, vocab_size, **trainer_kw):
    from tokenizers import Tokenizer, models, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizer
    tok.train_from_iterator(lines, trainers.BpeTrainer(vocab_size=vocab_size, show_progress=False, **trainer_kw))
    model = json.loads(tok.to_str())["model"]
    return model["vocab"], model["merges"]


def _added(i, content, special=True):
    return {"id": i, "content": content, "single_word": False, "lstrip": False, "rstrip": False,
            "normalized": False, "special": special}


def llama_bpe(lines):
    """Both forms of the Sheared-LLaMA schema over one vocabulary: <unk>, <s>,
    </s>, the 256 byte pieces, then the trained pieces."""
    from tokenizers import Tokenizer, pre_tokenizers

    trained, merges = _trained_bpe(
        lines, pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True), 3000,
        limit_alphabet=120)
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"<0x{b:02X}>": 3 + b for b in range(256)})
    for piece, _ in sorted(trained.items(), key=lambda kv: kv[1]):
        vocab.setdefault(piece, len(vocab))
    n = len(vocab)
    added = [_added(0, "<unk>"), _added(1, "<s>"), _added(2, "</s>"),
             _added(n, "<<LABEL>>"), _added(n + 1, "<<SEP>>")]
    model = {"type": "BPE", "dropout": None, "unk_token": "<unk>", "continuing_subword_prefix": None,
             "end_of_word_suffix": None, "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
             "vocab": vocab, "merges": merges}
    post = {"type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}}, {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}}
    legacy = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        "pre_tokenizer": None, "post_processor": post,
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}, {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": model,
    }
    metaspace = dict(legacy, normalizer=None,
                     pre_tokenizer={"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                                    "split": False},
                     decoder={"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": False})
    return (Tokenizer.from_str(json.dumps(legacy, ensure_ascii=False)),
            Tokenizer.from_str(json.dumps(metaspace, ensure_ascii=False)))


def qwen2_bpe(lines):
    from tokenizers import Regex, Tokenizer, pre_tokenizers

    pre = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(QWEN2_SPLIT), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=False, use_regex=False),
    ])
    vocab, merges = _trained_bpe(lines, pre, 4000, initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    n = len(vocab)
    added = [_added(n + i, c) for i, c in enumerate(["<|endoftext|>", "<|im_start|>", "<|im_end|>"])]
    added += [_added(n + 3, "<<LABEL>>"), _added(n + 4, "<<SEP>>")]
    bytelevel = {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": False, "use_regex": False}
    spec = {
        "version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
        "normalizer": {"type": "NFC"},
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": QWEN2_SPLIT}, "behavior": "Isolated", "invert": False},
            bytelevel]},
        "post_processor": bytelevel, "decoder": bytelevel,
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": "",
                  "end_of_word_suffix": "", "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }
    return Tokenizer.from_str(json.dumps(spec, ensure_ascii=False))


def main() -> int:
    import tokenizers

    lines = corpus()
    llama_legacy, llama_metaspace = llama_bpe(lines)
    fixtures = {
        "a_bytelevel_bpe.json": bytelevel_bpe(lines),
        "b_deberta_unigram.json": deberta_unigram(lines),
        "c_llama_bpe_normalizer.json": llama_legacy,
        "c_llama_bpe_metaspace.json": llama_metaspace,
        "d_qwen2_bytelevel_bpe.json": qwen2_bpe(lines),
    }
    os.makedirs(OUT, exist_ok=True)
    sample = texts()
    expected = {"tokenizers": tokenizers.__version__, "texts": sample, "ids": {}}
    for name, tok in fixtures.items():
        tok.save(os.path.join(OUT, name), pretty=False)
        expected["ids"][name] = {
            "with": [e.ids for e in tok.encode_batch(sample, add_special_tokens=True)],
            "without": [e.ids for e in tok.encode_batch(sample, add_special_tokens=False)],
        }
    with open(os.path.join(OUT, "expected_ids.json"), "w", encoding="utf-8") as f:
        json.dump(expected, f, ensure_ascii=False, separators=(",", ":"))
        f.write("\n")
    for name in sorted(os.listdir(OUT)):
        print(f"{name}: {os.path.getsize(os.path.join(OUT, name))} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
