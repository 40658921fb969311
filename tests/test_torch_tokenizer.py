"""The port's ``tokenizer.json`` reader (``gliclass/c_tpu_torch/tokenizer/``)
against ``tokenizers`` and the JAX package, on CPU.

The fixtures of ``tests/data/tokenizers/`` (``scripts/make_tokenizer_fixtures.py``)
are the four tokenizer schemas the supported models use: a byte-level BPE
(``a``), a DeBERTa-v3-shaped Unigram with a precompiled charsmap (``b``), a
Sheared-LLaMA-shaped BPE with byte fallback in both published forms (``c``)
and a Qwen2-shaped byte-level BPE (``d``). Ids must be equal, element for
element: on the fixed text list of ``expected_ids.json``, through
``PromptTokenizer`` and ``AffixEncoder``, on hypothesis texts, and through
``classify_job`` from bundles the JAX converter wrote.

Hypothesis texts leave out the code points that Python's Unicode database
(15.0 here) leaves unassigned (category Cn): ``tokenizers``' Oniguruma knows
later versions, where some of them are letters, and Python cannot say what
they are. Nothing else is left out.
"""

import json
import os
import random
import subprocess
import sys
import unicodedata

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import models as hf_models
from tokenizers import normalizers as hf_normalizers
from tokenizers import pre_tokenizers as hf_pre
from tokenizers import trainers as hf_trainers

from gliclass.c_tpu import config as jcfg
from gliclass.c_tpu.tokenization import AffixEncoder as JAffix
from gliclass.c_tpu.tokenization import PromptTokenizer as JTok
from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.prompting import pack_prompt, pack_prompts
from gliclass.c_tpu_torch.tokenization import AffixEncoder as TAffix
from gliclass.c_tpu_torch.tokenization import PromptTokenizer as TTok
from gliclass.c_tpu_torch.tokenizer import Tokenizer
from gliclass.c_tpu_torch.tokenizer.normalizers import UNKNOWN_TO_NORMALIZATION, Precompiled

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data", "tokenizers")
FIXTURES = ["a_bytelevel_bpe.json", "b_deberta_unigram.json", "c_llama_bpe_normalizer.json",
            "c_llama_bpe_metaspace.json", "d_qwen2_bytelevel_bpe.json"]
with open(os.path.join(DATA, "expected_ids.json"), encoding="utf-8") as _f:
    EXPECTED = json.load(_f)
TEXTS = EXPECTED["texts"]
LABELS = ["format", "model", "tool", "cat", "Science Fiction", "ünïcode"]

# Pieces hypothesis mixes into its texts, so that the added tokens, the
# charsmap's keys and the pre-tokenisers' edge cases come up often.
SNIPPETS = ["<<LABEL>>", "<<SEP>>", "[MASK]", "[CLS]", "<s>", "</s>", "<|endoftext|>", " ", "  ", "\n",
            "\r\n", "\t", "'s", "'LL", "ｶ", "ﾞ", "Ａ", "ﬁ", "́", "‍", "🇺", "👍", "\U0001F3FD", "é",
            " ", "​", "­", "한", "ᄀ", "ᅡ", "ᆨ", "the", " fox", "123", "4.5", "don't", "日本語"]
TEXT = st.lists(st.one_of(st.text(st.characters(exclude_categories=("Cs", "Cn")), max_size=12),
                          st.sampled_from(SNIPPETS)), max_size=10).map("".join)


def path(name: str) -> str:
    return os.path.join(DATA, name)


def random_texts(seed: int, n: int) -> list[str]:
    """Seeded texts over every assigned code point (as the hypothesis
    strategy), the snippets and words."""
    rng = random.Random(seed)

    def cp():
        while True:
            r = rng.random()
            c = chr(rng.randint(0x20, 0x7E) if r < 0.4 else rng.randint(0, 0x20) if r < 0.5
                    else rng.randint(0x80, 0x3000) if r < 0.7 else rng.randint(0x3000, 0xFFFF) if r < 0.85
                    else rng.randint(0x10000, 0x10FFFF))
            if unicodedata.category(c) not in ("Cs", "Cn"):
                return c

    def text():
        parts = []
        for _ in range(rng.randint(0, 12)):
            r = rng.random()
            parts.append(rng.choice(SNIPPETS) if r < 0.4 else "".join(cp() for _ in range(rng.randint(1, 6))))
        return "".join(parts)

    return [text() for _ in range(n)]


@pytest.fixture(scope="module")
def tokenizers_():
    """name -> (JAX PromptTokenizer (tokenizers), the port's PromptTokenizer)."""
    return {name: (JTok.from_file(path(name)), TTok.from_file(path(name))) for name in FIXTURES}


# ---------------------------------------------------------------------------
# The fixtures
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FIXTURES)
def test_expected_ids_are_what_tokenizers_gives(name):
    hf = HFTokenizer.from_file(path(name))
    for mode, add in (("with", True), ("without", False)):
        assert [e.ids for e in hf.encode_batch(TEXTS, add_special_tokens=add)] == EXPECTED["ids"][name][mode]


@pytest.mark.parametrize("name", FIXTURES)
def test_port_gives_the_expected_ids(name):
    """What the card checks (chip_smoke.py phase 15)."""
    tok = Tokenizer.from_file(path(name))
    for mode, add in (("with", True), ("without", False)):
        assert [e.ids for e in tok.encode_batch(TEXTS, add_special_tokens=add)] == EXPECTED["ids"][name][mode]


@pytest.mark.parametrize("name", FIXTURES)
def test_fixed_list_equals_the_jax_tokenizer(name, tokenizers_):
    j, t = tokenizers_[name]
    for text in TEXTS:
        for add in (True, False):
            assert t._tok.encode(text, add_special_tokens=add).ids == j._tok.encode(text, add_special_tokens=add).ids
    assert (t.pad_token_id, t.label_token_id, t.sep_token_id) == (j.pad_token_id, j.label_token_id, j.sep_token_id)
    hf = HFTokenizer.from_file(path(name))
    tok = t._tok
    assert tok.get_vocab_size() == hf.get_vocab_size()
    assert tok.get_vocab_size(with_added_tokens=False) == hf.get_vocab_size(with_added_tokens=False)
    for i in list(range(0, hf.get_vocab_size(), 97)) + [hf.get_vocab_size() - 1, hf.get_vocab_size() + 5]:
        assert tok.id_to_token(i) == hf.id_to_token(i)
        s = hf.id_to_token(i)
        if s is not None:
            assert tok.token_to_id(s) == hf.token_to_id(s)
    assert tok.padding == hf.padding


@pytest.mark.parametrize("name", FIXTURES)
def test_encode_batch_at_a_bucket_equals_jax(name, tokenizers_):
    j, t = tokenizers_[name]
    prompts = pack_prompts(TEXTS, [LABELS], True, True) + pack_prompts(TEXTS, [LABELS], True, False)
    for max_length, pad_to in ((24, 32), (512, 512), (40, None)):
        a, b = j.encode_batch(prompts, max_length, pad_to), t.encode_batch(prompts, max_length, pad_to)
        for f in ("input_ids", "attention_mask", "lengths"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)


@pytest.mark.parametrize("name", FIXTURES)
def test_encode_batch_parallel_over_chunks_equals_jax(name, tokenizers_):
    j, t = tokenizers_[name]
    prompts = pack_prompts(TEXTS, [LABELS[:3]], True, False)
    for pad_to in (None, 128):
        a = j.encode_batch_parallel(prompts, 128, pad_to, chunk_size=7, workers=3)
        b = t.encode_batch_parallel(prompts, 128, pad_to, chunk_size=7, workers=3)
        for f in ("input_ids", "attention_mask", "lengths"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)


@pytest.mark.parametrize("name", FIXTURES)
@settings(max_examples=120, derandomize=True, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(text=TEXT)
def test_hypothesis_texts_equal_the_jax_tokenizer(name, text, tokenizers_):
    j, t = tokenizers_[name]
    for add in (True, False):
        assert t._tok.encode(text, add_special_tokens=add).ids == j._tok.encode(text, add_special_tokens=add).ids
    prompt = pack_prompt(text, LABELS[:2], True)
    assert t._tok.encode(prompt).ids == j._tok.encode(prompt).ids


@pytest.mark.parametrize("prompt_first", [True, False])
@pytest.mark.parametrize("name", FIXTURES)
def test_affix_encoder_equals_jax(name, prompt_first, tokenizers_):
    j, t = tokenizers_[name]
    texts = [x for x in TEXTS if x] + ["probe boundary text"]
    for labels in (LABELS, ["a"], ["Science Fiction", "travel guide"]):
        ja = JAffix.for_labels(j, labels, prompt_first, 64, sample_text=texts[0])
        ta = TAffix.for_labels(t, labels, prompt_first, 64, sample_text=texts[0])
        assert ta.exact == ja.exact
        prompts = pack_prompts(texts, [labels], True, prompt_first)
        a = ja.encode_batch(texts, 64, 64, fallback_prompts=prompts)
        b = ta.encode_batch(texts, 64, 64, fallback_prompts=prompts)
        np.testing.assert_array_equal(b.input_ids, a.input_ids)
        np.testing.assert_array_equal(b.lengths, a.lengths)


@pytest.mark.parametrize("name", FIXTURES + ["tiny"])
def test_to_str_equals_tokenizers(name, tiny_tokenizer_file):
    p = tiny_tokenizer_file if name == "tiny" else path(name)
    assert Tokenizer.from_file(p).to_str() == HFTokenizer.from_file(p).to_str()


def test_tiny_tokenizer_equals_tokenizers(tiny_tokenizer_file):
    """The other tests' tokenizer (``tests/helpers.build_tiny_tokenizer``)."""
    hf, tok = HFTokenizer.from_file(tiny_tokenizer_file), Tokenizer.from_file(tiny_tokenizer_file)
    texts = TEXTS + random_texts(5, 200)
    for add in (True, False):
        assert [e.ids for e in tok.encode_batch(texts, add)] == [
            e.ids for e in hf.encode_batch(texts, add_special_tokens=add)]


# ---------------------------------------------------------------------------
# Components the fixtures do not use, each against tokenizers
# ---------------------------------------------------------------------------
def _spec(name: str) -> dict:
    with open(path(name), encoding="utf-8") as f:
        return json.load(f)


def _bl(add_prefix_space=False, use_regex=False) -> dict:
    return {"type": "ByteLevel", "add_prefix_space": add_prefix_space, "trim_offsets": True, "use_regex": use_regex}


def _split(pattern, behavior, invert=False) -> dict:
    return {"type": "Split", "pattern": pattern, "behavior": behavior, "invert": invert}


def _added(content, **kw) -> dict:
    d = {"id": 0, "content": content, "single_word": False, "lstrip": False, "rstrip": False,
         "normalized": False, "special": False}
    d.update(kw)
    return d


def _variant_roberta_padding():
    s = _spec("a_bytelevel_bpe.json")
    s["pre_tokenizer"] = _bl(add_prefix_space=True, use_regex=True)
    s["post_processor"] = {"type": "RobertaProcessing", "sep": ["[SEP]", 3], "cls": ["[CLS]", 2],
                           "trim_offsets": True, "add_prefix_space": True}
    s["padding"] = {"strategy": "BatchLongest", "direction": "Left", "pad_to_multiple_of": 8, "pad_id": 0,
                    "pad_type_id": 0, "pad_token": "[PAD]"}
    s["truncation"] = {"direction": "Left", "max_length": 20, "strategy": "LongestFirst", "stride": 0}
    return s


def _variant_fixed_padding():
    s = _spec("a_bytelevel_bpe.json")
    s["post_processor"] = {"type": "Sequence", "processors": [_bl(), s["post_processor"]]}
    s["padding"] = {"strategy": {"Fixed": 48}, "direction": "Right", "pad_to_multiple_of": None, "pad_id": 5,
                    "pad_type_id": 0, "pad_token": "<<SEP>>"}
    s["truncation"] = {"direction": "Right", "max_length": 30, "strategy": "OnlyFirst", "stride": 2}
    return s


def _variant_normalizers():
    s = _spec("a_bytelevel_bpe.json")
    s["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "NFKD"}, {"type": "Lowercase"}, {"type": "Replace", "pattern": {"String": "  "}, "content": " "},
        {"type": "Replace", "pattern": {"Regex": r"\d+"}, "content": "#"},
        {"type": "Strip", "strip_left": True, "strip_right": False}, {"type": "Prepend", "prepend": "~"},
        {"type": "NFC"}]}
    s["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
        _split({"String": ","}, "Removed"), _split({"Regex": r"\s+"}, "MergedWithPrevious"),
        {"type": "Punctuation", "behavior": "Contiguous"}, {"type": "Digits", "individual_digits": True},
        _bl()]}
    return s


def _variant_split(behavior, invert):
    def make():
        s = _spec("a_bytelevel_bpe.json")
        s["normalizer"] = {"type": "NFD"}
        s["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [
            _split({"Regex": r"[aeiou]|\p{P}+|\s"}, behavior, invert), _bl()]}
        return s
    return make


def _variant_wordlevel():
    words = sorted({w for t in TEXTS for w in t.lower().split()})
    vocab = {"[UNK]": 0, "[CLS]": 1, "[SEP]": 2, "[PAD]": 3}
    vocab.update({w: i + 4 for i, w in enumerate(words)})
    return {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [_added(t, id=i, special=True) for t, i in vocab.items() if i < 4]
            + [_added("ab", single_word=True), _added("[X]", lstrip=True, rstrip=True, special=True),
               _added("HeLLo", normalized=True), _added("the")],
            "normalizer": {"type": "Sequence", "normalizers": [{"type": "NFKC"}, {"type": "Lowercase"}]},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Whitespace"}, {"type": "Digits", "individual_digits": False}]},
            "post_processor": {"type": "BertProcessing", "sep": ["[SEP]", 2], "cls": ["[CLS]", 1]},
            "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
            "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "[UNK]"}}


def _variant_whitespace_split():
    s = _variant_wordlevel()
    s["pre_tokenizer"] = {"type": "WhitespaceSplit"}
    s["normalizer"] = {"type": "Lowercase"}
    return s


def _variant_metaspace_first_strip():
    s = _spec("c_llama_bpe_metaspace.json")
    s["normalizer"] = {"type": "Sequence", "normalizers": [
        {"type": "Strip", "strip_left": True, "strip_right": True},
        {"type": "Replace", "pattern": {"String": "\t"}, "content": " "}]}
    return s


def _variant_metaspace_first_replace():
    s = _spec("c_llama_bpe_metaspace.json")
    s["normalizer"] = {"type": "Replace", "pattern": {"Regex": " {2,}|\n"}, "content": " "}
    s["pre_tokenizer"]["split"] = True
    return s


def _variant_unigram_byte_fallback():
    s = _spec("b_deberta_unigram.json")
    s["model"]["byte_fallback"] = True
    s["model"]["vocab"] += [[f"<0x{b:02X}>", -20.0] for b in range(256)]
    s["pre_tokenizer"]["prepend_scheme"] = "never"
    return s


def _variant_llama_unk():
    s = _spec("c_llama_bpe_normalizer.json")
    s["model"]["byte_fallback"] = False
    return s


def _variant_llama_unk_unfused():
    s = _variant_llama_unk()
    s["model"]["fuse_unk"] = False
    return s


def _variant_qwen_ignore_merges_nfkc():
    s = _spec("d_qwen2_bytelevel_bpe.json")
    s["model"]["ignore_merges"] = True
    s["normalizer"] = {"type": "NFKC"}
    return s


def _variant_legacy_merges():
    s = _spec("a_bytelevel_bpe.json")
    s["model"]["merges"] = [" ".join(m) for m in s["model"]["merges"]]
    return s


def _variant_prefix_suffix():
    hf = HFTokenizer(hf_models.BPE(unk_token="[UNK]", continuing_subword_prefix="##", end_of_word_suffix="</w>"))
    hf.normalizer = hf_normalizers.Lowercase()
    hf.pre_tokenizer = hf_pre.Whitespace()
    trainer = hf_trainers.BpeTrainer(vocab_size=600, special_tokens=["[UNK]"], continuing_subword_prefix="##",
                                     end_of_word_suffix="</w>", limit_alphabet=60, show_progress=False)
    hf.train_from_iterator([t for t in TEXTS if t] * 3, trainer)
    return json.loads(hf.to_str())


VARIANTS = {
    "roberta_left_padding_truncation": _variant_roberta_padding,
    "fixed_padding_sequence_post": _variant_fixed_padding,
    "normalizers_and_splits": _variant_normalizers,
    **{f"split_{b}_{inv}": _variant_split(b, inv) for b, inv in (
        ("Removed", False), ("Isolated", True), ("MergedWithPrevious", False), ("MergedWithNext", True),
        ("Contiguous", False))},
    "wordlevel_bert_added_tokens": _variant_wordlevel,
    "wordlevel_whitespace_split": _variant_whitespace_split,
    "metaspace_first_after_strip": _variant_metaspace_first_strip,
    "metaspace_first_after_replace": _variant_metaspace_first_replace,
    "unigram_byte_fallback": _variant_unigram_byte_fallback,
    "bpe_unk_fused": _variant_llama_unk,
    "bpe_unk_unfused": _variant_llama_unk_unfused,
    "bpe_ignore_merges_nfkc": _variant_qwen_ignore_merges_nfkc,
    "bpe_legacy_merges": _variant_legacy_merges,
    "bpe_prefix_suffix": _variant_prefix_suffix,
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_equals_tokenizers(variant):
    """Ids, padding and ``to_str`` of the port's reader and ``tokenizers`` on
    a schema that changes one fixture: the fixed list and 300 seeded texts,
    one by one and as a batch, with and without special tokens."""
    hf = HFTokenizer.from_str(json.dumps(VARIANTS[variant](), ensure_ascii=False))
    canonical = hf.to_str()
    tok = Tokenizer.from_str(canonical)
    assert tok.to_str() == canonical
    texts = TEXTS + random_texts(sum(map(ord, variant)), 300)
    for add in (True, False):
        assert [e.ids for e in tok.encode_batch(texts, add)] == [
            e.ids for e in hf.encode_batch(texts, add_special_tokens=add)]
        assert [tok.encode(t, add).ids for t in texts[::7]] == [
            hf.encode(t, add_special_tokens=add).ids for t in texts[::7]]
    assert tok.padding == hf.padding


def _charsmap(mapping: dict) -> bytes:
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from make_tokenizer_fixtures import build_charsmap

    return build_charsmap(mapping)


# Keys that begin grapheme clusters of every kind, so that a wrong cluster
# boundary changes what the whole-cluster lookup replaces.
GRAPHEME_KEYS = {"a": "A", "e": "E", "\r": "<CR>", "\n": "<LF>", "🇺": "U", "👍": "+", "한": "H", "ᄀ": "G",
                 "؀": "P", "क": "K", "ก": "T", "❤": "<3", "Ａ": "A", "ｶ": "カ", "ｶﾞ": "ガ",
                 "​": "", "x́": "X"}


@settings(max_examples=300, derandomize=True, deadline=None, database=None)
@given(text=st.lists(st.one_of(st.text(st.characters(exclude_categories=("Cs", "Cn")), max_size=6),
                               st.sampled_from(list(GRAPHEME_KEYS) + ["́", "ำ", "‍", "️",
                                                                      "\U0001F3FD", "ᅡ", "ᆨ", "ि", "्",
                                                                      "ﾞ", "ः", "\U000E0061"])),
                     max_size=12).map("".join))
def test_precompiled_graphemes_equal_tokenizers(text):
    """The charsmap normaliser against ``tokenizers.normalizers.Precompiled``
    on a map whose keys begin clusters of each kind: the cluster boundaries
    decide what is replaced."""
    blob = _charsmap(GRAPHEME_KEYS)
    want = hf_normalizers.Precompiled(blob).normalize_str(text)
    assert Precompiled(blob).normalize(text)[0] == want


def test_unknown_to_normalization_is_what_tokenizers_does_not_know():
    """Every code point whose NFC/NFD/NFKC/NFKD in ``tokenizers`` differs from
    Python's, alone or beside marks of each combining class, is in the
    reader's table; and the table's code points all differ (or compose, in
    Python only, into one that does)."""
    forms = {f: getattr(hf_normalizers, f)() for f in ("NFC", "NFD", "NFKC", "NFKD")}
    probes = ["̴", "̖", "́", "ͅ"]

    def differs(c):
        tests = [c] + [x for p in probes for x in (c + p, p + c, "a" + c + p, "a" + p + c)]
        return any(n.normalize_str(s) != unicodedata.normalize(f, s) for f, n in forms.items() for s in tests)

    table = {cp for a, b in UNKNOWN_TO_NORMALIZATION for cp in range(a, b + 1)}
    found = {cp for cp in range(0x110000) if unicodedata.category(chr(cp)) not in ("Cs", "Cn")
             and (unicodedata.combining(chr(cp)) or unicodedata.decomposition(chr(cp))) and differs(chr(cp))}
    assert found <= table
    composed_only = table - found
    assert composed_only == {0x11930, 0x11935}
    assert forms["NFC"].normalize_str("\U00011935\U00011930") == "\U00011935\U00011930"
    assert unicodedata.normalize("NFC", "\U00011935\U00011930") == "\U00011938"


# ---------------------------------------------------------------------------
# What the reader refuses
# ---------------------------------------------------------------------------
def _refused(case):
    s = _spec("a_bytelevel_bpe.json")
    if case == "WordPiece":
        s["model"] = {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
                      "max_input_chars_per_word": 100, "vocab": s["model"]["vocab"]}
    elif case == "BertPreTokenizer":
        s["pre_tokenizer"] = {"type": "BertPreTokenizer"}
    elif case == "BertNormalizer":
        s["normalizer"] = {"type": "BertNormalizer", "clean_text": True, "handle_chinese_chars": True,
                           "strip_accents": None, "lowercase": True}
    elif case == "StripAccents":
        s["normalizer"] = {"type": "Sequence", "normalizers": [{"type": "NFD"}, {"type": "StripAccents"}]}
    elif case == "UnicodeScripts":
        s["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [{"type": "UnicodeScripts"}, _bl()]}
    elif case == "dropout":
        s["model"]["dropout"] = 0.1
    elif case == "OnlySecond":
        s["truncation"] = {"direction": "Right", "max_length": 8, "strategy": "OnlySecond", "stride": 0}
    elif case == "\\b":
        s["pre_tokenizer"] = {"type": "Sequence", "pretokenizers": [_split({"Regex": r"\b\w+\b"}, "Isolated"), _bl()]}
    elif case == "Han":
        s["normalizer"] = {"type": "Replace", "pattern": {"Regex": r"\p{Han}+"}, "content": "x"}
    return s


@pytest.mark.parametrize("case", ["WordPiece", "BertPreTokenizer", "BertNormalizer", "StripAccents",
                                  "UnicodeScripts", "dropout", "OnlySecond", "\\b", "Han"])
def test_unsupported_component_raises_at_load_naming_it(case, tmp_path):
    p = tmp_path / "tokenizer.json"
    p.write_text(json.dumps(_refused(case)), encoding="utf-8")
    with pytest.raises(NotImplementedError) as e:
        Tokenizer.from_file(str(p))
    assert case in str(e.value) and str(p) in str(e.value)
    with pytest.raises(NotImplementedError):
        TTok.from_file(str(p))


def test_unknown_decoder_is_ignored():
    s = _spec("a_bytelevel_bpe.json")
    s["decoder"] = {"type": "SomethingNew", "x": 1}
    tok = Tokenizer.from_str(json.dumps(s))
    assert tok.encode(TEXTS[0]).ids == EXPECTED["ids"]["a_bytelevel_bpe.json"]["with"][0]


# ---------------------------------------------------------------------------
# The slice: bundles the JAX converter wrote, through the port's pipeline
# ---------------------------------------------------------------------------
BACKBONES = {
    "deberta": dict(model_type="deberta-v2", hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=64, max_position_embeddings=128, position_buckets=16,
                    norm_rel_ebd="layer_norm", share_att_key=True, position_biased_input=False),
    "qwen2": dict(model_type="qwen2", hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=64, max_position_embeddings=128, attention_bias=True,
                  hidden_act="silu", relative_attention=False),
    "llama": dict(model_type="llama", hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=64, max_position_embeddings=128, hidden_act="silu",
                  relative_attention=False),
}
# fixture -> backbone, prompt_first
BUNDLES = {
    "a_bytelevel_bpe.json": ("deberta", True),
    "b_deberta_unigram.json": ("deberta", True),
    "c_llama_bpe_metaspace.json": ("llama", False),
    "c_llama_bpe_normalizer.json": ("llama", False),
    "d_qwen2_bytelevel_bpe.json": ("qwen2", False),
}
JOBS = [
    {"texts": [TEXTS[0], "the quick brown fox jumps over the lazy dog", "Ｆｕｌｌ－ｗｉｄｔｈ café ﬁne",
               "日本語のテキスト分類 👍🏽", "  leading\tand trailing  ", ""],
     "labels": [["format", "Science Fiction", "animal", "ünïcode"]], "same_labels": True,
     "classification_type": "multi-label"},
    {"texts": ["why are you running", "support ukraine 🇺🇦", "Don't you'll we've"],
     "labels": [["question", "statement"], ["call to action", "sports", "politics"], ["grammar"]],
     "same_labels": False, "classification_type": "single-label"},
]
RT = dict(batch_size=4, max_length=64, compute_dtype="float32", seq_buckets=(16, 32, 64),
          label_buckets=(2, 4, 8))


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """fixture name -> a tiny fp32 + INT8 bundle the JAX converter wrote with
    that tokenizer (the vocabulary sized to it)."""
    from gliclass.c_tpu.convert.convert import export_bundle
    from gliclass.c_tpu.convert.torch_ref import build_torch_gliclass

    out = {}
    for name, (kind, prompt_first) in BUNDLES.items():
        tok = JTok.from_file(path(name))
        bb = jcfg.BackboneConfig(vocab_size=tok._tok.get_vocab_size(), **BACKBONES[kind])
        cfg = jcfg.GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                                  text_token_index=tok.sep_token_id, prompt_first=prompt_first, backbone=bb)
        torch.manual_seed(0)
        p = str(tmp_path_factory.mktemp("tokenizer_bundle") / "b")
        export_bundle(build_torch_gliclass(cfg), cfg, tok, p, quantize=True)
        out[name] = p
    return out


@pytest.mark.parametrize("quant_mode", ["none", "int8"])
@pytest.mark.parametrize("name", list(BUNDLES))
def test_classify_job_from_jax_bundle_matches_jax(name, quant_mode, bundles):
    """Decisions equal and fp32 probabilities within 1e-5, both jobs; the
    bundle's tokenizer.json is read by the port's reader."""
    from gliclass.c_tpu.config import RuntimeConfig as JRuntime
    from gliclass.c_tpu.data import parse_job as j_parse_job
    from gliclass.c_tpu.pipeline import ZeroShotClassificationPipeline as JPipeline
    from gliclass.c_tpu_torch.data import parse_job
    from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline
    from gliclass.c_tpu_torch.tokenizer import Tokenizer as PortTokenizer

    jpipe = JPipeline.from_bundle(bundles[name], JRuntime(quant_mode=quant_mode, **RT))
    tpipe = ZeroShotClassificationPipeline.from_bundle(
        bundles[name], tcfg.RuntimeConfig(quant_mode=quant_mode, **RT), device="cpu")
    assert isinstance(tpipe.tokenizer._tok, PortTokenizer)
    for job in JOBS:
        jout, tout = jpipe.classify_job(j_parse_job(job)), tpipe.classify_job(parse_job(job))
        assert tout.failures == [] and jout.failures == []
        np.testing.assert_allclose(tout.probs, jout.probs, atol=1e-5, rtol=1e-5)
        assert [[(d["label"], d["index"]) for d in a["decisions"]] for a in tout.to_json()] == [
            [(d["label"], d["index"]) for d in b["decisions"]] for b in jout.to_json()]


def test_bundle_path_imports_no_tokenizers_transformers_safetensors_regex_or_jax(bundles):
    """``pipeline.from_bundle`` and one ``classify_job`` on the CPU, in a fresh
    interpreter: none of those modules is loaded."""
    code = (
        "import json, sys\n"
        "from gliclass.c_tpu_torch.config import RuntimeConfig\n"
        "from gliclass.c_tpu_torch.data import parse_job\n"
        "from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline\n"
        f"p = ZeroShotClassificationPipeline.from_bundle({bundles['b_deberta_unigram.json']!r}, "
        f"RuntimeConfig(**{RT!r}), device='cpu')\n"
        f"out = p.classify_job(parse_job({JOBS[0]!r}))\n"
        "assert out.failures == [] and len(out.probs) == 6\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('tokenizers', 'transformers', 'safetensors', 'regex', 'jax', 'jaxlib')\n"
        "       or k == 'gliclass.c_tpu' or k.startswith('gliclass.c_tpu.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
