"""The port's byte-level BPE trainer and real-scale artifacts against
``tokenizers`` and the JAX package's ``utils/realscale.py``.

* ``tokenizer.trainers`` against ``tokenizers``' ``BpeTrainer``: the
  ``to_str()`` of the trained tokenizer byte-equal, on hypothesis corpora
  and on a fixed case for each behaviour of the Rust trainer the port
  reproduces;
* ``build_realscale_tokenizer`` of both packages over the same local corpus;
* ``ensure_realscale_bundle``'s variant table against the JAX module's, with
  the heavy steps of both replaced by recorders;
* a tiny bundle built with the port's path (``build_realscale_tokenizer``,
  ``write_bundle``), read by the JAX package, whose fp32 logits reproduce its
  goldens, and by the port, whose decisions are the JAX package's.

``tokenizers`` and the JAX package are imported on the test side only.
"""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import Tokenizer as HFTokenizer
from tokenizers import models as hf_models
from tokenizers import pre_tokenizers as hf_pre
from tokenizers import processors as hf_processors
from tokenizers import trainers as hf_trainers

from gliclass.c_tpu.utils import realscale as jrs
from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.tokenizer import Tokenizer, trainers
from gliclass.c_tpu_torch.utils import realscale as trs

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "<<LABEL>>", "<<SEP>>"]


def hf_train(texts, vocab_size, specials=SPECIALS, alphabet=True, template=False) -> str:
    tok = HFTokenizer(hf_models.BPE(unk_token="[UNK]"))
    tok.pre_tokenizer = hf_pre.ByteLevel(add_prefix_space=False)
    trainer = hf_trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=specials, show_progress=False,
                                     initial_alphabet=hf_pre.ByteLevel.alphabet() if alphabet else [])
    tok.train_from_iterator(texts, trainer)
    if template:
        tok.post_processor = hf_processors.TemplateProcessing(
            single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B [SEP]",
            special_tokens=[("[CLS]", tok.token_to_id("[CLS]")), ("[SEP]", tok.token_to_id("[SEP]"))])
    return tok.to_str()


def port_train(texts, vocab_size, specials=SPECIALS, alphabet=True, template=False):
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, special_tokens=specials, show_progress=False,
                                  initial_alphabet=trainers.byte_level_alphabet() if alphabet else [])
    tok = trainers.train_from_iterator(texts, trainer, unk_token="[UNK]")
    if template:
        tok = trainers.cls_sep_template(tok)
    return tok, trainer.report


def assert_same(texts, vocab_size, **kw):
    tok, report = port_train(texts, vocab_size, **kw)
    want = hf_train(texts, vocab_size, **kw)
    got = tok.to_str()
    if got != want:
        w, g = json.loads(want)["model"], json.loads(got)["model"]
        i = next((i for i, (a, b) in enumerate(zip(w["merges"], g["merges"])) if a != b),
                 min(len(w["merges"]), len(g["merges"])))
        pytest.fail(f"to_str differs: {len(w['vocab'])} vs {len(g['vocab'])} pieces; first merge that differs "
                    f"#{i}: tokenizers {w['merges'][i:i + 3]}, port {g['merges'][i:i + 3]}")
    return tok, report


# ------------------------------------------------ the trainer, corpora
# Pieces of the corpora: few characters (many ties), multi-byte and astral
# characters, the special tokens' text, whitespace runs and GPT-2's
# contractions.
PIECES = ["a", "b", "ab", "ba", "aab", "abab", " ", "  ", "\n", "\t", "é", "日本", "😀", "👍🏽", "[CLS]",
          "<<LABEL>>", "<<SEP>>", "'s", "'ll", "0", "12", ".", "!?", "the", " the", "Ġ"]
TEXT = st.lists(st.sampled_from(PIECES), max_size=40).map("".join)


@settings(max_examples=150, derandomize=True, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(texts=st.lists(TEXT, min_size=1, max_size=6), vocab_size=st.integers(100, 700),
       repeat=st.integers(1, 4), alphabet=st.booleans(), extra=st.sampled_from([[], ["ab"], ["Ġthe", "aab"], ["a"]]))
def test_trainer_equals_tokenizers_on_hypothesis_corpora(texts, vocab_size, repeat, alphabet, extra):
    """Random corpora (each text repeated, so that words and pairs tie),
    vocabulary sizes from below the alphabet's size to past the point where
    the merges run out, with and without the byte-level initial alphabet,
    with special tokens that merges can form (their string keeps the
    special token's id)."""
    assert_same(texts * repeat, vocab_size, specials=SPECIALS + extra, alphabet=alphabet, template=True)


def test_literal_special_token_text_is_cut_as_text():
    """Training has no added-token split: ``[CLS]`` and ``<<LABEL>>`` in a
    text are pre-tokenised as text, so ``<<`` and ``LABEL`` become pieces."""
    texts = ["x [CLS] y <<LABEL>> z <<SEP>>"] * 3 + ["<<LABEL>> <<SEP>> [CLS]"]
    tok, _ = assert_same(texts, 300)
    vocab = json.loads(tok.to_str())["model"]["vocab"]
    assert "<<" in vocab and "LABEL" in vocab and vocab["[CLS]"] == 2


def test_merged_string_already_in_vocabulary_keeps_its_id():
    """A merge that forms a special token's string keeps the special id and
    still adds a merge: the vocabulary grows by one piece less."""
    tok, report = assert_same(["ab ab ab abc abc"], 300, specials=SPECIALS + ["ab"])
    assert report["reused"] >= 1
    assert json.loads(tok.to_str())["model"]["vocab"]["ab"] == 6


def test_ties_pop_the_smaller_pair_first():
    """Every pair of the corpus has count 1: merges follow the pair ids."""
    tok, _ = assert_same(["dc ba fe"], 300, alphabet=False)
    assert json.loads(tok.to_str())["model"]["merges"] == [["b", "a"], ["d", "c"], ["f", "e"], ["Ġ", "ba"],
                                                           ["Ġ", "fe"]]


def test_vocab_size_below_the_alphabet_keeps_the_whole_alphabet():
    tok, report = assert_same(["hello world"], 10)
    assert report["merges"] == 0 and tok.get_vocab_size() == 6 + 256


def test_merges_run_out_before_vocab_size():
    tok, report = assert_same(["aaaa aaa aa"], 5000)
    assert report["pieces"] < 5000 and tok.get_vocab_size() == report["pieces"]


def test_self_overlapping_pair_counts():
    """``aaaa``: merging (a, a) left to right removes one (a, a) occurrence
    through its neighbour, as ``Word::merge`` counts it."""
    assert_same(["aaaa aaaa aaa aaaaa", "ababab abab"] * 2, 290)


def test_multibyte_and_astral_characters():
    assert_same(["日本語 日本 😀😀 👍🏽👍🏽 é é", "🇺🇦 café naïve"] * 2, 320, alphabet=False)


def test_batches_and_empty_texts():
    """The iterator may yield iterables of texts (batches) and empty texts."""
    texts = ["the quick brown fox", "", "jumps over the lazy dog"]
    tok, _ = port_train([texts[:2], texts[2:]], 300)
    assert tok.to_str() == hf_train(texts, 300)
    tok, _ = port_train([], 300)
    assert tok.to_str() == hf_train([], 300)


def test_tiny_tokenizer_of_the_tests_equals_tokenizers(tiny_tokenizer_file):
    """The corpus and options of ``helpers.build_tiny_tokenizer`` (with its
    post-processor) through the port's trainer: the file it made."""
    import string

    corpus = ["the quick brown fox jumps over the lazy dog", "onnx is an open-source format for ai models",
              "why are you running", "support ukraine", "science business sports politics travel health",
              string.ascii_lowercase, " ".join(str(i) for i in range(10))]
    tok, _ = port_train(corpus, 512, template=True)
    assert tok.to_str() == HFTokenizer.from_file(tiny_tokenizer_file).to_str()


def test_saved_file_reads_back_in_both_readers(tmp_path):
    tok, _ = port_train(["the quick brown fox jumps over the lazy dog"] * 2, 300, template=True)
    p = str(tmp_path / "tokenizer.json")
    tok.save(p)
    assert HFTokenizer.from_file(p).to_str() == tok.to_str() == Tokenizer.from_file(p).to_str()
    text = "the lazy fox [CLS] jumps"
    assert Tokenizer.from_file(p).encode(text).ids == HFTokenizer.from_file(p).encode(text).ids


@pytest.mark.parametrize("specials", [SPECIALS, ["[SEP]", "[UNK]", "[CLS]"], ["<<LABEL>>", "[CLS]", "[SEP]", "[PAD]"]])
def test_template_processing_equals_tokenizers(specials):
    """The one template the real-scale artifact sets, with [CLS] and [SEP]
    at other ids, byte-equal to ``tokenizers``' TemplateProcessing."""
    tok, _ = port_train(["the quick brown fox"], 280, specials=specials)
    got = trainers.cls_sep_template(tok).to_str()
    hf = HFTokenizer.from_str(tok.to_str())
    hf.post_processor = hf_processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B [SEP]",
        special_tokens=[("[CLS]", hf.token_to_id("[CLS]")), ("[SEP]", hf.token_to_id("[SEP]"))])
    assert got == hf.to_str()


@pytest.mark.parametrize("option,value", [("min_frequency", 2), ("limit_alphabet", 100),
                                          ("continuing_subword_prefix", "##"), ("end_of_word_suffix", "</w>"),
                                          ("max_token_length", 8)])
def test_trainer_refuses_options_it_does_not_implement(option, value):
    with pytest.raises(NotImplementedError, match=option):
        trainers.BpeTrainer(vocab_size=300, **{option: value})
    trainers.BpeTrainer(vocab_size=300, **{option: trainers._DEFAULTS[option]})  # the default is accepted


def test_trainer_refuses_unknown_options():
    with pytest.raises(TypeError, match="dropout"):
        trainers.BpeTrainer(vocab_size=300, dropout=0.1)


# --------------------------------------------------- build_realscale_tokenizer
@pytest.mark.parametrize("vocab_size,max_mb", [(2000, 1), (8000, 2)])
def test_realscale_tokenizer_equals_jax(vocab_size, max_mb, tmp_path):
    """Both packages' ``build_realscale_tokenizer`` over the same local
    corpus: the same files, and tokenizer.json files whose bundle form
    (``to_str()``) is byte-equal in either reader."""
    assert trs._corpus_files(max_mb * 1024 * 1024) == jrs._corpus_files(max_mb * 1024 * 1024)
    jp, tp = str(tmp_path / "jax" / "tokenizer.json"), str(tmp_path / "port" / "tokenizer.json")
    jrs.build_realscale_tokenizer(jp, vocab_size=vocab_size, max_mb=max_mb)
    rep = trs.build_realscale_tokenizer(tp, vocab_size=vocab_size, max_mb=max_mb)
    want = HFTokenizer.from_file(jp).to_str()
    assert Tokenizer.from_file(tp).to_str() == want
    assert HFTokenizer.from_file(tp).to_str() == want
    assert Tokenizer.from_file(jp).to_str() == want
    assert rep["pieces"] == vocab_size == HFTokenizer.from_file(jp).get_vocab_size()
    assert rep["files"] == len(jrs._corpus_files(max_mb * 1024 * 1024)) and rep["bytes"] > 0


# ------------------------------------------------------------ variant table
@pytest.fixture
def recorders(monkeypatch, tiny_tokenizer_file):
    """Both modules with their heavy steps replaced: the tokenizer trainers
    copy the tests' tiny tokenizer and record (root-relative path, vocab
    size, max_mb); the JAX model factory and exporter and the port's writer
    record the config."""
    import shutil

    import gliclass.c_tpu.convert.convert as jconvert
    import gliclass.c_tpu.convert.torch_ref as jtorch_ref

    calls = {"jax": [], "port": []}

    def tokenizer_trainer(side, root):
        def build(path, vocab_size, max_mb):
            calls[side].append(("tokenizer", os.path.relpath(path, root()), vocab_size, max_mb))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            shutil.copy(tiny_tokenizer_file, path)
        return build

    roots = {}
    monkeypatch.setattr(jrs, "build_realscale_tokenizer", tokenizer_trainer("jax", lambda: roots["jax"]))
    monkeypatch.setattr(trs, "build_realscale_tokenizer", tokenizer_trainer("port", lambda: roots["port"]))
    monkeypatch.setattr(jtorch_ref, "build_torch_gliclass",
                        lambda cfg, seed=0: calls["jax"].append(("model", json.loads(cfg.to_json()))))

    def jax_export(model, cfg, tok, out_path, quantize=False, golden_samples=None):
        calls["jax"].append(("bundle", json.loads(cfg.to_json()), quantize, golden_samples))
        os.makedirs(out_path, exist_ok=True)

    def port_write(path, cfg, tok):
        calls["port"].append(("bundle", json.loads(cfg.to_json()), trs.GOLDEN_SAMPLES))
        os.makedirs(path, exist_ok=True)
        return {}

    monkeypatch.setattr(jconvert, "export_bundle", jax_export)
    monkeypatch.setattr(trs, "write_bundle", port_write)
    return calls, roots


@pytest.mark.parametrize("variant", trs.VARIANTS)
def test_variant_table_equals_jax(variant, recorders, tmp_path):
    """The same GLiClassConfig, vocabulary size, corpus size and
    root-relative tokenizer path as the JAX module, for each variant; the
    port's cache is ``<root>/torch``."""
    calls, roots = recorders
    roots["jax"] = str(tmp_path)
    roots["port"] = str(tmp_path / "torch")
    jb = jrs.ensure_realscale_bundle(root=str(tmp_path), log=lambda m: None, variant=variant)
    tb = trs.ensure_realscale_bundle(root=str(tmp_path), log=lambda m: None, variant=variant)
    assert os.path.relpath(tb, roots["port"]) == os.path.relpath(jb, roots["jax"])
    jtok, jmodel, jbundle = calls["jax"]
    ttok, tbundle = calls["port"]
    assert ttok == jtok
    assert jtok[2] == {"qwen": jrs.QWEN_VOCAB, "llama": jrs.LLAMA_VOCAB}.get(variant, jrs.REALSCALE_VOCAB)
    assert jtok[3] == (160 if variant in ("qwen", "llama") else 96)
    assert tbundle[1] == jmodel[1] == jbundle[1]
    assert jbundle[2] is True  # the JAX bundle has INT8 weights; write_bundle always writes them
    assert [list(map(list, s[:2])) + [s[2]] for s in tbundle[2]] == [
        list(map(list, s[:2])) + [s[2]] for s in jbundle[3]]
    assert tcfg.GLiClassConfig.from_json(json.dumps(tbundle[1])).backbone.vocab_size == jtok[2]


def test_small_and_large_reuse_the_base_tokenizer(recorders, tmp_path):
    calls, roots = recorders
    roots["port"] = str(tmp_path / "torch")
    for variant in ("small", "large", "base"):
        trs.ensure_realscale_bundle(root=str(tmp_path), log=lambda m: None, variant=variant)
    assert [c[0] for c in calls["port"]] == ["tokenizer", "bundle", "bundle", "bundle"]
    assert calls["port"][0][1:] == ("tokenizer.json", trs.REALSCALE_VOCAB, 96)
    assert [c[1]["backbone"]["num_hidden_layers"] for c in calls["port"][1:]] == [6, 24, 12]


def test_complete_bundle_is_returned_untouched(recorders, tmp_path, monkeypatch):
    calls, roots = recorders
    roots["port"] = str(tmp_path / "torch")
    monkeypatch.setenv("GLICLASS_REALSCALE_DIR", str(tmp_path))
    first = trs.ensure_realscale_bundle(log=lambda m: None)
    n = len(calls["port"])
    assert first == os.path.join(str(tmp_path), "torch", "bundle") and os.path.exists(first + "/.complete")
    assert trs.ensure_realscale_bundle(log=lambda m: None) == first
    assert len(calls["port"]) == n
    with pytest.raises(ValueError, match="variant"):
        trs.ensure_realscale_bundle(log=lambda m: None, variant="xl")


# ------------------------------------------------------ a tiny bundle
TINY_BB = dict(model_type="deberta-v2", hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=64, max_position_embeddings=128, position_buckets=16,
               norm_rel_ebd="layer_norm", share_att_key=True, position_biased_input=False)
JOB = {"texts": ["the quick brown fox jumps over the lazy dog", "open source ai frameworks run fast",
                 "import numpy as np", "Ｆｕｌｌ－ｗｉｄｔｈ café 日本語 👍🏽", "def main():\n    return 0"],
       "labels": [["animal", "science", "sports", "code"]], "same_labels": True,
       "classification_type": "multi-label"}


@pytest.fixture(scope="module")
def tiny_bundle(tmp_path_factory):
    """A 600-piece tokenizer over 1 MiB of the local corpus and a 2-layer,
    H 32 DeBERTa bundle, both by the port's real-scale path."""
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    root = tmp_path_factory.mktemp("realscale")
    tok_path = str(root / "tokenizer.json")
    rep = trs.build_realscale_tokenizer(tok_path, vocab_size=600, max_mb=1)
    ptok = PromptTokenizer.from_file(tok_path)
    cfg = tcfg.GLiClassConfig(hidden_size=32, class_token_index=ptok.label_token_id,
                              text_token_index=ptok.sep_token_id, prompt_first=True,
                              backbone=tcfg.BackboneConfig(vocab_size=600, **TINY_BB))
    path = str(root / "bundle")
    times = trs.write_bundle(path, cfg, ptok)
    assert rep["pieces"] == 600 and times["bytes"] > 0
    return path


def test_tiny_bundle_goldens_reproduced_by_jax(tiny_bundle):
    """The JAX package reads the port's bundle on the CPU; its fp32 logits
    reproduce the port's goldens within 1e-5, and its ``selftest --dtype
    float32`` passes."""
    from gliclass.c_tpu.cli import main as jax_cli
    from gliclass.c_tpu.config import RuntimeConfig as JRuntime
    from gliclass.c_tpu.convert.bundle import load_goldens
    from gliclass.c_tpu.pipeline import ZeroShotClassificationPipeline as JPipeline
    from gliclass.c_tpu.utils.eval import golden_logit_check

    goldens = load_goldens(tiny_bundle)
    assert len(goldens) == len(trs.GOLDEN_SAMPLES) and all(g["max_length"] == 1024 for g in goldens)
    rt = JRuntime(compute_dtype="float32")
    assert golden_logit_check(JPipeline.from_bundle(tiny_bundle, rt), goldens, rt) <= 1e-5
    assert jax_cli(["selftest", "--bundle", tiny_bundle, "--dtype", "float32"]) == 0


@pytest.mark.parametrize("quant_mode", ["none", "int8"])
def test_tiny_bundle_port_decisions_equal_jax(quant_mode, tiny_bundle):
    from gliclass.c_tpu.config import RuntimeConfig as JRuntime
    from gliclass.c_tpu.data import parse_job as j_parse_job
    from gliclass.c_tpu.pipeline import ZeroShotClassificationPipeline as JPipeline
    from gliclass.c_tpu_torch.data import parse_job
    from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline

    rt = dict(batch_size=4, max_length=64, compute_dtype="float32", seq_buckets=(16, 32, 64), label_buckets=(4,),
              quant_mode=quant_mode)
    jout = JPipeline.from_bundle(tiny_bundle, JRuntime(**rt)).classify_job(j_parse_job(JOB))
    tout = ZeroShotClassificationPipeline.from_bundle(tiny_bundle, tcfg.RuntimeConfig(**rt),
                                                      device="cpu").classify_job(parse_job(JOB))
    assert tout.failures == [] and jout.failures == []
    np.testing.assert_allclose(tout.probs, jout.probs, atol=1e-5, rtol=1e-5)
    assert [[d["label"] for d in r["decisions"]] for r in tout.to_json()] == [
        [d["label"] for d in r["decisions"]] for r in jout.to_json()]


def test_tiny_bundle_port_selftest(tiny_bundle, capsys):
    from gliclass.c_tpu_torch.cli import main

    assert main(["selftest", "--bundle", tiny_bundle, "--dtype", "float32"], device="cpu") == 0
    assert "PASS" in capsys.readouterr().out


# --------------------------------------------------------- one golden function
def test_forward_golden_logits_equals_the_torch_reference():
    """The port's fp32 golden record of a converted torch reference model
    equals ``torch_ref.golden_logits`` of that model (same schema, logits
    within 1e-4), and ``chip_smoke.fp32_goldens`` is that function's record."""
    import sys

    from gliclass.c_tpu_torch.convert.convert import convert_gliclass_state_dict, forward_golden_logits
    from gliclass.c_tpu_torch.convert.torch_ref import build_torch_gliclass, golden_logits
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    tok = PromptTokenizer(chip_smoke.WordTokenizer(600))
    cfg = tcfg.GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                              text_token_index=tok.sep_token_id, prompt_first=True,
                              backbone=tcfg.BackboneConfig(vocab_size=600, **TINY_BB))
    torch.manual_seed(0)
    model = build_torch_gliclass(cfg)
    params = convert_gliclass_state_dict(model.state_dict(), cfg)
    texts, labels = ["w1 w2 w3 w4", "w5 w6"], [["w7", "w8", "w9"]]
    want = golden_logits(model, tok, cfg, texts, labels, True, True)
    got = forward_golden_logits(cfg, params, tok, texts, labels, True)
    assert {k: v for k, v in got.items() if k != "logits"} == {k: v for k, v in want.items() if k != "logits"}
    np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-4)
    rec = chip_smoke.fp32_goldens(cfg, params, tok, texts)
    assert rec == [forward_golden_logits(cfg, params, tok, texts, [chip_smoke.JOB_LABELS], True, max_length=512)]
