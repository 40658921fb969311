"""``AffixEncoder`` on a ``tokenizer.json`` that sets ``truncation``.

The port's reader honours the block: it cuts a segment encode at
``max_length`` and a full encode at ``max_length`` minus the specials. So a
label block encoded once and composed with each text's own encode no
longer equals the full-string encode of a long prompt, and the short
probes of the composition check cannot see it. The encoder is therefore
never exact on such a file, and the full-string path serves every prompt.
"""

import json

import numpy as np
import pytest
import tokenizers

from gliclass.c_tpu_torch.prompting import pack_prompt
from gliclass.c_tpu_torch.tokenization import AffixEncoder, PromptTokenizer

FIXTURE = "tests/data/tokenizers/a_bytelevel_bpe.json"
LABELS = ["science", "sports", "market news"]
LONG = " ".join(["the quick brown fox jumps over the lazy dog near the open market"] * 6)


def _with_truncation(tmp_path, max_length):
    with open(FIXTURE, encoding="utf-8") as f:
        spec = json.load(f)
    assert spec["truncation"] is None
    spec["truncation"] = {"direction": "Right", "max_length": max_length, "strategy": "LongestFirst", "stride": 0}
    path = str(tmp_path / "tokenizer.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(spec, f)
    return path


@pytest.mark.parametrize("prompt_first", [True, False])
def test_truncating_file_is_never_exact_and_long_prompts_take_the_full_string_path(tmp_path, prompt_first):
    path = _with_truncation(tmp_path, 24)
    tok = PromptTokenizer.from_file(path)
    enc = AffixEncoder.for_labels(tok, LABELS, prompt_first, 512, sample_text="a short text")
    assert not enc.exact and "truncation" in enc._why
    prompt = pack_prompt(LONG, LABELS, prompt_first)
    got = enc.encode_batch([LONG], 512, fallback_prompts=[prompt])
    want = tok.encode_batch([prompt], 512)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    # The full-string encode is the file's own: tokenizers' ids, cut at 24.
    ref = tokenizers.Tokenizer.from_file(path).encode(prompt).ids
    assert len(ref) == 24 and list(got.input_ids[0, :got.lengths[0]]) == ref
    # A composition of the segments' own (truncated) encodes would differ.
    t = tok._tok
    seg = lambda s: t.encode(s, add_special_tokens=False).ids  # noqa: E731
    affix = pack_prompt("", LABELS, prompt_first)
    core = seg(affix) + seg(LONG) if prompt_first else seg(LONG) + seg(affix)
    assert t.encode("a").ids[0:1] + core + t.encode("a").ids[-1:] != ref


def test_the_same_file_without_truncation_stays_exact(tmp_path):
    """The control: the fixture as it is composes exactly, and the long
    prompt's composed ids equal its full-string encode."""
    tok = PromptTokenizer.from_file(FIXTURE)
    enc = AffixEncoder.for_labels(tok, LABELS, True, 512, sample_text="a short text")
    assert enc.exact
    prompt = pack_prompt(LONG, LABELS, True)
    np.testing.assert_array_equal(enc.encode_batch([LONG], 512).input_ids,
                                  tok.encode_batch([prompt], 512).input_ids)


def test_reader_reports_the_truncation_block_as_tokenizers_does(tmp_path):
    path = _with_truncation(tmp_path, 24)
    tok = PromptTokenizer.from_file(path)._tok
    assert tok.truncation["max_length"] == tokenizers.Tokenizer.from_file(path).truncation["max_length"] == 24
    assert PromptTokenizer.from_file(FIXTURE)._tok.truncation is None
