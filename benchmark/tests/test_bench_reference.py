"""The plain reference against the program at the tiny geometry: the same
ids from the same tokenizer.json, the same fp32 model, and the control
(4-bit) failing the comparison that the program passes."""


import numpy as np
import pytest
import torch
from conftest import TINY_LOGIT_GAP, tiny_cell

from benchmark import compare, harness, reference, textgen, weights


def _texts(cell, seed, n=24):
    lex = textgen.Lexicon(seed, cell.config["tokenizer"])
    maker = textgen.TextMaker(lex, cell.traffic, seed)
    return lex, harness.make_job(maker, cell.traffic, seed, 0)


def test_plain_tokenizer_gives_the_programs_ids(tmp_path):
    from gliclass.c_tpu_torch.prompting import pack_prompt
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    cell = tiny_cell("job")
    lex, job = _texts(cell, 41)
    path = str(tmp_path / "tokenizer.json")
    textgen.write_tokenizer(lex, path)
    prog = PromptTokenizer.from_file(path)
    plain = reference.PlainTokenizer(path)
    odd = ["", "a", "  two  spaces ", "Upper CASE Words", "zzzz qqqq", "x.y,z", "ünïcode wörds"]
    for text in list(job.texts) + odd:
        prompt = pack_prompt(text, job.labels[0], True)
        want = prog.encode_batch([prompt], 64).input_ids[0]
        got = plain.encode(prompt, 64)
        assert list(want[: len(got)]) == got and int((prog.encode_batch([prompt], 64).attention_mask[0]).sum()) == len(got)


def test_reference_fp32_matches_the_programs_fp32_forward(tmp_path):
    from gliclass.c_tpu_torch.config import GLiClassConfig
    from gliclass.c_tpu_torch.convert.params import params_from_numpy
    from gliclass.c_tpu_torch.models.gliclass import gliclass_forward

    cell = tiny_cell("job")
    lex, job = _texts(cell, 42)
    path = str(tmp_path / "tokenizer.json")
    textgen.write_tokenizer(lex, path)
    tok = reference.PlainTokenizer(path)
    raw = weights.make_weights(cell.config["model"], cell.config["init"], 42, torch.device("cpu"))
    items = [(t, list(job.labels[0])) for t in job.texts[:8]]
    ref = reference.logits(reference.PlainGLiClass(raw, cell.config["model"], None), tok, items, 96,
                           torch.device("cpu"))
    model = dict(cell.config["model"], class_token_index=tok.added["<<LABEL>>"], text_token_index=tok.added["<<SEP>>"])
    cfg = GLiClassConfig.from_dict(model)
    params = params_from_numpy(harness._to_numpy(raw), torch.device("cpu"))
    for (text, labels), want in zip(items, ref):
        ids = torch.tensor([tok.encode(reference.pack(text, labels), 96)])
        got = gliclass_forward(params, ids, torch.ones_like(ids), cfg, len(labels), torch.float32, "flash")
        np.testing.assert_allclose(got[0].numpy(), want, atol=2e-5 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("kind", ["job", "serve"])
def test_control_fails_where_the_program_passes(kind, cpu):
    """The control: the reference at 4-bit weights and activations in the
    program's place, judged by the same numbers, at the tiny geometry."""
    cell = tiny_cell(kind)
    for seed in (11, 12, 13):
        out = harness.run(cell, seed, 1.0, False, cpu, warm=False, control=True)
        assert out["correct"] and out["checks"]["logit_gap"]["value"] < TINY_LOGIT_GAP / 2
        ctl = out["control"]
        assert ctl["logit_gap"] > 1.5 * TINY_LOGIT_GAP, (seed, ctl)


def test_quantization_follows_the_mode():
    """``int8`` is weight-only (its reference keeps activations in fp32),
    ``int8-dynamic`` quantizes both; a mode the reference does not model is
    refused rather than compared as another."""
    mode = lambda m: compare.quantization({"runtime": {"quant_mode": m}})  # noqa: E731
    assert mode("none") == (None, False) and mode("int8") == (8, False) and mode("int8-dynamic") == (8, True)
    with pytest.raises(ValueError):
        mode("fp8")
    g = torch.Generator().manual_seed(3)
    w, b, x = torch.randn(16, 8, generator=g), torch.randn(8, generator=g), torch.randn(4, 16, generator=g)
    q, s = reference.quantize_weight(w, 8)
    wonly, w8a8 = reference.Dense(w, b, 8, False)(x), reference.Dense(w, b, 8, True)(x)
    torch.testing.assert_close(wonly, x @ (q * s) + b)
    assert not torch.allclose(wonly, w8a8)


def test_a_sample_beyond_the_logit_cap_is_not_read_as_agreeing():
    z = np.array([compare.LOGIT_CAP + 3.0, -compare.LOGIT_CAP - 5.0])
    p = 1.0 / (1.0 + np.exp(-z))
    far = compare.numbers([(p, {0}, True)], [z + 2.0], 0.5, 0.3)
    assert far["compared"] == 0 and far["logit_gap"] == 0.0 and far["few_compared"] == 1
    z = np.array([2.0, -3.0])
    near = compare.numbers([(1.0 / (1.0 + np.exp(-z)), {0}, True)], [z + 0.25], 0.5, 0.3)
    assert near["compared"] == 2 and near["few_compared"] == 0 and abs(near["logit_gap"] - 0.25) < 1e-9
