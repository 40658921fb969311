"""``cli selftest`` holds the goldens as logits.

A decoder bundle's goldens can pass +17 and -28 (the real-scale qwen and
llama artifacts' reach |logit| 38). The JAX package's check inverts fp32
probabilities clipped at 1e-12: fp32's sigmoid is 1 from about 17.3 on,
so a logit there reads inf, and one below -27.6 reads -27.6. The port's
check reads the engine's logits before the sigmoid (``pipeline.
predict_logits``: the same tokenization, buckets, route and params as
``predict_probs``) and holds fp32 to the CLI's 1e-3 at any magnitude.

The bundle: a tiny Qwen2 (H 32, 2 layers) with the test fixture's
8,000-piece BPE, its head weights scaled by 6 and a ``logit_scale`` of
log(72), which spreads its goldens over about [-30, 18].
"""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.cli import main
from gliclass.c_tpu_torch.convert import bundle as B
from gliclass.c_tpu_torch.convert.convert import forward_golden_logits
from gliclass.c_tpu_torch.models.gliclass import init_gliclass_params
from gliclass.c_tpu_torch.ops.quant import quantize_tree
from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline
from gliclass.c_tpu_torch.tokenization import PromptTokenizer
from gliclass.c_tpu_torch.utils.eval import golden_logit_check
from gliclass.c_tpu_torch.utils.realscale import GOLDEN_SAMPLES

FIXTURE = "tests/data/tokenizers/a_bytelevel_bpe.json"


def _numpy(tree):
    return {k: _numpy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.numpy()


@pytest.fixture(scope="module")
def wide_logit_bundle(tmp_path_factory):
    tok = PromptTokenizer.from_file(FIXTURE)
    bb = tcfg.BackboneConfig(model_type="qwen2", vocab_size=8000, hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
                             max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-6, hidden_act="silu",
                             relative_attention=False, attention_bias=True)
    cfg = tcfg.GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                              text_token_index=tok.sep_token_id, prompt_first=True, backbone=bb)
    params = init_gliclass_params(torch.Generator().manual_seed(2), cfg)
    for proj in params["head"].values():
        for lin in proj.values():
            lin["w"] = lin["w"] * 6
    params["head"]["logit_scale"] = torch.tensor(math.log(72.0))
    params = _numpy(params)
    goldens = [forward_golden_logits(cfg, params, tok, *s) for s in GOLDEN_SAMPLES]
    path = str(tmp_path_factory.mktemp("wide") / "bundle")
    B.save_bundle(path, cfg, params, tokenizer_json=tok._tok.to_str(), goldens=goldens,
                  int8_params=quantize_tree(params))
    return path


def _goldens(path):
    return np.concatenate([np.ravel(g["logits"]) for g in B.load_goldens(path)])


def _selftest(path, capsys, *flags):
    rc = main(["selftest", "--bundle", path, *flags], device="cpu")
    line = next(l for l in capsys.readouterr().out.splitlines() if l.startswith("golden-logit check"))
    return rc, float(line.split("= ")[1].split()[0]), line


def test_goldens_reach_past_the_inversions_range(wide_logit_bundle):
    g = _goldens(wide_logit_bundle)
    g = g[g > -9.99e3]
    assert g.max() > 17.3 and g.min() < -28


def test_fp32_selftest_passes_on_logits(wide_logit_bundle, capsys):
    rc, delta, line = _selftest(wide_logit_bundle, capsys, "--dtype", "float32")
    assert rc == 0 and delta <= 1e-4 and line.endswith("(tol 0.001) PASS")


def test_fp32_selftest_fails_when_one_golden_moves_by_1e_2(wide_logit_bundle, tmp_path, capsys):
    """The largest golden moved by 1e-2: the check reads 1e-2 and fails."""
    path = str(tmp_path / "moved")
    shutil.copytree(wide_logit_bundle, path)
    goldens = B.load_goldens(path)
    rec = max(goldens, key=lambda r: np.max(r["logits"]))
    i, j = np.unravel_index(int(np.argmax(rec["logits"])), np.shape(rec["logits"]))
    assert rec["logits"][i][j] > 17.3
    rec["logits"][i][j] += 1e-2
    with open(os.path.join(path, "goldens.json"), "w") as f:
        json.dump(goldens, f)
    rc, delta, line = _selftest(path, capsys, "--dtype", "float32")
    assert rc == 1 and line.endswith("FAIL") and abs(delta - 1e-2) < 1e-4


def test_probability_inversion_cannot_hold_these_goldens(wide_logit_bundle):
    """The port's logits are the goldens to 1e-4, while the inversion of
    its probabilities (the JAX package's check, and the port's before)
    reads inf, and the JAX package's own check on the same bundle too."""
    import jax  # noqa: F401  (the conftest keeps it on the CPU)
    from gliclass.c_tpu.config import RuntimeConfig as JRuntime
    from gliclass.c_tpu.pipeline import ZeroShotClassificationPipeline as JPipeline
    from gliclass.c_tpu.utils.eval import golden_logit_check as j_check

    rt = tcfg.RuntimeConfig(compute_dtype="float32")
    pipe = ZeroShotClassificationPipeline.from_bundle(wide_logit_bundle, rt, device="cpu")
    goldens = B.load_goldens(wide_logit_bundle)
    assert golden_logit_check(pipe, goldens, rt) <= 1e-4
    worst = 0.0
    for rec in goldens:
        p = np.clip(pipe.predict_probs(rec["texts"], rec["labels"], rec["same_labels"]), 1e-12, 1 - 1e-12)
        with np.errstate(divide="ignore"):
            inverted = np.log(p) - np.log1p(-p)
        golden = np.asarray(rec["logits"])
        real = golden > -9.99e3
        worst = max(worst, float(np.abs(inverted[:, :golden.shape[1]] - golden)[real].max()))
    assert worst == np.inf
    jrt = JRuntime(compute_dtype="float32")
    assert j_check(JPipeline.from_bundle(wide_logit_bundle, jrt), goldens, jrt) > 1e-3


def test_predict_logits_is_predict_probs_before_the_sigmoid(wide_logit_bundle):
    """Through the same pipeline, the logits' sigmoid is the probabilities
    (padded label slots: -1e4 and 0); the engine is back to probabilities
    afterwards."""
    pipe = ZeroShotClassificationPipeline.from_bundle(
        wide_logit_bundle, tcfg.RuntimeConfig(compute_dtype="float32"), device="cpu")
    texts, labels, same = GOLDEN_SAMPLES[1]
    labels = [labels[0], labels[0][:2]]
    logits = pipe.predict_logits(texts, labels, False)
    probs = pipe.predict_probs(texts, labels, False)
    with np.errstate(over="ignore"):
        np.testing.assert_allclose(1 / (1 + np.exp(-logits.astype(np.float64))), probs, atol=1e-6)
    assert logits[1, 2] == -1e4 and probs[1, 2] == 0 and np.abs(logits).max() > 17.3
