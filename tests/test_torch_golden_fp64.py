"""A decoder bundle's goldens are its fp64 logits on the CPU.

At the qwen and llama real-scale widths the goldens reach |logit| 38-45,
where an fp32 forward on the CPU moves by up to 4e-4 with the host's code
paths (AVX2 or AVX-512 sums, threads; ``scripts/golden_host_spread.py``):
fp32 goldens made on one host could hold the card's fp32 logits within
the selftest's 1e-3 and those made on another not. ``forward_golden_logits
(..., dtype="float64")`` runs the decoder in fp64 end to end, so the record
is the exact logits to its 5 decimals wherever it is built, and
``utils.realscale.write_bundle`` records a decoder's goldens so.

The model: a tiny Qwen2 (H 32, 2 layers) with the test fixture's
8,000-piece BPE, its head weights scaled by 6 and a ``logit_scale`` of
log(72), whose logits spread over about [-30, 18].
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.convert import bundle as B
from gliclass.c_tpu_torch.convert.convert import forward_golden_logits
from gliclass.c_tpu_torch.models.gliclass import gliclass_forward, init_gliclass_params
from gliclass.c_tpu_torch.tokenization import PromptTokenizer
from gliclass.c_tpu_torch.utils import realscale as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "tokenizers", "a_bytelevel_bpe.json")


def _config(tok):
    bb = tcfg.BackboneConfig(model_type="qwen2", vocab_size=8000, hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
                             max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-6, hidden_act="silu",
                             relative_attention=False, attention_bias=True)
    return tcfg.GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                               text_token_index=tok.sep_token_id, prompt_first=True, backbone=bb)


def _wide_params(cfg):
    params = init_gliclass_params(torch.Generator().manual_seed(2), cfg)
    for proj in params["head"].values():
        for lin in proj.values():
            lin["w"] = lin["w"] * 6
    params["head"]["logit_scale"] = torch.tensor(math.log(72.0))
    return params


def _to(tree, dtype):
    if isinstance(tree, dict):
        return {k: _to(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


@pytest.fixture(scope="module")
def model():
    tok = PromptTokenizer.from_file(FIXTURE)
    cfg = _config(tok)
    return tok, cfg, _wide_params(cfg)


def _batch(tok):
    from gliclass.c_tpu_torch.prompting import pack_prompts

    texts, labels, same = R.GOLDEN_SAMPLES[1]
    b = tok.encode_batch(pack_prompts(texts, labels, same, True), max_length=128)
    return torch.from_numpy(b.input_ids), torch.from_numpy(b.attention_mask), len(labels[0])


def test_fp64_forward_keeps_fp64_end_to_end(model):
    """Word embeddings moved by 1e-10 of themselves move the fp64 logits by
    about that much; an op that rounded to fp32 on the way (2^-24 = 6e-8
    apart) would drop such a move or make it one of fp32's steps."""
    tok, cfg, params = model
    ids, mask, n = _batch(tok)
    p64 = _to(params, torch.float64)
    moved = _to(params, torch.float64)
    moved["backbone"]["embeddings"]["word"] = moved["backbone"]["embeddings"]["word"] * (1 + 1e-10)
    with torch.inference_mode():
        a = gliclass_forward(p64, ids, mask, cfg, n, torch.float64)
        b = gliclass_forward(moved, ids, mask, cfg, n, torch.float64)
    assert a.dtype == torch.float64
    rel = float((a - b).abs().max() / a.abs().max())
    assert 0 < rel < 1e-8, rel


def test_fp64_goldens_are_the_fp32_goldens_to_fp32s_noise(model):
    tok, cfg, params = model
    for texts, labels, same in R.GOLDEN_SAMPLES:
        g32 = np.asarray(forward_golden_logits(cfg, params, tok, texts, labels, same)["logits"])
        g64 = np.asarray(forward_golden_logits(cfg, params, tok, texts, labels, same, dtype="float64")["logits"])
        real = g64 > -9.99e3
        assert np.abs(g64[real]).max() > 10
        np.testing.assert_allclose(g64[real], g32[real], rtol=0, atol=1e-4)
        assert (g64[~real] == -1e4).all()


def test_fp64_goldens_refuse_deberta_and_the_card(model):
    tok, cfg, params = model
    deberta = dataclasses.replace(cfg, backbone=tcfg.deberta_v3_config("small"))
    texts, labels, same = R.GOLDEN_SAMPLES[0]
    with pytest.raises(ValueError, match="decoder"):
        forward_golden_logits(deberta, {}, tok, texts, labels, same, dtype="float64")
    with pytest.raises(ValueError, match="decoder"):
        forward_golden_logits(cfg, params, tok, texts, labels, same, device="meta", dtype="float64")


def test_write_bundle_records_a_decoders_goldens_in_fp64(tmp_path):
    """``write_bundle`` (seed 0 weights) on a tiny decoder: its goldens are
    ``forward_golden_logits(..., dtype="float64")``'s, bit for bit."""
    tok = PromptTokenizer.from_file(FIXTURE)
    cfg = _config(tok)
    path = str(tmp_path / "bundle")
    R.write_bundle(path, cfg, tok)
    params = init_gliclass_params(torch.Generator().manual_seed(0), cfg)
    for rec, (texts, labels, same) in zip(B.load_goldens(path), R.GOLDEN_SAMPLES):
        want = forward_golden_logits(cfg, params, tok, texts, labels, same, dtype="float64")["logits"]
        assert rec["logits"] == want


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items() for k, v in _flat(t, f"{prefix}{n}/").items()}
    return {prefix[:-1]: tree.numpy()}


def _nested(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for n in path:
            node = node.setdefault(n, {})
        node[leaf] = v
    return tree


# argv: the tests directory, the weights (.npz of _flat).
CHILD = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from test_torch_golden_fp64 import FIXTURE, _config, _nested
from gliclass.c_tpu_torch.convert.convert import forward_golden_logits
from gliclass.c_tpu_torch.tokenization import PromptTokenizer
from gliclass.c_tpu_torch.utils.realscale import GOLDEN_SAMPLES
tok = PromptTokenizer.from_file(FIXTURE)
with np.load(sys.argv[2]) as z:
    params = _nested({k: z[k] for k in z.files})
print(json.dumps([forward_golden_logits(_config(tok), params, tok, *s, dtype="float64")["logits"]
                  for s in GOLDEN_SAMPLES]))
"""


def test_fp64_goldens_do_not_move_with_the_cpus_code_paths(model, tmp_path):
    """The same weights' goldens from the CPU's widest vector code and from
    its baseline one (``ATEN_CPU_CAPABILITY=default``) on one thread."""
    weights = str(tmp_path / "weights.npz")
    np.savez(weights, **_flat(model[2]))
    runs = []
    for env in ({}, {"ATEN_CPU_CAPABILITY": "default", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}):
        out = subprocess.run([sys.executable, "-c", CHILD, os.path.join(ROOT, "tests"), weights],
                             capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT, **env))
        assert out.returncode == 0, out.stderr[-3000:]
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert runs[0] == runs[1]
