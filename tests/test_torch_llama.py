"""The port's Llama/Qwen2 decoder slice vs the JAX package, on CPU.

Inputs and parameters are made from a seed with numpy (JAX-initialised
parameters moved to numpy, with non-zero biases and norm scales) and handed
to both packages. Tolerances: fp32 at 1e-5, where the two compute the same
fp32 function in a different summation order; bf16 as stated at each test.
K5's plain version stands in for the kernel here (CPU tensors).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gliclass.c_tpu import config as jcfg
from gliclass.c_tpu.models import llama as jllama
from gliclass.c_tpu.models.gliclass import gliclass_probs as j_probs
from gliclass.c_tpu.models.gliclass import init_gliclass_params
from gliclass.c_tpu.ops.causal_attention import causal_flash_attention as j_causal_flash
from gliclass.c_tpu.ops.layers import act_quant as j_act_quant
from gliclass.c_tpu.ops.quant import quantize_tree as j_quantize_tree
from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.convert.params import params_from_numpy
from gliclass.c_tpu_torch.engine import InferenceEngine, fuse_qkv_params
from gliclass.c_tpu_torch.models import llama as tllama
from gliclass.c_tpu_torch.models.gliclass import gliclass_forward as t_forward
from gliclass.c_tpu_torch.models.gliclass import gliclass_probs as t_probs
from gliclass.c_tpu_torch.ops import causal_attention as CA
from gliclass.c_tpu_torch.ops.layers import act_quant as t_act_quant
from gliclass.c_tpu_torch.ops.quant import quantize_tree as t_quantize_tree
from gliclass.c_tpu_torch.tokenization import TokenizedBatch

BF16_ULP = 2.0**-7
CLASS_TOKEN = 7
# Head weights scaled so the probabilities spread over about [0.3, 0.8]: with
# larger logits a bf16 rounding anywhere in 2 layers moves a probability by
# tenths in either package alone.
HEAD_SCALE = 6.0


@pytest.fixture(autouse=True)
def _jax_default_causal_route(monkeypatch):
    """The JAX package's default decoder route (XLA einsum), unless a test
    asks for its flash kernel."""
    monkeypatch.delenv("GLICLASS_TPU_CAUSAL_ATTN", raising=False)


def backbones(model_type="qwen2", **over):
    """The same tiny decoder geometry in both packages (qwen2: q/k/v bias)."""
    kw = dict(model_type=model_type, vocab_size=200, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
              max_position_embeddings=128, rope_theta=10000.0, rms_norm_eps=1e-6,
              hidden_act="silu", relative_attention=False,
              attention_bias=model_type == "qwen2")
    kw.update(over)
    return jcfg.BackboneConfig(**kw), tcfg.BackboneConfig(**kw)


def gliclass_cfgs(model_type="qwen2", **over):
    jb, tb = backbones(model_type)
    kw = dict(hidden_size=32, class_token_index=CLASS_TOKEN, prompt_first=False)
    kw.update(over)
    return jcfg.GLiClassConfig(backbone=jb, **kw), tcfg.GLiClassConfig(backbone=tb, **kw)


def _jitter(params, seed=1):
    """Non-zero biases, norm scales away from 1, head weights scaled."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']"):
            return (a + rng.normal(0, 0.05, a.shape)).astype(np.float32)
        if name.endswith("['scale']") and "norm" in name:
            return (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        if name.startswith("['head']") and name.endswith("['w']"):
            return a * HEAD_SCALE
        return a

    return jax.tree_util.tree_map_with_path(f, jax.tree.map(np.asarray, params))


def make_batch(n=4, s=24, labels=3, seed=0):
    """Right-padded ragged batch: row i has s - 3*i valid tokens; label tokens
    sit near the end of the valid span (prompt last, as decoders take it)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 190, size=(n, s)).astype(np.int32)
    mask = np.zeros((n, s), dtype=np.int32)
    for i in range(n):
        L = s - 3 * i
        mask[i, :L] = 1
        for k in range(labels):
            ids[i, L - 2 - 2 * k] = CLASS_TOKEN
    ids[mask == 0] = 0
    return ids, mask


@pytest.mark.parametrize("S,d,theta", [(12, 8, 1e4), (128, 128, 1e6), (512, 64, 1e4)])
def test_rope_tables_equal(S, d, theta):
    for got, want in zip(tllama.rope_tables(S, d, theta), jllama.rope_tables(S, d, theta)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_apply_rope_matches_jax_and_promotes():
    """bf16 q rotated with f32 tables: f32 product (then the caller casts)."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 10, 16)).astype(np.float32)
    cos, sin = tllama.rope_tables(10, 16, 1e4)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tllama.apply_rope(torch.from_numpy(x).to(dt), torch.from_numpy(cos), torch.from_numpy(sin))
        want = jllama.apply_rope(jnp.asarray(x, jdt), jnp.asarray(cos), jnp.asarray(sin))
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def _attn_inputs(seed, B, nkv, g, S, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    qg = rng.normal(size=(B, nkv, g, S, d)).astype(dtype)
    k, v = (rng.normal(size=(B, nkv, S, d)).astype(dtype) for _ in range(2))
    mask = np.ones((B, S), dtype=np.int32)
    mask[-1, S // 2 + 1:] = 0  # right-padded keys; key 0 stays valid in every row
    return qg, k, v, mask


@pytest.mark.parametrize("B,nkv,g,S,d", [
    (2, 2, 1, 12, 8),    # MHA (g = 1)
    (2, 2, 2, 56, 8),    # GQA, a ragged bucket
    (2, 2, 6, 12, 16),   # qwen2's g = 6
    (2, 1, 4, 128, 8),   # MQA (nkv = 1), the 128 bucket
    (1, 2, 6, 56, 32),
])
def test_causal_plain_matches_jax_kernel(B, nkv, g, S, d):
    """K5's plain version vs the JAX Pallas kernel (interpret mode), fp32
    1e-5 on every row (padded query rows included: each has a valid key)."""
    qg, k, v, mask = _attn_inputs(S + g, B, nkv, g, S, d)
    scale = 1.0 / math.sqrt(d)
    want = np.asarray(j_causal_flash(*(jnp.asarray(a) for a in (qg, k, v, mask)), scale))
    got = CA.causal_flash_attention(*(torch.from_numpy(a) for a in (qg, k, v, mask)), scale)
    assert got.shape == (B, nkv, g, S, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [12, 56])
def test_causal_plain_bf16_matches_jax_kernel(S):
    """bf16 q/k/v: both round the probabilities to bf16 before P.v (one tile
    in the JAX kernel at these S, so against the same row max) and the
    output once: 2 bf16 ulps of the largest output."""
    qg, k, v, mask = _attn_inputs(S, 2, 2, 3, S, 16)
    scale = 1.0 / math.sqrt(16)
    want = np.asarray(j_causal_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (qg, k, v)),
                                     jnp.asarray(mask), scale).astype(jnp.float32))
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = CA.causal_flash_attention(t(qg), t(k), t(v), torch.from_numpy(mask), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 * BF16_ULP * np.abs(want).max())


def test_causal_plain_row_without_valid_key_is_zero():
    qg, k, v, mask = _attn_inputs(0, 1, 1, 2, 8, 8)
    mask[0, :3] = 0  # queries 0..2 see no valid key
    t = torch.from_numpy
    out = CA.causal_flash_attention_plain(t(qg), t(k), t(v), t(mask), 0.3)
    assert (out[0, :, :, :3] == 0).all() and torch.isfinite(out).all()
    assert (out[0, :, :, 3:].abs().sum(-1) > 0).all()


def test_causal_wrapper_on_cpu_runs_plain_and_counts_nothing():
    qg, k, v, mask = (torch.from_numpy(a) for a in _attn_inputs(1, 2, 2, 2, 10, 8))
    before = CA.launches, CA.launches_tc
    got = CA.causal_flash_attention(qg, k, v, mask, 0.25)
    assert (CA.launches, CA.launches_tc) == before
    torch.testing.assert_close(got, CA.causal_flash_attention_plain(qg, k, v, mask, 0.25), atol=0, rtol=0)


def test_causal_wrapper_on_cpu_bf16_runs_plain_and_counts_nothing():
    """bf16 at a width the tensor-core variant takes: on a CPU tensor the
    wrapper still runs the plain version and counts no launch of either."""
    qg, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _attn_inputs(2, 2, 2, 3, 20, 16)[:3])
    mask = torch.from_numpy(_attn_inputs(2, 2, 2, 3, 20, 16)[3])
    assert CA.kernel_variant(qg.dtype, 16) == CA.TENSOR_CORE
    before = CA.launches, CA.launches_tc
    got = CA.causal_flash_attention(qg, k, v, mask, 0.25)
    assert (CA.launches, CA.launches_tc) == before
    assert torch.equal(got, CA.causal_flash_attention_plain(qg, k, v, mask, 0.25))


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 64, "tc"), (torch.bfloat16, 16, "tc"),
    (torch.bfloat16, 48, "tc"), (torch.bfloat16, 112, "tc"), (torch.bfloat16, 8, "cc"),
    (torch.bfloat16, 40, "cc"), (torch.bfloat16, 100, "cc"), (torch.bfloat16, 144, "cc"),
    (torch.float32, 128, "cc"), (torch.float32, 64, "cc"), (torch.float32, 8, "cc"),
])
def test_causal_kernel_variant_predicate(dtype, d, want):
    """K5's tensor-core variant takes bf16 q/k/v with d a multiple of 16 up
    to 128 (qwen-1.5B's and Llama-1.3B's d = 128); fp32 and the other widths
    keep the CUDA-core kernel."""
    assert CA.kernel_variant(dtype, d) == {"tc": CA.TENSOR_CORE, "cc": CA.CUDA_CORE}[want]


def _attn_block(model_type, nkv, seed=3):
    jb, tb = backbones(model_type, num_key_value_heads=nkv)
    params = _jitter(init_gliclass_params(jax.random.key(seed), jcfg.GLiClassConfig(backbone=jb)))
    p = jax.tree.map(lambda a: a[0], params["backbone"]["layers"]["attn"])
    return jb, tb, p


@pytest.mark.parametrize("model_type,nkv", [("qwen2", 2), ("qwen2", 1), ("llama", 4)])
def test_attention_block_matches_jax_xla_route(model_type, nkv):
    """One attention block: the port's kernel route (plain on CPU) and its
    score route vs the JAX package's default XLA route, fp32, valid rows."""
    jb, tb, p = _attn_block(model_type, nkv)
    rng = np.random.default_rng(4)
    B, S = 2, 14
    x = rng.normal(size=(B, S, 32)).astype(np.float32)
    mask = np.ones((B, S), dtype=np.int32)
    mask[1, 9:] = 0
    cos, sin = tllama.rope_tables(S, jb.head_dim, jb.rope_theta)
    causal = np.tril(np.ones((S, S), dtype=bool))
    bias = np.where(causal[None] & mask.astype(bool)[:, None, :], 0.0, np.finfo(np.float32).min)
    want = np.asarray(jllama.llama_attention(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(bias.astype(np.float32)),
        jnp.asarray(cos), jnp.asarray(sin), jb, jnp.float32))
    tp = params_from_numpy(p, "cpu")
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    tc, ts = torch.from_numpy(cos), torch.from_numpy(sin)
    got = tllama.llama_attention(tp, tx, tm, tc, ts, tb, torch.float32).numpy()
    ref = tllama.score_attention(tp, tx, tllama.causal_mask_bias(tm), tc, ts, tb, torch.float32).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ref[valid], want[valid], atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", params=["qwen2", "llama"])
def decoder_params(request):
    jc, tc = gliclass_cfgs(request.param)
    params = _jitter(init_gliclass_params(jax.random.key(0), jc))
    return jc, tc, params, jax.tree.map(np.asarray, j_quantize_tree(params))


def _j_encode(params, ids, mask, cfg, dtype, act_q=False):
    with j_act_quant(act_q):
        return np.asarray(jllama.llama_encode(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                                              jnp.asarray(mask), cfg, dtype).astype(jnp.float32))


def _t_encode(params, ids, mask, cfg, dtype, act_q=False):
    with t_act_quant(act_q):
        return tllama.llama_encode(params_from_numpy(params, "cpu"), torch.from_numpy(ids),
                                   torch.from_numpy(mask), cfg, dtype).float().numpy()


@pytest.mark.parametrize("quantized", [False, True])
def test_llama_encode_fp32_matches_jax(decoder_params, quantized):
    jc, tc, params, qparams = decoder_params
    p = (qparams if quantized else params)["backbone"]
    ids, mask = make_batch()
    want = _j_encode(p, ids, mask, jc.backbone, jnp.float32)
    got = _t_encode(p, ids, mask, tc.backbone, torch.float32)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=1e-5)


def test_llama_encode_bf16_int8_dynamic_close_to_jax(decoder_params, monkeypatch):
    """bf16 w8a8. Against the JAX flash route (fp32 scores, as K5) the two
    differ only where one bf16 rounding (RoPE, silu, norms) moves an int8
    activation step; against the default XLA route (bf16 scores) by more.
    Bounds, relative to the largest hidden value: 3e-2 and 6e-2 (about 4
    and 8 bf16 ulps); measured on these tiny models: at most 1.0e-2 on
    either route."""
    jc, tc, _, qparams = decoder_params
    p = qparams["backbone"]
    ids, mask = make_batch()
    got = _t_encode(p, ids, mask, tc.backbone, torch.bfloat16, act_q=True)
    valid = mask.astype(bool)
    assert np.isfinite(got).all()
    for route, tol in (("flash", 3e-2), ("xla", 6e-2)):
        monkeypatch.setenv("GLICLASS_TPU_CAUSAL_ATTN", route)
        want = _j_encode(p, ids, mask, jc.backbone, jnp.bfloat16, act_q=True)
        err = np.abs(got[valid] - want[valid]).max() / np.abs(want[valid]).max()
        print(f"{route}: max|port - jax| / max|jax| = {err:.3e}")
        assert err < tol, route


def _j_probs(params, ids, mask, cfg, dtype, act_q=False):
    with j_act_quant(act_q):
        return np.asarray(j_probs(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                                  jnp.asarray(mask), cfg, 4, dtype))


def _t_probs(params, ids, mask, cfg, dtype, act_q=False):
    with t_act_quant(act_q):
        return t_probs(params_from_numpy(params, "cpu"), torch.from_numpy(ids),
                       torch.from_numpy(mask), cfg, 4, dtype).numpy()


@pytest.mark.parametrize("quantized", [False, True])
def test_gliclass_probs_fp32_matches_jax(decoder_params, quantized):
    jc, tc, params, qparams = decoder_params
    p = qparams if quantized else params
    ids, mask = make_batch()
    want = _j_probs(p, ids, mask, jc, jnp.float32)
    got = _t_probs(p, ids, mask, tc, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got[:, 3] == 0).all()  # padded label slot
    assert got[:, :3].std() > 1e-2  # the logits spread: the comparison bites


@pytest.mark.parametrize("quant_mode", ["int8-dynamic", "int8"])
def test_gliclass_probs_bf16_int8_close_to_jax(decoder_params, quant_mode):
    """bf16 INT8 end to end: 5e-2 on probabilities, the bound the DeBERTa
    slice uses (tests/test_torch_model.py)."""
    jc, tc, _, qparams = decoder_params
    ids, mask = make_batch()
    act_q = quant_mode == "int8-dynamic"
    want = _j_probs(qparams, ids, mask, jc, jnp.bfloat16, act_q)
    got = _t_probs(qparams, ids, mask, tc, torch.bfloat16, act_q)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 5e-2


def test_gliclass_forward_decoder_unported_head_raises(decoder_params):
    _, tc, params, _ = decoder_params
    ids, mask = make_batch()
    with pytest.raises(NotImplementedError, match="squeeze_layers"):
        t_forward(params_from_numpy(params, "cpu"), torch.from_numpy(ids), torch.from_numpy(mask),
                  dataclasses.replace(tc, squeeze_layers=True), 4)


def test_llama_tree_through_params_and_quantize_bit_equal(decoder_params):
    """The JAX llama tree goes through the port's generic params_from_numpy
    unchanged, and quantize_tree quantizes every dense layer bit-equal."""
    _, _, params, qparams = decoder_params
    got = t_quantize_tree(params)
    flat_g, flat_w = dict(_flatten(got)), dict(_flatten(qparams))
    assert flat_g.keys() == flat_w.keys()
    assert {k for k in flat_g if k.endswith("w_q")} >= {
        f"backbone/layers/{b}/{n}/w_q" for b, ns in (("attn", "qkvo"), ("mlp", ("gate", "up", "down")))
        for n in ns}
    assert "backbone/embeddings/word" in flat_g
    for k in flat_g:
        assert flat_g[k].dtype == flat_w[k].dtype, k
        np.testing.assert_array_equal(flat_g[k], flat_w[k])
    tp = params_from_numpy(got, "cpu")
    for k, v in _flatten(tp):
        assert isinstance(v, torch.Tensor) and tuple(v.shape) == flat_w[k].shape, k
        np.testing.assert_array_equal(v.numpy(), flat_w[k])


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v) if not isinstance(v, torch.Tensor) else v


def test_engine_keeps_decoders_unfused_and_pads_with_pad_token(decoder_params):
    jc, tc, params, _ = decoder_params
    tc = dataclasses.replace(tc, backbone=dataclasses.replace(tc.backbone, pad_token_id=5))
    eng = InferenceEngine(tc, params, tcfg.RuntimeConfig(batch_size=8, compute_dtype="float32",
                                                         fuse_qkv=True), device="cpu")
    assert "qkv" not in eng.params["backbone"]["layers"]["attn"]
    assert fuse_qkv_params(eng.params, tc) is eng.params
    ids, mask = make_batch(n=3)
    pids, pmask, n = eng._pad_batch(TokenizedBatch(ids, mask, mask.sum(1).astype(np.int32)))
    assert n == 3 and pids.shape[0] == 4
    assert pids[3, 0] == 5 and pmask[3].tolist() == [1] + [0] * (pmask.shape[1] - 1)
    probs = eng.run(TokenizedBatch(ids, mask, mask.sum(1).astype(np.int32)), 4)
    np.testing.assert_allclose(probs, _j_probs(params, ids, mask, jc, jnp.float32)[:3], atol=1e-5, rtol=1e-5)


RT = dict(batch_size=4, max_length=64, compute_dtype="float32",
          seq_buckets=(16, 32, 64), label_buckets=(2, 4, 8))

JOBS = [
    {"texts": ["the quick brown fox jumps over the lazy dog", "why are you running",
               "onnx is an open-source format for ai models", "support ukraine", "the lazy dog"],
     "labels": [["science", "sports", "format", "question"]], "same_labels": True,
     "classification_type": "multi-label"},
    {"texts": ["the quick brown fox", "why are you running", "support ukraine"],
     "labels": [["science", "sports"], ["question", "statement", "animal"], ["call to action"]],
     "same_labels": False, "classification_type": "single-label"},
]


@pytest.fixture(scope="module")
def qwen2_bundle(tiny_tokenizer_file, tmp_path_factory):
    """A tiny qwen2 fp32 + INT8 bundle written by the JAX package's converter
    (the tests/test_llama_parity.py model)."""
    from gliclass.c_tpu.convert.convert import export_bundle
    from gliclass.c_tpu.convert.torch_ref import build_torch_gliclass
    from gliclass.c_tpu.tokenization import PromptTokenizer as JTokenizer

    tok = JTokenizer.from_file(tiny_tokenizer_file)
    bb = jcfg.BackboneConfig(model_type="qwen2", vocab_size=600, hidden_size=32, num_hidden_layers=2,
                             num_attention_heads=4, num_key_value_heads=2, intermediate_size=64,
                             max_position_embeddings=64, attention_bias=True, hidden_act="silu")
    cfg = jcfg.GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                              text_token_index=tok.sep_token_id, prompt_first=False, backbone=bb)
    torch.manual_seed(0)
    path = str(tmp_path_factory.mktemp("qwen2_bundle") / "b")
    export_bundle(build_torch_gliclass(cfg), cfg, tok, path, quantize=True)
    return path


@pytest.mark.parametrize("quant_mode", ["none", "int8"])
@pytest.mark.parametrize("job_i", [0, 1])
def test_classify_job_qwen2_bundle_matches_jax(qwen2_bundle, quant_mode, job_i):
    """classify_job of the port and of the JAX package on one fp32 qwen2
    bundle: decisions exactly equal, probabilities to 1e-5."""
    from gliclass.c_tpu.config import RuntimeConfig as JRuntime
    from gliclass.c_tpu.data import parse_job as j_parse_job
    from gliclass.c_tpu.pipeline import ZeroShotClassificationPipeline as JPipeline
    from gliclass.c_tpu_torch.data import parse_job
    from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline

    jout = JPipeline.from_bundle(qwen2_bundle, JRuntime(quant_mode=quant_mode, **RT)).classify_job(
        j_parse_job(JOBS[job_i]))
    tpipe = ZeroShotClassificationPipeline.from_bundle(
        qwen2_bundle, tcfg.RuntimeConfig(quant_mode=quant_mode, **RT), device="cpu")
    assert tpipe.engine.cfg.backbone.model_type == "qwen2"
    tout = tpipe.classify_job(parse_job(JOBS[job_i]))
    assert tout.failures == [] and jout.failures == []
    np.testing.assert_allclose(tout.probs, jout.probs, atol=1e-5, rtol=1e-5)
    tj, jj = tout.to_json(), jout.to_json()
    assert [[(d["label"], d["index"]) for d in a["decisions"]] for a in tj] == [
        [(d["label"], d["index"]) for d in b["decisions"]] for b in jj]


def test_qwen2_bundle_golden_logits(qwen2_bundle):
    """The bundle's golden logits (the converter's fp32 transformers model)
    through the port's fp32 forward, at the reference's gate of 1e-3."""
    from gliclass.c_tpu_torch.convert import bundle as tbundle
    from gliclass.c_tpu_torch.prompting import pack_prompts
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    cfg = tbundle.load_config(qwen2_bundle)
    params = params_from_numpy(tbundle.load_params(qwen2_bundle), "cpu")
    tok = PromptTokenizer.from_file(tbundle.tokenizer_path(qwen2_bundle))
    recs = tbundle.load_goldens(qwen2_bundle)
    assert recs
    for rec in recs:
        prompts = pack_prompts(rec["texts"], rec["labels"], rec["same_labels"], rec["prompt_first"])
        b = tok.encode_batch(prompts, max_length=rec["max_length"])
        n = max(len(l) for l in rec["labels"])
        got = t_forward(params, torch.from_numpy(b.input_ids), torch.from_numpy(b.attention_mask), cfg, n).numpy()
        np.testing.assert_allclose(got, np.asarray(rec["logits"]), atol=1e-3)
