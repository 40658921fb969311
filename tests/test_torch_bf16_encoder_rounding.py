"""The port's bf16 DeBERTa encoder rounds where the JAX package's compiled
graph rounds.

XLA on the CPU runs a bf16 elementwise op in fp32 and rounds its result,
unless its result goes straight into an fp32 consumer: so the tanh
``jax.nn.gelu`` of the encoder's FFN rounds after each of its ops (the
constants too) and once more at the end; ``masked_softmax`` never rounds
exp (its source casts exp's result to fp32 for the sum and the quotient);
the projectors' last bias sums reach the simple scorer's fp32 product
unrounded; and the score path's ``x / scale`` divides by the scale
rounded to bf16 (a Python float meets a bf16 array), as a product with
that divisor's fp32 reciprocal. A gelu rounded once, a rounded exp or sum,
or a division by the fp32 scale each moves a share of the outputs by a
bf16 step (``PERF.md`` §6).

Each block test feeds the same bf16 inputs and parameters (JAX-initialised,
biases and norm parameters jittered so that every add is exercised) to one
block of both packages, the JAX side jitted as its engine runs it, and
asserts the outputs equal bit for bit, on a tiny DeBERTa-v3 and a tiny
DeBERTa-v2 with the conv stem (``tests/test_torch_model.py``'s geometry).
What no rounding placement repairs, the order of the fp32 sums in the two
CPUs' matmuls and norms, moves no bf16 result at these widths (at
gliclass-base width it moves 0.001-0.02% of a block's outputs, and with
them later layers: ``scripts/encoder_rounding_compare.py``, ``PERF.md``
§6). The whole encoder and the probabilities run on the JAX package's CPU
route, the score path (the port's ``attn_route="xla"``); the port's own
CPU route is K1's plain version, which keeps fp32 scores as the TPU kernel
does (held to the Pallas kernel in ``tests/test_torch_attention.py``). The
decoders share the score path's softmax and division and the head: the
last test holds tiny qwen2 and llama to the JAX package's XLA route.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gliclass.c_tpu.models import deberta as jdeb
from gliclass.c_tpu.models.gliclass import gliclass_probs as j_probs
from gliclass.c_tpu.models.gliclass import init_gliclass_params
from gliclass.c_tpu.ops import fused_ffn as jffn
from gliclass.c_tpu.ops import layers as jl
from gliclass.c_tpu_torch.convert.params import params_from_numpy
from gliclass.c_tpu_torch.models import deberta as tdeb
from gliclass.c_tpu_torch.models.gliclass import gliclass_probs as t_probs
from gliclass.c_tpu_torch.ops import fused_ffn as tffn
from gliclass.c_tpu_torch.ops import layers as tl

from test_torch_model import make_batch, tiny_cfgs

BF, TBF = jnp.bfloat16, torch.bfloat16
CONV = {"conv_kernel_size": 3, "conv_act": "gelu"}


def _cfgs(variant):
    jc, tc = tiny_cfgs()
    if variant == "v2-conv":
        jc = dataclasses.replace(jc, backbone=dataclasses.replace(jc.backbone, **CONV))
        tc = dataclasses.replace(tc, backbone=dataclasses.replace(tc.backbone, **CONV))
    return jc, tc


@pytest.fixture(scope="module", params=["v3", "v2-conv"])
def model(request):
    """Both packages' configs, the parameter tree (numpy; biases and norm
    parameters jittered, head weights scaled so that the logits spread)
    and the port's tensors."""
    jc, tc = _cfgs(request.param)
    rng = np.random.default_rng(1)

    def jitter(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith(("['b']", "['bias']", "['scale']")):
            return (a + rng.normal(0, 0.02, a.shape)).astype(np.float32)
        if name.startswith("['head']") and name.endswith("['w']"):
            return a * 12.0
        return a

    params = jax.tree_util.tree_map_with_path(
        jitter, jax.tree.map(np.asarray, init_gliclass_params(jax.random.key(0), jc)))
    return jc, tc, params, params_from_numpy(params, "cpu")


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(_f32(a))).to(TBF)


def _equal(name, got, want):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, name
    n = int((got != want).sum())
    assert n == 0, f"{name}: {n} of {got.size} bf16 outputs differ (max |d| {np.abs(got - want).max():.3e})"


def _layer0(p):
    return jax.tree.map(lambda a: a[0], p)


@pytest.mark.parametrize("name", ["gelu", "gelu_new", "gelu_pytorch_tanh"])
def test_reduced_precision_gelu_bit_equal_to_jax(name):
    """bf16 ``activation(name)`` equals the JAX package's jitted activation
    on 4,096 values, every element: the tanh form op by op (rounded once
    from fp32 it differs in 42% of them); fp32 keeps its one-op forms, the
    erf gelu for "gelu"."""
    x = np.random.default_rng(8).normal(0, 3, size=(4096,)).astype(np.float32)
    xb = jnp.asarray(x).astype(BF)
    got = tl.activation(name)(_t(xb))
    assert got.dtype == TBF
    _equal(name, got, jax.jit(jl.activation(name))(xb))
    fp32 = torch.nn.functional.gelu if name == "gelu" else tl.gelu_tanh
    assert torch.equal(tl.activation(name)(torch.from_numpy(x)), fp32(torch.from_numpy(x)))


def test_layer_outside_attention_bit_equal_to_jax(model):
    """Layer 0's blocks outside attention, each fed the same bf16 inputs
    in both packages (the JAX package's output of the block before):
    embeddings, q/k/v projections, ``rel_ln`` and the position
    projections, the attention's post-LN of the fp32 sum, the FFN's up
    product, gelu and down product and the whole FFN, its post-LN, and the
    conv stem (v2)."""
    jc, tc, params, tp = model
    cfg, tcfg, eps = jc.backbone, tc.backbone, jc.backbone.layer_norm_eps
    jp, tb = jax.tree.map(jnp.asarray, params["backbone"]), tp["backbone"]
    lj, lt = _layer0(jp["layers"]), tdeb._layer(tb["layers"], 0)
    ids, mask = make_batch()
    jids, jmask, tids, tmask = jnp.asarray(ids), jnp.asarray(mask), torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.inference_mode():
        x = jax.jit(lambda p, i, m: jdeb.embed(p, i, m, cfg, BF))(jp["embeddings"], jids, jmask)
        _equal("embeddings", tdeb.embed(tb["embeddings"], tids, tmask, tcfg, TBF), x)
        lin = jax.jit(lambda w, a: jl.linear(w, a, BF))
        rel = jax.jit(lambda p, r: jl.layer_norm(p, r.astype(BF), eps))(jp["rel_ln"], jp["rel_embeddings"])
        _equal("rel_ln", tl.layer_norm(tb["rel_ln"], tb["rel_embeddings"].to(TBF), eps), rel)
        for n in ("q", "k", "v"):
            _equal(f"{n} projection", tl.linear(lt["attn"][n], _t(x), TBF), lin(lj["attn"][n], x))
            _equal(f"{n} position projection", tl.linear(lt["attn"][n], _t(rel), TBF), lin(lj["attn"][n], rel))
        # Attention's output: the JAX package's, a fixed bf16 input here.
        a = jax.jit(lambda p, x, r: jdeb.disentangled_attention(
            p, x, r, jmask.astype(bool)[:, :, None] & jmask.astype(bool)[:, None, :],
            *(jnp.asarray(c) for c in jdeb.rel_bias_columns(ids.shape[1], cfg.position_buckets,
                                                             cfg.position_buckets, cfg.max_position_embeddings)),
            cfg, BF, key_mask=jmask))(lj["attn"], x, rel)
        y = jax.jit(lambda p, a, x: jl.layer_norm(p, a + x, eps))(lj["attn"]["ln"], a, x)
        _equal("attention post-LN", tl.layer_norm(lt["attn"]["ln"], _t(a), eps, residual=_t(x)), y)
        h = lin(lj["ffn"]["up"], y)
        _equal("FFN up", tl.linear(lt["ffn"]["up"], _t(y), TBF), h)
        g = jax.jit(jl.activation(cfg.hidden_act))(h)
        _equal("FFN gelu", tl.activation(cfg.hidden_act)(_t(h)), g)
        _equal("FFN down", tl.linear(lt["ffn"]["down"], _t(g), TBF), lin(lj["ffn"]["down"], g))
        f = jax.jit(lambda p, y: jffn.fused_ffn(p["up"], p["down"], y, cfg.hidden_act, BF))(lj["ffn"], y)
        _equal("FFN", tffn.fused_ffn(lt["ffn"]["up"], lt["ffn"]["down"], _t(y), cfg.hidden_act, TBF), f)
        z = jax.jit(lambda p, f, y: jl.layer_norm(p, f + y, eps))(lj["ffn"]["ln"], f, y)
        _equal("FFN post-LN", tl.layer_norm(lt["ffn"]["ln"], _t(f), eps, residual=_t(y)), z)
        if cfg.conv_kernel_size:
            c = jax.jit(lambda p, x, z, m: jdeb.conv_layer(p, x, z, m, cfg, BF))(jp["conv"], x, z, jmask)
            _equal("conv stem", tdeb.conv_layer(tb["conv"], _t(x), _t(z), tmask, tcfg, TBF), c)


def test_score_attention_bit_equal_to_jax(model):
    """The attention block on the score path (the JAX package's route on
    the CPU, the port's "table"/"xla" routes) on the same bf16 input:
    scores divided by the bf16 scale as a product with its fp32
    reciprocal, exp unrounded; every valid row equal bit for bit."""
    jc, tc, params, tp = model
    cfg = jc.backbone
    jp, tb = jax.tree.map(jnp.asarray, params["backbone"]), tp["backbone"]
    ids, mask = make_batch()
    S = ids.shape[1]
    x = jax.jit(lambda p, i, m: jdeb.embed(p, i, m, cfg, BF))(jp["embeddings"], jnp.asarray(ids), jnp.asarray(mask))
    rel = jax.jit(lambda p, r: jl.layer_norm(p, r.astype(BF), cfg.layer_norm_eps))(jp["rel_ln"], jp["rel_embeddings"])
    c2p, p2c = jdeb.rel_bias_columns(S, cfg.position_buckets, cfg.position_buckets, cfg.max_position_embeddings)
    mb = jnp.asarray(mask).astype(bool)
    want = jax.jit(lambda p, x, r: jdeb.disentangled_attention(
        p, x, r, mb[:, :, None] & mb[:, None, :], jnp.asarray(c2p), jnp.asarray(p2c), cfg, BF,
        key_mask=jnp.asarray(mask)))(_layer0(jp["layers"])["attn"], x, rel)
    tmb = torch.from_numpy(mask).bool()
    with torch.inference_mode():
        got = tdeb.score_attention(tdeb._layer(tb["layers"], 0)["attn"], _t(x), _t(rel),
                                   tmb[:, :, None] & tmb[:, None, :], torch.from_numpy(c2p.astype(np.int64)),
                                   torch.from_numpy(p2c.astype(np.int64)), tc.backbone, TBF)
    valid = mask.astype(bool)
    _equal("score attention (valid rows)", _f32(got)[valid], _f32(want)[valid])


def test_encoder_bf16_matches_jax(model):
    """The whole plain-bf16 encoder (2 layers; the v2 with the conv stem
    after layer 0) on the JAX package's CPU route, the score path: the
    share of valid hidden states that differ from the JAX package's jitted
    ``deberta_encode`` is 0 at every layer (bound: 0)."""
    jc, tc, params, tp = model
    ids, mask = make_batch()
    want = jax.jit(lambda p, i, m: jdeb.deberta_encode(p, i, m, jc.backbone, BF, return_all_layers=True))(
        jax.tree.map(jnp.asarray, params["backbone"]), jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        got = tdeb.deberta_encode(tp["backbone"], torch.from_numpy(ids), torch.from_numpy(mask), tc.backbone, TBF,
                                  attn_route="xla", return_all_layers=True)
    valid = mask.astype(bool)
    for i in range(got.shape[0]):
        share = float(np.mean(_f32(got[i])[valid] != _f32(want[i])[valid]))
        assert share == 0.0, f"states {i}: {share:.4%} of the valid hidden states differ"


def test_probs_bf16_plain_matches_jax(model):
    """Plain bf16 probabilities (no INT8) on the score path: the port's
    equal the JAX package's jitted ``gliclass_probs`` to fp32 rounding
    (the head's fp32 logits, then the sigmoid; bound 1e-6)."""
    jc, tc, params, tp = model
    ids, mask = make_batch()
    want = np.asarray(jax.jit(lambda p, i, m: j_probs(p, i, m, jc, 4, BF))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        got = t_probs(tp, torch.from_numpy(ids), torch.from_numpy(mask), tc, 4, TBF, attn_route="xla").numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("model_type", ["qwen2", "llama"])
def test_decoder_score_route_bf16_bit_equal_to_jax(model_type, monkeypatch):
    """The decoders share the score path's rounding (``ops.layers.divide``,
    ``masked_softmax``) and the head's: plain bf16 on the XLA route (the
    JAX package's GLICLASS_TPU_CAUSAL_ATTN=xla, the port's
    ``attn_route="xla"``), tiny qwen2 and llama. Every valid hidden state
    equal bit for bit (36% differ with the fp32 scale and a rounded exp), the
    probabilities to fp32 rounding (bound 1e-6)."""
    from gliclass.c_tpu.models import llama as jllama
    from gliclass.c_tpu_torch.models import llama as tllama

    from test_torch_llama import _jitter, gliclass_cfgs
    from test_torch_llama import make_batch as decoder_batch

    monkeypatch.setenv("GLICLASS_TPU_CAUSAL_ATTN", "xla")
    jc, tc = gliclass_cfgs(model_type)
    params = jax.tree.map(np.asarray, _jitter(init_gliclass_params(jax.random.key(0), jc)))
    tp, jp = params_from_numpy(params, "cpu"), jax.tree.map(jnp.asarray, params)
    ids, mask = decoder_batch()
    jids, jmask, tids, tmask = jnp.asarray(ids), jnp.asarray(mask), torch.from_numpy(ids), torch.from_numpy(mask)
    want = jax.jit(lambda p, i, m: jllama.llama_encode(p, i, m, jc.backbone, BF))(jp["backbone"], jids, jmask)
    wantp = np.asarray(jax.jit(lambda p, i, m: j_probs(p, i, m, jc, 4, BF))(jp, jids, jmask))
    with torch.inference_mode():
        got = tllama.llama_encode(tp["backbone"], tids, tmask, tc.backbone, TBF, attn_route="xla")
        gotp = t_probs(tp, tids, tmask, tc, 4, TBF, attn_route="xla").numpy()
    valid = mask.astype(bool)
    _equal("hidden states (valid)", _f32(got)[valid], _f32(want)[valid])
    np.testing.assert_allclose(gotp, wantp, atol=1e-6, rtol=0)
