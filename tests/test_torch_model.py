"""The port's encoder, head, full model and engine vs the JAX package, on CPU.

Both packages get the same parameters: JAX-initialised, moved to numpy, and
handed to the port through ``params_from_numpy``. Tolerances: fp32 (fp or INT8
weight-only) at 1e-5 on probabilities; bf16 INT8 at 5e-2 on probabilities, the
JAX package's own bf16-vs-fp32 bound (tests/test_engine.py). Plain bf16 rounds
where the JAX package's jitted graph rounds, bit for bit on these geometries
(tests/test_torch_bf16_encoder_rounding.py); with INT8 weights the two differ
by design: in ``int8-dynamic`` K2's plain version keeps the FFN intermediate in
fp32 as the TPU kernel does (the JAX package's CPU composes the bf16 path),
weight-only INT8 scales the fp32 accumulator as the Pallas kernel does, the
port's CPU route is K1's plain version (fp32 scores, as the TPU kernel) where
the JAX package's CPU takes its score path, and an int8 activation step can
move with them. Measured on this tiny model: port vs JAX 2.1e-3 in
``int8-dynamic`` and 1.3e-2 in ``int8``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gliclass.c_tpu import config as jcfg
from gliclass.c_tpu.engine import InferenceEngine as JEngine
from gliclass.c_tpu.models.deberta import deberta_encode as j_encode
from gliclass.c_tpu.models.gliclass import gliclass_probs as j_probs
from gliclass.c_tpu.models.gliclass import init_gliclass_params
from gliclass.c_tpu.ops.layers import act_quant as j_act_quant
from gliclass.c_tpu.ops.quant import quantize_tree as j_quantize_tree
from gliclass.c_tpu.tokenization import TokenizedBatch as JBatch
from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.convert.params import params_from_numpy
from gliclass.c_tpu_torch.engine import InferenceEngine, fuse_qkv_params
from gliclass.c_tpu_torch.models.deberta import deberta_encode as t_encode
from gliclass.c_tpu_torch.models.gliclass import gliclass_forward as t_forward
from gliclass.c_tpu_torch.models.gliclass import gliclass_probs as t_probs
from gliclass.c_tpu_torch.ops.layers import act_quant as t_act_quant
from gliclass.c_tpu_torch.tokenization import TokenizedBatch

CLASS_TOKEN = 7


def tiny_cfgs(**over):
    """The same tiny config in both packages (tests/test_engine.py geometry)."""
    bb = dict(
        model_type="deberta-v2", vocab_size=200, hidden_size=32,
        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=128, position_buckets=16,
        norm_rel_ebd="layer_norm", share_att_key=True, position_biased_input=False,
    )
    kw = dict(hidden_size=32, class_token_index=CLASS_TOKEN)
    kw.update(over)
    return (
        jcfg.GLiClassConfig(backbone=jcfg.BackboneConfig(**bb), **kw),
        tcfg.GLiClassConfig(backbone=tcfg.BackboneConfig(**bb), **kw),
    )


def make_batch(n=4, s=24, labels=3, seed=0):
    """Ragged batch: row i has s - 3*i valid tokens, label tokens at 1, 3, 5."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 190, size=(n, s)).astype(np.int32)
    for k in range(labels):
        ids[:, 1 + 2 * k] = CLASS_TOKEN
    mask = np.zeros((n, s), dtype=np.int32)
    for i in range(n):
        mask[i, : s - 3 * i] = 1
    ids[mask == 0] = 0
    return ids, mask


@pytest.fixture(scope="module")
def np_params():
    jc, _ = tiny_cfgs()
    params = jax.tree.map(np.asarray, init_gliclass_params(jax.random.key(0), jc))
    # Non-zero biases and norm offsets, so every add is exercised; head
    # weights scaled up so the logits spread over O(1) instead of sitting at 0.
    rng = np.random.default_rng(1)

    def jitter(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['b']") or name.endswith("['bias']"):
            return (a + rng.normal(0, 0.02, a.shape)).astype(np.float32)
        if name.startswith("['head']") and name.endswith("['w']"):
            return a * 12.0
        return a

    params = jax.tree_util.tree_map_with_path(jitter, params)
    return params, jax.tree.map(np.asarray, j_quantize_tree(params))


def _jax_probs(params, ids, mask, cfg, dtype, act_q=False):
    with j_act_quant(act_q):
        return np.asarray(j_probs(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                                  jnp.asarray(mask), cfg, 4, dtype))


def _torch_probs(params, ids, mask, cfg, dtype, act_q=False):
    with t_act_quant(act_q):
        return t_probs(params_from_numpy(params, "cpu"), torch.from_numpy(ids),
                       torch.from_numpy(mask), cfg, 4, dtype).numpy()


@pytest.mark.parametrize("quantized", [False, True])
def test_encode_fp32_matches_jax(np_params, quantized):
    jc, tc = tiny_cfgs()
    params = np_params[1 if quantized else 0]["backbone"]
    ids, mask = make_batch()
    want = np.asarray(j_encode(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                               jnp.asarray(mask), jc.backbone, jnp.float32))
    got = t_encode(params_from_numpy(params, "cpu"), torch.from_numpy(ids),
                   torch.from_numpy(mask), tc.backbone, torch.float32).numpy()
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("quantized", [False, True])
def test_probs_fp32_matches_jax(np_params, quantized):
    jc, tc = tiny_cfgs()
    params = np_params[1 if quantized else 0]
    ids, mask = make_batch()
    # fp32 turns w8a8 off in both packages, so the INT8 case is weight-only.
    want = _jax_probs(params, ids, mask, jc, jnp.float32, act_q=True)
    got = _torch_probs(params, ids, mask, tc, torch.float32, act_q=True)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert (got[:, 3] == 0).all()  # padded label slot: exactly 0


@pytest.mark.parametrize("quant_mode", ["int8-dynamic", "int8"])
def test_probs_bf16_int8_close_to_jax(np_params, quant_mode):
    jc, tc = tiny_cfgs()
    ids, mask = make_batch()
    act_q = quant_mode == "int8-dynamic"
    want = _jax_probs(np_params[1], ids, mask, jc, jnp.bfloat16, act_q)
    got = _torch_probs(np_params[1], ids, mask, tc, torch.bfloat16, act_q)
    err = float(np.abs(got - want).max())
    print(f"bf16 {quant_mode}: max|port - jax| on probabilities = {err:.3e}, "
          f"probabilities in [{want.min():.3f}, {want[:, :3].max():.3f}]")
    assert np.isfinite(got).all()
    assert err < 5e-2
    fp32 = _jax_probs(np_params[1], ids, mask, jc, jnp.float32)
    assert np.abs(got - fp32).max() < 5e-2


@pytest.mark.parametrize("head_over", [
    {"normalize_features": True},
    {"pooling_strategy": "mean"},
    {"extract_text_features": True, "text_token_index": 9},
])
def test_head_variants_fp32_match_jax(np_params, head_over):
    jc, tc = tiny_cfgs(**head_over)
    params = dict(np_params[0], head=dict(np_params[0]["head"], logit_scale=np.float32(0.7)))
    ids, mask = make_batch()
    ids[:, 8] = 9
    np.testing.assert_allclose(
        _torch_probs(params, ids, mask, tc, torch.float32),
        _jax_probs(params, ids, mask, jc, jnp.float32), atol=1e-5, rtol=1e-5,
    )


@pytest.mark.parametrize("over,exc", [
    ({"architecture_type": "bi-encoder"}, ValueError),
])
def test_unported_features_raise(np_params, over, exc):
    _, tc = tiny_cfgs(**over)
    ids, mask = make_batch()
    with pytest.raises(exc):
        t_forward(params_from_numpy(np_params[0], "cpu"), torch.from_numpy(ids),
                  torch.from_numpy(mask), tc, 4)


def test_decoder_backbone_raises(np_params):
    """Decoder backbones run (tests/test_torch_llama.py); an unknown backbone
    raises."""
    _, tc = tiny_cfgs()
    ids, mask = make_batch()
    args = (params_from_numpy(np_params[0], "cpu"), torch.from_numpy(ids), torch.from_numpy(mask))
    bad = dataclasses.replace(tc, backbone=dataclasses.replace(tc.backbone, model_type="t5"))
    with pytest.raises(ValueError, match="t5"):
        t_forward(*args, bad, 4)


def test_fuse_qkv_is_math_identical(np_params):
    jc, tc = tiny_cfgs()
    ids, mask = make_batch()
    p = params_from_numpy(np_params[1], "cpu")
    fused = fuse_qkv_params(p, tc)
    assert "qkv" in fused["backbone"]["layers"]["attn"] and "q" not in fused["backbone"]["layers"]["attn"]
    args = (torch.from_numpy(ids), torch.from_numpy(mask), tc, 4, torch.float32)
    np.testing.assert_allclose(t_probs(fused, *args).numpy(), t_probs(p, *args).numpy(),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n,batch_size", [(1, 8), (3, 8), (5, 8), (8, 8), (5, 6), (11, 6)])
def test_row_bucket_and_padding_match_jax(np_params, n, batch_size):
    jc, tc = tiny_cfgs()
    jrt = jcfg.RuntimeConfig(batch_size=batch_size, compute_dtype="float32")
    trt = tcfg.RuntimeConfig(batch_size=batch_size, compute_dtype="float32")
    je = JEngine(jc, np_params[0], jrt)
    te = InferenceEngine(tc, np_params[0], trt, device="cpu")
    ids, mask = make_batch(n=n, s=16)
    lens = mask.sum(1).astype(np.int32)
    assert te._row_bucket(n) == je._row_bucket(n)
    for a, b in zip(te._pad_batch(TokenizedBatch(ids, mask, lens)),
                    je._pad_batch(JBatch(ids, mask, lens))):
        np.testing.assert_array_equal(a, b)


def test_engine_run_matches_jax_ragged(np_params):
    """Engine-level: a ragged 3-row batch (row-bucketed to 4), INT8 fp32."""
    jc, tc = tiny_cfgs()
    ids, mask = make_batch(n=3)
    lens = mask.sum(1).astype(np.int32)
    je = JEngine(jc, np_params[1], jcfg.RuntimeConfig(compute_dtype="float32", quant_mode="int8"))
    te = InferenceEngine(tc, np_params[1], tcfg.RuntimeConfig(compute_dtype="float32", quant_mode="int8"),
                         device="cpu")
    want = je.run(JBatch(ids, mask, lens), max_labels=4)
    got = te.run(TokenizedBatch(ids, mask, lens), max_labels=4)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # stacked launches equal single ones
    sids, smask, rows = te.stack_batches([TokenizedBatch(ids, mask, lens)] * 2)
    stacked = te.run_stacked_async(sids, smask, 4).numpy()
    assert rows == [3, 3]
    np.testing.assert_allclose(stacked[1, :3], got, atol=1e-6)


def test_engine_without_device_needs_cuda(np_params):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves to it")
    _, tc = tiny_cfgs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(tc, np_params[0])


def test_engine_refuses_multi_device_runtime(np_params):
    _, tc = tiny_cfgs()
    # Without a process group a multi-rank mesh is refused, naming the
    # launcher's variables: a tensor-parallel one and a sequence-parallel one
    # alike (the sp axis counts in the mesh's size, dp x sp x tp).
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 1; launch 2 processes with .*MASTER_ADDR"):
        InferenceEngine(tc, np_params[0], tcfg.RuntimeConfig(tp_size=2), device="cpu")
    with pytest.raises(ValueError, match="mesh 1x2x1 needs 2 ranks, the world has 1; launch 2 processes"):
        InferenceEngine(tc, np_params[0], tcfg.RuntimeConfig(sp_size=2), device="cpu")
