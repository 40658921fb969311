"""The port's bias route (K6 tables, bias products, K7) vs the JAX package, on CPU.

On the CPU the port runs the kernels' plain versions; the JAX side runs its
Pallas kernels in interpret mode (``_table_build_kernel`` where S divides
the block, ``_bias_kernel`` always) and its XLA one-hot table builder for
other S. Tolerances: the table exactly (a copy of values); attention and
probabilities at fp32 1e-5 on valid query rows; bf16 biases at 5e-2, the
bound of tests/test_fused_attention.py for the bf16 score store.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gliclass.c_tpu import config as jcfg
from gliclass.c_tpu.models.gliclass import gliclass_probs as j_probs
from gliclass.c_tpu.models.gliclass import init_gliclass_params
from gliclass.c_tpu.ops import fused_attention as JFA
from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.convert.params import params_from_numpy
from gliclass.c_tpu_torch.models.gliclass import gliclass_probs as t_probs
from gliclass.c_tpu_torch.ops import fused_attention as FA

B, H, D = 2, 3, 8


def _inputs(S, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(3))
    pk, pq = (rng.normal(size=(H, 2 * S - 1, D)).astype(np.float32) for _ in range(2))
    mask = np.ones((B, S), dtype=np.int32)
    mask[1, S - 3:] = 0  # padded keys
    return q, k, v, pk, pq, mask


def _valid_rows(out, ref, mask, tol):
    for b in range(B):
        rows = mask[b].astype(bool)
        np.testing.assert_allclose(out[b][:, rows], ref[b][:, rows], atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,blk", [(16, 8), (12, 8), (24, 8)])  # 16: the Pallas builder; 12, 24: XLA
def test_abs_pos_table_equals_jax(S, blk, dtype):
    pos = np.random.default_rng(S).normal(size=(H, 2 * S - 1, D)).astype(np.float32)
    want = np.asarray(JFA.abs_pos_table(jnp.asarray(pos, dtype=dtype), S, blk=blk).astype(jnp.float32))
    got = FA.abs_pos_table(torch.from_numpy(pos).to(getattr(torch, dtype)), S)
    assert tuple(got.shape) == (H, S, D, S)  # the port's [h, x, d, y] layout
    np.testing.assert_array_equal(got.permute(0, 2, 1, 3).float().numpy(), want)


@pytest.mark.parametrize("S", [16, 24])
def test_bias_fused_attention_matches_jax(S):
    q, k, v, _, _, mask = _inputs(S, 1)
    rng = np.random.default_rng(2)
    c2p, p2c = (rng.normal(size=(B, H, S, S)).astype(np.float32) for _ in range(2))
    scale = math.sqrt(3 * D)
    want = np.asarray(JFA.bias_fused_attention(*map(jnp.asarray, (q, k, v, c2p, p2c, mask)), scale))
    got = FA.bias_fused_attention(*map(torch.from_numpy, (q, k, v, c2p, p2c, mask)), scale).numpy()
    _valid_rows(got, want, mask, 1e-5)


@pytest.mark.parametrize("S,blk", [(16, 8), (24, 128)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_table_bias_attention_matches_jax(S, blk, dtype, tol, monkeypatch):
    """The whole route, with JAX's softmax back half fixed to the Pallas
    kernel; in bf16 the inputs and the stored biases are bf16 in both."""
    monkeypatch.setenv("GLICLASS_TPU_BIAS_SOFTMAX", "pallas")
    arrays = _inputs(S, 3)
    mask = arrays[-1]
    scale = math.sqrt(3 * D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JFA.table_bias_attention(
        *(jnp.asarray(a, dtype=jdt) for a in arrays[:5]), jnp.asarray(mask), scale,
        score_dtype=jdt, blk=blk,
    )
    got = FA.table_bias_attention(
        *(torch.from_numpy(a).to(tdt) for a in arrays[:5]), torch.from_numpy(mask), scale, score_dtype=tdt,
    )
    _valid_rows(got.float().numpy(), np.asarray(want.astype(jnp.float32)), mask, tol)


def test_table_bias_route_equals_flash_route():
    """The two routes compute one function: at fp32 on valid rows they agree
    as two orders of fp32 sums do."""
    q, k, v, pk, pq, mask = map(torch.from_numpy, _inputs(40, 4))
    scale = math.sqrt(3 * D)
    a = FA.table_bias_attention(q, k, v, pk, pq, mask, scale).numpy()
    b = FA.flash_disentangled_attention(q, k, v, pk, pq, mask, scale).numpy()
    _valid_rows(a, b, mask.numpy(), 1e-5)


def test_attention_route_predicate():
    route = FA.attention_route
    # forced values win: flash anywhere, bias at any 8-aligned S (else the default)
    for S, Bt in ((56, 1), (512, 128), (2048, 4)):
        assert route(S, Bt, 64, "flash") == "flash"
        assert route(S, Bt, 64, "bias") == "bias"
    assert route(90, 4, 64, "bias") == "flash"
    assert route(96, 4, 12, "bias") == "flash"
    # auto: the measured H100 rule (ops/fused_attention.py _auto_bias):
    # bias only in the 512 bucket from 64 rows on
    for S in (56, 128, 384, 1024, 2048):
        for Bt in (1, 16, 128):
            assert route(S, Bt, 64) == "flash", (S, Bt)
    for Bt, want in ((1, "flash"), (16, "flash"), (32, "flash"), (64, "bias"), (128, "bias")):
        assert route(512, Bt, 64) == want, Bt
    # not ported: raise, never substitute another route
    for bad in ("row", "tiled"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            route(512, 128, 64, bad)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tcfg.RuntimeConfig(attn_route=bad)
    with pytest.raises(ValueError):
        route(512, 128, 64, "xla")


def _tiny(S):
    bb = dict(
        model_type="deberta-v2", vocab_size=200, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64, max_position_embeddings=128,
        position_buckets=16, norm_rel_ebd="layer_norm", share_att_key=True,
        position_biased_input=False,
    )
    kw = dict(hidden_size=32, class_token_index=7)
    jc = jcfg.GLiClassConfig(backbone=jcfg.BackboneConfig(**bb), **kw)
    tc = tcfg.GLiClassConfig(backbone=tcfg.BackboneConfig(**bb), **kw)
    rng = np.random.default_rng(S)
    ids = rng.integers(10, 190, size=(3, S)).astype(np.int32)
    ids[:, 1:6:2] = 7
    mask = np.ones((3, S), dtype=np.int32)
    mask[1, S - 5:] = 0
    mask[2, S // 2:] = 0
    ids[mask == 0] = 0
    return jc, tc, ids, mask


@pytest.mark.parametrize("S", [40, 48])
def test_gliclass_probs_bias_route_matches_jax(S, monkeypatch):
    """A tiny DeBERTa through the bias route in both packages (JAX forced by
    GLICLASS_TPU_ATTN_ROUTE=bias, the port by its attn_route), fp32."""
    jc, tc, ids, mask = _tiny(S)
    params = jax.tree.map(np.asarray, init_gliclass_params(jax.random.key(3), jc))
    monkeypatch.setenv("GLICLASS_TPU_ATTN_ROUTE", "bias")
    monkeypatch.setenv("GLICLASS_TPU_BIAS_SOFTMAX", "pallas")
    assert JFA.use_bias_route(S, 8, jnp.float32, 3)
    want = np.asarray(j_probs(params, jnp.asarray(ids), jnp.asarray(mask), jc, 4))
    tp = params_from_numpy(params, "cpu")
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    got = t_probs(tp, ti, tm, tc, 4, attn_route="bias").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    flash = t_probs(tp, ti, tm, tc, 4, attn_route="flash").numpy()
    np.testing.assert_allclose(got, flash, atol=1e-5, rtol=1e-5)
