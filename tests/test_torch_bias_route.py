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
    # auto: the measured H100 rule (ops/fused_attention.py _auto_route): with
    # K1 on tensor cores row won [8, 512] in two measurement runs and no
    # other route won it, so it takes row; every other shape takes K1
    for S in (56, 72, 88, 128, 384, 512, 1024, 2048):
        for Bt in (1, 8, 16, 32, 64, 128, 256):
            assert route(S, Bt, 64) == ("row" if (S, Bt) == (512, 8) else "flash"), (S, Bt)
    assert route(512, 8, 12) == "flash"  # the row kernel needs head_dim % 8 == 0
    assert route(512, 16, 12) == "flash"
    # row (K8) and tiled (K9 + K10) where their kernels take the shape, else
    # K1; the runtime config accepts both
    for forced, ok, not_ok in (("row", (56, 512), (1024, 90)), ("tiled", (128, 2048), (56, 88))):
        for S in ok:
            assert route(S, 128, 64, forced) == forced, (forced, S)
        for S in not_ok:
            assert route(S, 128, 64, forced) == "flash", (forced, S)
        assert tcfg.RuntimeConfig(attn_route=forced).attn_route == forced
    # "table" and "xla" force the score path at any length; unknown names raise
    assert route(512, 128, 64, "xla") == route(90, 4, 64, "table") == "score"
    with pytest.raises(ValueError):
        route(512, 128, 64, "bogus")


ROUTES = ("auto", "flash", "bias", "row", "tiled", "table", "xla")


@pytest.mark.parametrize("route", ROUTES)
def test_attention_route_at_other_head_widths(route):
    """On a CUDA device a head width other than the kernels' 64 takes the
    score path under every route (the kernel wrappers refuse it); on the CPU,
    where the plain versions take any width, the route is what it is at 64
    (save the kernels' 8-alignment), and at width 64 the device changes
    nothing."""
    for S, Bt in ((40, 3), (56, 128), (512, 16), (512, 64), (90, 4), (2048, 2)):
        for d in (8, 12, 32, 128):
            assert FA.attention_route(S, Bt, d, route, "cuda") == "score", (S, Bt, d)
            assert FA.attention_route(S, Bt, d, route, torch.device("cuda", 0)) == "score", (S, Bt, d)
            assert FA.attention_route(S, Bt, d, route, "cpu") == FA.attention_route(S, Bt, d, route), (S, Bt, d)
        assert FA.attention_route(S, Bt, 8, route, "cpu") == FA.attention_route(S, Bt, 64, route), (S, Bt)
        for dev in ("cuda", "cpu", None):
            assert FA.attention_route(S, Bt, 64, route, dev) == FA.attention_route(S, Bt, 64, route), (S, Bt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_bias_fused_attention_cpu_runs_plain_and_counts_nothing(dtype, bias_dtype):
    """On CPU tensors K7's wrapper runs its plain version in every type
    combination and counts no launch of either variant; the variant its
    types would take on the card is the tensor-core one for bf16 with bf16
    biases only."""
    q, k, v, _, _, mask = map(torch.from_numpy, _inputs(24, 5))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    rng = np.random.default_rng(6)
    c2p, p2c = (torch.from_numpy(rng.normal(size=(B, H, 24, 24)).astype(np.float32)).to(bias_dtype) for _ in range(2))
    before = FA.launches_bias, FA.launches_bias_tc
    got = FA.bias_fused_attention(q, k, v, c2p, p2c, mask, 5.0)
    assert (FA.launches_bias, FA.launches_bias_tc) == before
    assert torch.equal(got, FA.bias_fused_attention_plain(q, k, v, c2p, p2c, mask, 5.0))
    tc = dtype == bias_dtype == torch.bfloat16
    assert FA.kernel_variant(q.dtype, c2p.dtype) == (FA.TENSOR_CORE if tc else FA.CUDA_CORE)


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


@pytest.mark.parametrize("route", ["table", "xla"])
def test_gliclass_probs_score_routes_match_jax(route, monkeypatch):
    """"table" and "xla" force the materialized-score path in both packages
    (JAX: every kernel predicate declines; the port: score_attention), fp32."""
    S = 32
    jc, tc, ids, mask = _tiny(S)
    params = jax.tree.map(np.asarray, init_gliclass_params(jax.random.key(4), jc))
    monkeypatch.setenv("GLICLASS_TPU_ATTN_ROUTE", route)
    assert not (JFA.use_bias_route(S, 8, jnp.float32, 3) or JFA.fusable(S, 8, jnp.float32)
                or JFA.use_tiled_route(S, 8, jnp.float32) or JFA._use_flash(S, 3))
    want = np.asarray(j_probs(params, jnp.asarray(ids), jnp.asarray(mask), jc, 4))
    tp = params_from_numpy(params, "cpu")
    got = t_probs(tp, torch.from_numpy(ids), torch.from_numpy(mask), tc, 4, attn_route=route).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
