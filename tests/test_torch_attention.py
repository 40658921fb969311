"""Disentangled attention of the port (K1's plain version and the model's
kernel route) vs the JAX package, on CPU, fp32 at 1e-5."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gliclass.c_tpu.models.deberta import rel_to_abs as j_rel_to_abs
from gliclass.c_tpu.ops.fused_attention import flash_disentangled_attention as j_flash
from gliclass.c_tpu_torch.config import BackboneConfig
from gliclass.c_tpu_torch.models import deberta as tdeb
from gliclass.c_tpu_torch.ops import fused_attention as FA


def _inputs(seed, B, h, S, d):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, h, S, d)).astype(np.float32) for _ in range(3))
    pos_k, pos_q = (rng.normal(size=(h, 2 * S - 1, d)).astype(np.float32) for _ in range(2))
    mask = np.ones((B, S), dtype=np.int32)
    mask[1, S - 3:] = 0
    return q, k, v, pos_k, pos_q, mask


def xla_reference(q, k, v, pos_k_rel, pos_q_rel, mask, scale):
    """The JAX package's score path, inlined (fp32): the reference of
    tests/test_fused_attention.py."""
    c2p_rel = jnp.einsum("bhid,hmd->bhim", q, pos_k_rel)
    p2c_rel = jnp.einsum("bhjd,hmd->bhjm", k, pos_q_rel)
    scores = jnp.einsum("bhid,bhjd->bhij", q, k)
    scores = scores + j_rel_to_abs(c2p_rel) + jnp.swapaxes(j_rel_to_abs(p2c_rel), -1, -2)
    scores = scores / scale
    scores = jnp.where(mask.astype(bool)[:, None, None, :], scores, -1e30)
    return jnp.einsum("bhij,bhjd->bhid", jax.nn.softmax(scores, axis=-1), v)


def _valid_rows_close(got, want, mask):
    valid = mask.astype(bool)
    for b in range(mask.shape[0]):
        np.testing.assert_allclose(got[b][:, valid[b]], want[b][:, valid[b]], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S", [16, 24, 32])
def test_plain_matches_jax_flash_kernel(S):
    """K1's plain version vs the JAX Pallas flash kernel (interpret mode,
    blk=8: multi-block online softmax and windowed position tables)."""
    B, h, d = 2, 3, 8
    q, k, v, pk, pq, mask = _inputs(2, B, h, S, d)
    scale = math.sqrt(d * 3)
    want = np.asarray(j_flash(*(jnp.asarray(a) for a in (q, k, v, pk, pq, mask)), scale, blk=8))
    t = torch.from_numpy
    got = FA.flash_disentangled_attention(t(q), t(k), t(v), t(pk), t(pq), t(mask), scale).numpy()
    _valid_rows_close(got, want, mask)


@pytest.mark.parametrize("S", [12, 20])
def test_plain_matches_xla_reference_ragged(S):
    """Ragged S (not a multiple of any block) that the TPU kernel cannot take."""
    B, h, d = 2, 3, 8
    q, k, v, pk, pq, mask = _inputs(3, B, h, S, d)
    scale = math.sqrt(d * 3)
    want = np.asarray(xla_reference(*(jnp.asarray(a) for a in (q, k, v, pk, pq, mask)), scale))
    t = torch.from_numpy
    got = FA.flash_disentangled_attention_plain(t(q), t(k), t(v), t(pk), t(pq), t(mask), scale).numpy()
    _valid_rows_close(got, want, mask)


def test_plain_accepts_head_split_views():
    """The model passes q/k/v as strided head splits of one fused projection."""
    B, S, h, d = 2, 10, 3, 8
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.normal(size=(B, S, 3 * h * d)).astype(np.float32))
    views = [qkv[..., i * h * d:(i + 1) * h * d].reshape(B, S, h, d).transpose(1, 2) for i in range(3)]
    pk, pq = (torch.from_numpy(rng.normal(size=(h, 2 * S - 1, d)).astype(np.float32)) for _ in range(2))
    mask = torch.ones(B, S, dtype=torch.int32)
    got = FA.flash_disentangled_attention(*views, pk, pq, mask, 4.0)
    want = FA.flash_disentangled_attention(*(x.contiguous() for x in views), pk, pq, mask, 4.0)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("S,rows", [(16, [(0, 8), (8, 8)]), (24, [(0, 6), (6, 6), (12, 6), (18, 6)]),
                                    (20, [(5, 10), (19, 1)])])
def test_plain_query_row_offset_is_the_rows_of_the_full_call(S, rows):
    """K1's plain version at q_off (a seq rank's block of query rows, its own
    strides: a slice of q) equals those rows of the call over all S, and
    those rows of the JAX Pallas flash kernel (interpret mode) at 1e-5; in
    bf16 too. Equal up to the CPU matmul's sum order, which follows the
    operands' shapes: fp32 1e-6, bf16 one ulp of the largest output (the
    kernels' rows are bit-equal: the card tests)."""
    B, h, d = 2, 3, 8
    q, k, v, pk, pq, mask = _inputs(9, B, h, S, d)
    scale = math.sqrt(d * 3)
    t = torch.from_numpy
    full = FA.flash_disentangled_attention(t(q), t(k), t(v), t(pk), t(pq), t(mask), scale)
    jfull = np.asarray(j_flash(*(jnp.asarray(a) for a in (q, k, v, pk, pq, mask)), scale, blk=4)) if S % 4 == 0 \
        else np.asarray(xla_reference(*(jnp.asarray(a) for a in (q, k, v, pk, pq, mask)), scale))
    for off, n in rows:
        got = FA.flash_disentangled_attention(t(q)[:, :, off:off + n], t(k), t(v), t(pk), t(pq), t(mask), scale,
                                              q_off=off)
        assert got.shape == (B, h, n, d)
        torch.testing.assert_close(got, full[:, :, off:off + n], atol=1e-6, rtol=1e-6)
        _valid_rows_close(got.numpy(), jfull[:, :, off:off + n], mask[:, off:off + n])
        bf = [x.to(torch.bfloat16) for x in (t(q), t(k), t(v), t(pk), t(pq))]
        want = FA.flash_disentangled_attention(*bf, t(mask), scale)[:, :, off:off + n].float()
        gotb = FA.flash_disentangled_attention(bf[0][:, :, off:off + n], *bf[1:], t(mask), scale, q_off=off)
        torch.testing.assert_close(gotb.float(), want, atol=2.0 ** -8 * want.abs().max().item(), rtol=0)


def test_rel_to_abs_at_row_and_column_offsets():
    """The score path's skew of a seq rank's rows (c2p) and of its columns
    (p2c): the blocks of the full skew."""
    S, off, n = 12, 4, 4
    x = torch.from_numpy(np.random.default_rng(10).normal(size=(2, S, 2 * S - 1)).astype(np.float32))
    full = tdeb.rel_to_abs(x)
    assert torch.equal(tdeb.rel_to_abs(x[:, off:off + n], S, row_off=off), full[:, off:off + n])
    assert torch.equal(tdeb.rel_to_abs(x, n, col_off=off), full[:, :, off:off + n])


@pytest.mark.parametrize("S", [5, 12])
def test_rel_to_abs_matches_jax(S):
    x = np.random.default_rng(5).normal(size=(2, 3, S, 2 * S - 1)).astype(np.float32)
    np.testing.assert_array_equal(tdeb.rel_to_abs(torch.from_numpy(x)).numpy(),
                                  np.asarray(j_rel_to_abs(jnp.asarray(x))))


def test_kernel_route_matches_score_path():
    """The model's kernel route vs its materialized-score reference (both in
    the port), fp32, valid query rows."""
    bb = BackboneConfig(hidden_size=32, num_attention_heads=4, intermediate_size=64,
                        position_buckets=16, max_position_embeddings=64)
    rng = np.random.default_rng(6)
    B, S, H = 2, 14, 32
    dense = lambda: {"w": torch.from_numpy(rng.normal(0, 0.2, (H, H)).astype(np.float32)),
                     "b": torch.from_numpy(rng.normal(0, 0.1, H).astype(np.float32))}
    p = {n: dense() for n in ("q", "k", "v", "o")}
    x = torch.from_numpy(rng.normal(size=(B, S, H)).astype(np.float32))
    rel = torch.from_numpy(rng.normal(size=(32, H)).astype(np.float32))
    mask = torch.ones(B, S, dtype=torch.int32)
    mask[1, 9:] = 0
    c2p, p2c = (torch.from_numpy(c.astype(np.int64)) for c in tdeb.rel_bias_columns(S, 16, 16, 64))
    got = tdeb.disentangled_attention(p, x, rel, c2p, p2c, bb, torch.float32, mask)
    pair = mask.bool()[:, :, None] & mask.bool()[:, None, :]
    want = tdeb.score_attention(p, x, rel, pair, c2p, p2c, bb, torch.float32)
    _valid_rows_close(got.numpy()[:, None], want.numpy()[:, None], mask.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_cpu_runs_plain_and_counts_nothing(dtype):
    """On a CPU tensor K1's wrapper runs the plain version, whichever variant
    the dtype would take on the card, and counts no launch of either."""
    B, h, S, d = 2, 3, 10, 8
    q, k, v, pk, pq, mask = (torch.from_numpy(a) for a in _inputs(7, B, h, S, d))
    q, k, v, pk, pq = (x.to(dtype) for x in (q, k, v, pk, pq))
    assert FA.kernel_variant(dtype) == (FA.TENSOR_CORE if dtype == torch.bfloat16 else FA.CUDA_CORE)
    before = FA.launches, FA.launches_flash_tc
    got = FA.flash_disentangled_attention(q, k, v, pk, pq, mask, 4.0)
    assert (FA.launches, FA.launches_flash_tc) == before
    assert got.dtype == dtype and got.shape == (B, h, S, d)
    assert torch.equal(got, FA.flash_disentangled_attention_plain(q, k, v, pk, pq, mask, 4.0))


@pytest.mark.parametrize("S", [6, 13])
def test_plain_row_without_valid_key_is_the_mean_of_v(S):
    """A row whose keys are all masked weighs each of its S keys exp(0) = 1:
    the mean of v, which the tensor-core K1 reproduces (keys past S weigh 0)."""
    q, k, v, pk, pq, mask = (torch.from_numpy(a) for a in _inputs(8, 2, 3, S, 8))
    mask[0] = 0
    got = FA.flash_disentangled_attention_plain(q, k, v, pk, pq, mask, 4.0)
    torch.testing.assert_close(got[0], v[0].mean(dim=1, keepdim=True).expand(3, S, 8), atol=1e-6, rtol=1e-6)
