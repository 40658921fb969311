"""The port's row route (K8) and tiled route (K9 windowed tables, K10) vs the
JAX package, on CPU.

On the CPU the port runs the kernels' plain versions; the JAX side runs its
Pallas kernels in interpret mode: ``_kernel`` through
``fused_disentangled_attention``, ``_win_table_kernel`` through
``_windowed_tables_call`` and ``_tiled_kernel`` through
``tiled_bias_attention``. Tolerances: the windowed tables exactly (a copy of
values); attention and probabilities at fp32 1e-5 on valid query rows;
bf16 at the bounds stated by each test.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gliclass.c_tpu.config import RuntimeConfig as JRuntime
from gliclass.c_tpu.data import parse_job as j_parse_job
from gliclass.c_tpu.models.gliclass import gliclass_probs as j_probs
from gliclass.c_tpu.models.gliclass import init_gliclass_params
from gliclass.c_tpu.ops import fused_attention as JFA
from gliclass.c_tpu.pipeline import ZeroShotClassificationPipeline as JPipeline
from gliclass.c_tpu_torch.config import RuntimeConfig
from gliclass.c_tpu_torch.convert.params import params_from_numpy
from gliclass.c_tpu_torch.data import parse_job
from gliclass.c_tpu_torch.models.gliclass import gliclass_probs as t_probs
from gliclass.c_tpu_torch.ops import fused_attention as FA
from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline

from test_torch_bias_route import _tiny

B, H, D = 3, 3, 8


def _inputs(S, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(3))
    pk, pq = (rng.normal(size=(H, 2 * S - 1, D)).astype(np.float32) for _ in range(2))
    mask = np.ones((B, S), dtype=np.int32)
    mask[1, S - 3:] = 0       # padded keys
    mask[2, S // 2 + 1:] = 0  # a short row: whole key blocks masked
    return q, k, v, pk, pq, mask


@pytest.mark.parametrize("dtypes,want", [
    ((torch.bfloat16,), FA.TENSOR_CORE), ((torch.bfloat16, torch.bfloat16), FA.TENSOR_CORE),
    ((torch.float32,), FA.CUDA_CORE), ((torch.float32, torch.float32), FA.CUDA_CORE),
    ((torch.bfloat16, torch.float32), FA.CUDA_CORE), ((torch.float32, torch.bfloat16), FA.CUDA_CORE),
])
def test_kernel_variant_predicate(dtypes, want):
    """K8 and K10 launch their tensor-core variant for bf16 inputs (q's, and
    K10's tables') and the CUDA-core one for fp32 and mixed types."""
    assert FA.kernel_variant(*dtypes) == want


def _valid_rows(out, ref, mask, tol):
    for b in range(B):
        rows = mask[b].astype(bool)
        np.testing.assert_allclose(out[b][:, rows], ref[b][:, rows], atol=tol, rtol=tol)


# bf16: both packages round q, k, v and the tables to bf16 and sum in fp32 in
# another order, then round p (in [0, 1]) and the context (|x| < 4) to bf16:
# a few bf16 steps of the context, 2^-6 at |x| < 4.
@pytest.mark.parametrize("S", [8, 16, 24])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_row_plain_matches_jax_row_kernel(S, dtype, tol):
    """K8's plain version vs the JAX whole-row Pallas kernel (``_fused_call``)."""
    arrays = _inputs(S, S)
    mask = arrays[-1]
    scale = math.sqrt(3 * D)
    assert not JFA._use_flash(S, B)  # the whole-row kernel, not the flash one
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JFA.fused_disentangled_attention(
        *(jnp.asarray(a, dtype=jdt) for a in arrays[:5]), jnp.asarray(mask), scale)
    got = FA.row_disentangled_attention(
        *(torch.from_numpy(a).to(tdt) for a in arrays[:5]), torch.from_numpy(mask), scale)
    _valid_rows(got.float().numpy(), np.asarray(want.astype(jnp.float32)), mask, tol)


@pytest.mark.parametrize("S,blk", [(16, 8), (32, 8), (32, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_tables_equal_jax(S, blk, dtype):
    pos = np.random.default_rng(S + blk).normal(size=(H, 2 * S - 1, D)).astype(np.float32)
    want = np.asarray(JFA._windowed_tables_call(jnp.asarray(pos, dtype=dtype), blk).astype(jnp.float32))
    got = FA.windowed_pos_tables(torch.from_numpy(pos).to(getattr(torch, dtype)), blk)
    n_win = 2 * S // blk - 1
    assert tuple(got.shape) == (H, n_win, blk, blk, D)  # the port's [h, w, x, y, d] layout
    np.testing.assert_array_equal(got.permute(0, 1, 4, 2, 3).float().numpy(), want)


@pytest.mark.parametrize("S,blk", [(16, 8), (32, 8), (32, 16)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-2)])
def test_tiled_bias_attention_matches_jax(S, blk, dtype, tol):
    """The whole tiled route at an explicit blk (several query and key
    tiles); bf16 inputs and tables (score_dtype bf16) at the bias route's
    bf16 bound."""
    arrays = _inputs(S, S + 1)
    mask = arrays[-1]
    scale = math.sqrt(3 * D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JFA.tiled_bias_attention(
        *(jnp.asarray(a, dtype=jdt) for a in arrays[:5]), jnp.asarray(mask), scale,
        score_dtype=jdt, blk=blk)
    got = FA.tiled_bias_attention(
        *(torch.from_numpy(a).to(tdt) for a in arrays[:5]), torch.from_numpy(mask), scale,
        score_dtype=tdt, blk=blk)
    _valid_rows(got.float().numpy(), np.asarray(want.astype(jnp.float32)), mask, tol)
    plain = FA.tiled_bias_attention_plain(
        *(torch.from_numpy(a).to(tdt) for a in arrays[:5]), torch.from_numpy(mask), scale,
        score_dtype=tdt, blk=blk)
    assert torch.equal(got, plain)


def test_tiled_table_block_does_not_change_the_result():
    """The tables' blk is a layout choice: every blk gives the same function
    (fp32, two orders of the same sums at most)."""
    q, k, v, pk, pq, mask = map(torch.from_numpy, _inputs(32, 5))
    outs = [FA.tiled_bias_attention(q, k, v, pk, pq, mask, 5.0, blk=blk) for blk in (4, 8, 16, 32)]
    flash = FA.flash_disentangled_attention(q, k, v, pk, pq, mask, 5.0)
    for out in outs:
        _valid_rows(out.numpy(), flash.numpy(), mask.numpy(), 1e-5)


@pytest.mark.parametrize("route,S", [("row", 40), ("row", 48), ("tiled", 32), ("tiled", 64)])
def test_gliclass_probs_row_and_tiled_routes_match_jax(route, S, monkeypatch):
    """A tiny DeBERTa through the row or tiled route in both packages (JAX
    forced by GLICLASS_TPU_ATTN_ROUTE, read when it traces, so each case is
    its own shape; the port by its attn_route), fp32; and the port's route
    against its flash route."""
    jc, tc, ids, mask = _tiny(S)
    params = jax.tree.map(np.asarray, init_gliclass_params(jax.random.key(5), jc))
    monkeypatch.setenv("GLICLASS_TPU_ATTN_ROUTE", route)
    taken = JFA.fusable(S, 8, jnp.float32) if route == "row" else JFA.use_tiled_route(S, 8, jnp.float32)
    assert taken  # JAX takes its kernel at this shape
    want = np.asarray(j_probs(params, jnp.asarray(ids), jnp.asarray(mask), jc, 4))
    tp = params_from_numpy(params, "cpu")
    ti, tm = torch.from_numpy(ids), torch.from_numpy(mask)
    assert FA.attention_route(S, 3, 8, route) == route
    got = t_probs(tp, ti, tm, tc, 4, attn_route=route).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    flash = t_probs(tp, ti, tm, tc, 4, attn_route="flash").numpy()
    np.testing.assert_allclose(got, flash, atol=1e-5, rtol=1e-5)


JOB = {
    "texts": ["the quick brown fox jumps over the lazy dog",
              "onnx is an open-source format for ai models",
              "why are you running", "support ukraine", "science business sports"],
    "labels": [["science", "sports", "format", "question"]],
    "same_labels": True,
    "classification_type": "multi-label",
}
RT = dict(batch_size=4, max_length=64, compute_dtype="float32",
          seq_buckets=(16, 32, 64), label_buckets=(2, 4, 8))


@pytest.fixture(scope="module")
def bundle_dir(tiny_tokenizer_file, tmp_path_factory):
    """A tiny fp32 bundle written by the JAX package's converter."""
    from gliclass.c_tpu.config import BackboneConfig as JBackbone
    from gliclass.c_tpu.config import GLiClassConfig as JConfig
    from gliclass.c_tpu.convert.convert import export_bundle
    from gliclass.c_tpu.convert.torch_ref import build_torch_gliclass
    from gliclass.c_tpu.tokenization import PromptTokenizer as JTokenizer

    tok = JTokenizer.from_file(tiny_tokenizer_file)
    bb = JBackbone(model_type="deberta-v2", vocab_size=600, hidden_size=32,
                   num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                   max_position_embeddings=64, position_buckets=16,
                   norm_rel_ebd="layer_norm", share_att_key=True, position_biased_input=False)
    cfg = JConfig(hidden_size=32, class_token_index=tok.label_token_id,
                  text_token_index=tok.sep_token_id, prompt_first=True, backbone=bb)
    path = str(tmp_path_factory.mktemp("bundle") / "b")
    export_bundle(build_torch_gliclass(cfg), cfg, tok, path, quantize=False)
    return path


@pytest.mark.parametrize("route", ["row", "tiled"])
def test_classify_job_row_and_tiled_routes_match_jax_pipeline(bundle_dir, route, monkeypatch):
    """classify_job under one route in both packages (a fresh JAX engine, so
    its steps trace under the variable): decisions exactly equal, scores to
    1e-5."""
    monkeypatch.setenv("GLICLASS_TPU_ATTN_ROUTE", route)
    jout = JPipeline.from_bundle(bundle_dir, JRuntime(**RT)).classify_job(j_parse_job(JOB))
    tpipe = ZeroShotClassificationPipeline.from_bundle(
        bundle_dir, RuntimeConfig(attn_route=route, **RT), device="cpu")
    tout = tpipe.classify_job(parse_job(JOB))
    assert tout.failures == [] and jout.failures == []
    tj, jj = tout.to_json(), jout.to_json()
    assert [[d["label"] for d in r["decisions"]] for r in tj] == [[d["label"] for d in r["decisions"]] for r in jj]
    np.testing.assert_allclose(tout.probs, jout.probs, atol=1e-5, rtol=1e-5)


LADDER = (56, 64, 72, 88, 96, 104, 120, 128, 192, 256, 384, 512, 1024, 2048)


@pytest.mark.parametrize("route", ["row", "tiled"])
def test_route_predicate_at_the_ladder(route, monkeypatch):
    """The port takes K8 where JAX's ``fusable`` takes ``_kernel`` (S <= 512,
    8-aligned) and K9/K10 where ``use_tiled_route`` takes its kernels (S a
    multiple of 32); elsewhere K1, at any batch."""
    monkeypatch.setenv("GLICLASS_TPU_ATTN_ROUTE", route)
    jax_takes = JFA.fusable if route == "row" else JFA.use_tiled_route
    for S in LADDER + (90,):
        for Bt in (1, 16, 128):
            got = FA.attention_route(S, Bt, 64, route)
            assert got == (route if jax_takes(S, 64, jnp.float32) else "flash"), (S, Bt)
    assert [S for S in LADDER if FA.attention_route(S, 8, 64, route) == route] == (
        [S for S in LADDER if S <= 512] if route == "row" else [S for S in LADDER if S % 32 == 0])
