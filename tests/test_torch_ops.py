"""The port's primitives and kernels' plain versions vs the JAX package, on CPU.

Inputs are made from a seed with numpy and handed to both packages. Tolerances:
fp32 to 1e-5; bf16 to one bf16 ulp of the compared values (2^-7 relative,
``BF16_RTOL``) where the integer path makes the arithmetic the same.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gliclass.c_tpu.models import deberta as jdeb
from gliclass.c_tpu.ops import layers as jl
from gliclass.c_tpu.ops import quant as jq
from gliclass.c_tpu.ops.fused_ffn import _fused_ffn_pallas
from gliclass.c_tpu.ops.int8_matmul import int8_matmul as j_int8_matmul
from gliclass.c_tpu_torch.models import deberta as tdeb
from gliclass.c_tpu_torch.ops import fused_attention as tfa
from gliclass.c_tpu_torch.ops import fused_ffn as tffn
from gliclass.c_tpu_torch.ops import int8_matmul as tim
from gliclass.c_tpu_torch.ops import layers as tl
from gliclass.c_tpu_torch.ops import quant as tq

BF16_RTOL = 2.0**-7  # one bf16 ulp, relative
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _j(a, dtype="float32"):
    return jnp.asarray(a, JDT[dtype])


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, atol=1e-5):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_RTOL * np.abs(want).max())


def _dense(rng, K, N, bias=True):
    p = {"w": rng.normal(0, 0.05, (K, N)).astype(np.float32)}
    if bias:
        p["b"] = rng.normal(0, 0.05, N).astype(np.float32)
    return p


def _tree(p, to):
    return {k: to(v) for k, v in p.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    p = _dense(rng, 32, 24)
    got = tl.linear(_tree(p, _t), _t(x, dtype), TDT[dtype])
    want = jl.linear(_tree(p, _j), _j(x, dtype), JDT[dtype])
    assert got.dtype == TDT[dtype]
    # bf16: both accumulate in fp32 and round the product to bf16 before the
    # bias add, so two roundings separate them at most.
    _close(got, want, dtype) if dtype == "float32" else np.testing.assert_allclose(
        _np(got), _np(want), atol=2 * BF16_RTOL * np.abs(_np(want)).max()
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_int8_weight_only_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 6, 32)).astype(np.float32)
    p = jq.quantize_dense_param(_dense(rng, 32, 16))
    p = {k: np.asarray(v) for k, v in p.items()}
    got = tl.linear({k: torch.from_numpy(v) for k, v in p.items()}, _t(x, dtype), TDT[dtype])
    want = jl.linear({k: jnp.asarray(v) for k, v in p.items()}, _j(x, dtype), JDT[dtype])
    # The JAX default dequantizes the weight and rounds it to the activation
    # dtype before the product; the port scales the fp32 accumulator (the
    # Pallas/CUDA kernel form). Equal to rounding in fp32; in bf16 they
    # differ by the weight rounding: a few bf16 ulps of the output.
    if dtype == "float32":
        _close(got, want, dtype)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=4 * BF16_RTOL * np.abs(_np(want)).max())


def test_linear_w8a8_matches_jax():
    """Integer path: same int8 activations, same int32 sums, same scaling
    order — equal to fp32 rounding."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    p = {k: np.asarray(v) for k, v in jq.quantize_dense_param(_dense(rng, 64, 32)).items()}
    got = tl._linear_w8a8({k: torch.from_numpy(v) for k, v in p.items()}, _t(x, "bfloat16"))
    want = jl._linear_w8a8({k: jnp.asarray(v) for k, v in p.items()}, _j(x, "bfloat16"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)
    # and through linear() inside the act-quant context (bias in bf16)
    with tl.act_quant(True):
        got = tl.linear({k: torch.from_numpy(v) for k, v in p.items()}, _t(x, "bfloat16"), torch.bfloat16)
    with jl.act_quant(True):
        want = jl.linear({k: jnp.asarray(v) for k, v in p.items()}, _j(x, "bfloat16"), jnp.bfloat16)
    _close(got, want, "bfloat16")


def test_w8a8_skipped_in_fp32():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 32)).astype(np.float32)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in jq.quantize_dense_param(_dense(rng, 32, 8)).items()}
    with tl.act_quant(True):
        got = tl.linear(p, _t(x), torch.float32)
    want = tl.linear(p, _t(x), torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 2.0, size=(3, 9, 48)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 48).astype(np.float32), "bias": rng.normal(0, 0.1, 48).astype(np.float32)}
    got = tl.layer_norm(_tree(p, _t), _t(x, dtype), 1e-7)
    want = jl.layer_norm(_tree(p, _j), _j(x, dtype), 1e-7)
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)
    got = tl.rms_norm({"scale": _t(p["scale"])}, _t(x, dtype), 1e-6)
    want = jl.rms_norm({"scale": _j(p["scale"])}, _j(x, dtype), 1e-6)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    x = np.random.default_rng(5).normal(0, 3, size=(1000,)).astype(np.float32)
    _close(tl._gelu(_t(x, dtype)), jl._gelu(_j(x, dtype)), dtype)
    # the fp32 tanh form the fused FFN uses
    _close(tl.gelu_tanh(_t(x)), jax.nn.gelu(_j(x), approximate=True), "float32")


def test_layer_norm_of_a_residual_sum_rounds_once():
    """``residual=``: the norm of the sum taken in fp32, one rounding at the
    end, as the JAX package's jitted graph fuses the add into the norm."""
    rng = np.random.default_rng(7)
    a, b = (rng.normal(0, 2.0, size=(3, 9, 48)).astype(np.float32) for _ in range(2))
    p = {"scale": rng.normal(1, 0.1, 48).astype(np.float32), "bias": rng.normal(0, 0.1, 48).astype(np.float32)}
    ta, tb = _t(a, "bfloat16"), _t(b, "bfloat16")
    got = tl.layer_norm(_tree(p, _t), ta, 1e-7, residual=tb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tl.layer_norm(_tree(p, _t), ta.float() + tb.float(), 1e-7).bfloat16())
    want = jax.jit(lambda x, y: jl.layer_norm(_tree(p, _j), x + y, 1e-7))(_j(a, "bfloat16"), _j(b, "bfloat16"))
    _close(got, want, "bfloat16")


def test_reduced_precision_gelu_rounds_once():
    """bf16 gelu is the fp32 tanh form rounded once (op by op it would round
    seven times), within a bf16 ulp of the JAX package's jitted graph."""
    x = _t(np.random.default_rng(8).normal(0, 3, size=(4096,)), "bfloat16")
    for name in ("gelu", "gelu_new", "gelu_pytorch_tanh"):
        got = tl.activation(name)(x)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, tl.gelu_tanh(x.float()).bfloat16())
    _close(tl._gelu(x), jax.jit(jl._gelu)(_j(_np(x), "bfloat16")), "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_softmax_matches_jax(dtype):
    x = np.random.default_rng(6).normal(0, 4, size=(2, 3, 7, 11)).astype(np.float32)
    x[..., -3:] = -1e4
    got = tl.masked_softmax(_t(x, dtype))
    want = jl.masked_softmax(_j(x, dtype))
    assert got.dtype == TDT[dtype]
    _close(got, want, dtype)


@pytest.mark.parametrize("shape", [(40, 24), (3, 40, 24)])
def test_quantize_weight_bit_equal(shape):
    w = np.random.default_rng(7).normal(0, 0.1, shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero output channel takes scale 1
    q_t, s_t = tq.quantize_weight(w)
    q_j, s_j = jq.quantize_weight(w)
    assert q_t.dtype == np.int8 and s_t.dtype == np.float32
    np.testing.assert_array_equal(q_t, np.asarray(q_j))
    np.testing.assert_array_equal(s_t, np.asarray(s_j))


def test_quantize_tree_bit_equal():
    rng = np.random.default_rng(8)
    tree = {
        "embeddings": {"word": rng.normal(size=(10, 8)).astype(np.float32),
                       "proj": _dense(rng, 8, 8)},
        "layers": {"attn": {"q": {"w": rng.normal(size=(2, 8, 8)).astype(np.float32),
                                  "b": np.zeros((2, 8), np.float32)}}},
        "head": {"linear_1": _dense(rng, 8, 16, bias=False)},
    }
    got = tq.quantize_tree(tree)
    want = jq.quantize_tree(tree)
    assert "w" in got["embeddings"]["proj"]  # skipped path keeps full precision
    flat_g = {k: v for k, v in _flatten(got)}
    flat_w = {k: np.asarray(v) for k, v in _flatten(want)}
    assert flat_g.keys() == flat_w.keys()
    for k in flat_g:
        assert flat_g[k].dtype == flat_w[k].dtype, k
        np.testing.assert_array_equal(flat_g[k], flat_w[k])


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("S,span,max_pos", [(12, 16, 64), (56, 256, 512), (512, 256, 512)])
def test_rel_bias_columns_equal(S, span, max_pos):
    c_t, p_t = tdeb.rel_bias_columns(S, span, span, max_pos)
    c_j, p_j = jdeb.rel_bias_columns(S, span, span, max_pos)
    np.testing.assert_array_equal(c_t, c_j)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(
        tdeb.relative_position_bucket(S, S, span, max_pos),
        jdeb.relative_position_bucket(S, S, span, max_pos),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_jax(dtype):
    """K3's plain version vs the JAX int8_matmul. The JAX default rounds the
    dequantized weight to the activation dtype; the port applies the scale to
    the fp32 accumulator: equal to rounding in fp32, a few bf16 ulps apart in
    bf16."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 10, 64)).astype(np.float32)
    w_q, scale = jq.quantize_weight(rng.normal(0, 0.05, (64, 48)).astype(np.float32))
    got = tim.int8_matmul(_t(x, dtype), torch.from_numpy(w_q), torch.from_numpy(scale))
    want = j_int8_matmul(_j(x, dtype), jnp.asarray(w_q), jnp.asarray(scale))
    assert got.shape == (6, 10, 48) and got.dtype == TDT[dtype]
    if dtype == "float32":
        _close(got, want, dtype)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=4 * BF16_RTOL * np.abs(_np(want)).max())


def test_int8_matmul_cpu_runs_plain_and_counts_nothing():
    rng = np.random.default_rng(10)
    x = _t(rng.normal(size=(5, 16)))
    w_q = torch.from_numpy(rng.integers(-127, 128, (16, 8)).astype(np.int8))
    scale = torch.rand(8)
    bias = torch.rand(8)
    before = tim.launches, tim.launches_tc
    got = tim.int8_matmul(x, w_q, scale, bias)
    assert (tim.launches, tim.launches_tc) == before
    want = (x.double() @ w_q.double() * scale.double() + bias.double()).float()
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_matmul_cpu_bf16_runs_plain_and_counts_nothing(with_bias):
    """bf16 x at a shape the tensor-core variant takes: on a CPU tensor the
    wrapper still runs the plain version and counts no launch of either."""
    rng = np.random.default_rng(12)
    x = _t(rng.normal(size=(3, 7, 32)), "bfloat16")
    w_q = torch.from_numpy(rng.integers(-127, 128, (32, 48)).astype(np.int8))
    scale = torch.rand(48)
    bias = torch.rand(48) if with_bias else None
    assert tim.kernel_variant(x.dtype, 32, 48) == tfa.TENSOR_CORE
    before = tim.launches, tim.launches_tc
    got = tim.int8_matmul(x, w_q, scale, bias)
    assert (tim.launches, tim.launches_tc) == before
    assert got.shape == (3, 7, 48) and got.dtype == torch.bfloat16
    assert torch.equal(got, tim.int8_matmul_plain(x, w_q, scale, bias))


@pytest.mark.parametrize("dtype,K,N,want", [
    (torch.bfloat16, 768, 2304, "tc"), (torch.bfloat16, 768, 768, "tc"), (torch.bfloat16, 3072, 768, "tc"),
    (torch.bfloat16, 1536, 256, "tc"), (torch.bfloat16, 32, 96, "tc"), (torch.bfloat16, 8, 16, "tc"),
    (torch.bfloat16, 64, 8, "cc"), (torch.bfloat16, 96, 40, "cc"), (torch.bfloat16, 100, 768, "cc"),
    (torch.bfloat16, 12, 64, "cc"), (torch.float32, 768, 2304, "cc"), (torch.float32, 64, 8, "cc"),
])
def test_int8_matmul_kernel_variant_predicate(dtype, K, N, want):
    """K3's tensor-core variant takes bf16 x with K a multiple of 8 and N a
    multiple of 16 (the encoder's linears, qwen's N=256 k/v projections);
    fp32 and every other shape keep the CUDA-core kernel."""
    variant = {"tc": tfa.TENSOR_CORE, "cc": tfa.CUDA_CORE}[want]
    assert tim.kernel_variant(dtype, K, N) == variant


def test_fused_ffn_plain_matches_pallas_interpret():
    """K2's plain version vs the JAX Pallas w8a8 kernel in interpret mode
    (M=16, H=128, I=256). The integer products agree exactly; the tanh of the
    two libraries may differ in the last fp32 bit, which can move one int8
    re-quantization step: allow 2 bf16 ulps of the output."""
    rng = np.random.default_rng(11)
    M, H, I = 16, 128, 256
    x = rng.normal(size=(M, H)).astype(np.float32)
    wu, su = jq.quantize_weight(rng.normal(0, 0.05, (H, I)).astype(np.float32))
    wd, sd = jq.quantize_weight(rng.normal(0, 0.05, (I, H)).astype(np.float32))
    bu = rng.normal(0, 0.05, I).astype(np.float32)
    bd = rng.normal(0, 0.05, H).astype(np.float32)
    want = _fused_ffn_pallas(
        _j(x, "bfloat16"), jnp.asarray(wu), jnp.asarray(su), jnp.asarray(bu),
        jnp.asarray(wd), jnp.asarray(sd), jnp.asarray(bd),
        hidden_act="gelu", act_quant=True, bm=8, out_dtype=jnp.bfloat16, interpret=True,
    )
    t = torch.from_numpy
    got = tffn.fused_ffn_w8a8(_t(x, "bfloat16"), t(wu), t(su), t(bu), t(wd), t(sd), t(bd), "gelu")
    assert got.dtype == torch.bfloat16 and got.shape == (M, H)
    np.testing.assert_allclose(_np(got), _np(want), atol=2 * BF16_RTOL * np.abs(_np(want)).max())


def test_fused_ffn_wonly_plain_matches_pallas_interpret():
    """K4's plain version vs the JAX Pallas weight-only kernel in interpret
    mode (M=16, H=128, I=256). Both sum exact bf16 x int8 products in fp32
    and round the activated intermediate to bf16; a last-bit difference of
    the fp32 sum or tanh can move one bf16 step of h: 2 bf16 ulps of the
    output."""
    rng = np.random.default_rng(13)
    M, H, I = 16, 128, 256
    x = rng.normal(size=(M, H)).astype(np.float32)
    wu, su = jq.quantize_weight(rng.normal(0, 0.05, (H, I)).astype(np.float32))
    wd, sd = jq.quantize_weight(rng.normal(0, 0.05, (I, H)).astype(np.float32))
    bu = rng.normal(0, 0.05, I).astype(np.float32)
    bd = rng.normal(0, 0.05, H).astype(np.float32)
    want = _fused_ffn_pallas(
        _j(x, "bfloat16"), jnp.asarray(wu), jnp.asarray(su), jnp.asarray(bu),
        jnp.asarray(wd), jnp.asarray(sd), jnp.asarray(bd),
        hidden_act="gelu", act_quant=False, bm=8, out_dtype=jnp.bfloat16, interpret=True,
    )
    t = torch.from_numpy
    assert tffn.kernel_variant(H, I) == tfa.TENSOR_CORE
    before = tffn.launches_wonly, tffn.launches_wonly_tc
    got = tffn.fused_ffn_wonly(_t(x, "bfloat16"), t(wu), t(su), t(bu), t(wd), t(sd), t(bd), "gelu")
    assert (tffn.launches_wonly, tffn.launches_wonly_tc) == before  # a CPU tensor runs the plain version
    assert got.dtype == torch.bfloat16 and got.shape == (M, H)
    np.testing.assert_allclose(_np(got), _np(want), atol=2 * BF16_RTOL * np.abs(_np(want)).max())


@pytest.mark.parametrize("H,I,want", [
    (768, 3072, "tc"), (1024, 4096, "tc"), (128, 256, "tc"), (32, 64, "tc"), (16, 16, "tc"),
    (100, 196, "cc"), (96, 200, "cc"), (200, 96, "cc"), (36, 64, "cc"), (8, 32, "cc"),
])
def test_fused_ffn_wonly_kernel_variant_predicate(H, I, want):
    """K4's tensor-core variant takes H and I multiples of 16 (gliclass-base's
    768 and 3072, the tiny test models' widths); other shapes keep the fused
    CUDA-core kernel."""
    assert tffn.kernel_variant(H, I) == {"tc": tfa.TENSOR_CORE, "cc": tfa.CUDA_CORE}[want]


@pytest.mark.parametrize("M", [1, 16, 17, 342, 8192])
@pytest.mark.parametrize("K,N", [(32, 32), (36, 40), (768, 24)])
def test_int_mm_padded_exact_on_cpu(M, K, N):
    """The card's padding of torch._int_mm's operands (M, K and N to
    multiples of 32), run on CPU tensors: the sliced result equals the int64
    product exactly."""
    rng = np.random.default_rng(M + K + N)
    a = torch.from_numpy(rng.integers(-127, 128, (M, K)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (K, N)).astype(np.int8))
    got = tl.int_mm_padded(a, b)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.long(), a.long() @ b.long())
    assert torch.equal(tl.int_mm(a, b), got)


@pytest.mark.parametrize("mode", ["w8a8", "weight-only", "fp32"])
def test_fused_ffn_routes_match_jax(mode):
    """The port's fused_ffn on each route vs the JAX fused_ffn: its fused
    Pallas form (interpret mode) for INT8 in bf16, which the port's kernels
    K2 and K4 follow, and its composed form in fp32."""
    from gliclass.c_tpu.ops.fused_ffn import fused_ffn as j_fused_ffn

    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 8, 128)).astype(np.float32)
    up = {k: np.asarray(v) for k, v in jq.quantize_dense_param(_dense(rng, 128, 256)).items()}
    dn = {k: np.asarray(v) for k, v in jq.quantize_dense_param(_dense(rng, 256, 128)).items()}
    dtype = "float32" if mode == "fp32" else "bfloat16"
    aq = mode == "w8a8"
    with tl.act_quant(aq):
        got = tffn.fused_ffn(_tree(up, torch.from_numpy), _tree(dn, torch.from_numpy),
                             _t(x, dtype), "gelu", TDT[dtype])
    with jl.act_quant(aq):
        want = j_fused_ffn(_tree(up, jnp.asarray), _tree(dn, jnp.asarray), _j(x, dtype),
                           "gelu", JDT[dtype], interpret=True)
    if mode == "fp32":
        _close(got, want, dtype)
    else:
        # Same structure in both; the tanh of the two libraries and the fp32
        # sum order can move one int8 (w8a8) or bf16 (weight-only) step of
        # the intermediate: a few bf16 ulps of the output.
        np.testing.assert_allclose(_np(got), _np(want), atol=8 * BF16_RTOL * np.abs(_np(want)).max())


@pytest.mark.parametrize("with_nk", [False, True])
def test_fused_ffn_w8a8_cpu_runs_plain_and_counts_nothing(with_nk):
    """bf16 x at widths the tensor-core K2 takes: on a CPU tensor the wrapper
    runs the plain version (the [N, K] weights, given or not, unused) and
    counts no call of either variant."""
    rng = np.random.default_rng(14)
    M, H, I = 5, 32, 64
    x = _t(rng.normal(size=(M, H)), "bfloat16")
    wu, su = (torch.from_numpy(a) for a in jq.quantize_weight(rng.normal(0, 0.05, (H, I)).astype(np.float32)))
    wd, sd = (torch.from_numpy(a) for a in jq.quantize_weight(rng.normal(0, 0.05, (I, H)).astype(np.float32)))
    bu, bd = _t(rng.normal(0, 0.05, I)), _t(rng.normal(0, 0.05, H))
    args = (x, wu, su, bu, wd, sd, bd, "gelu")
    nk = dict(wt_up=tffn.nk_weight(wu), wt_dn=tffn.nk_weight(wd)) if with_nk else {}
    assert tffn.kernel_variant(H, I) == tfa.TENSOR_CORE
    before = tffn.launches, tffn.launches_tc
    got = tffn.fused_ffn_w8a8(*args, **nk)
    assert (tffn.launches, tffn.launches_tc) == before
    assert got.dtype == torch.bfloat16 and got.shape == (M, H)
    assert torch.equal(got, tffn.fused_ffn_w8a8_plain(*args))


def test_nk_weights_are_transposed_copies():
    """nk_weight gives the [N, K] copy K2's tensor-core variant reads;
    add_nk_weights puts one beside each stacked FFN weight and leaves the
    rest of the tree, and trees without INT8 FFN weights, as they were."""
    rng = np.random.default_rng(15)
    L, H, I = 2, 16, 48
    ffn = {n: tq.quantize_dense_param({"w": rng.normal(0, 0.05, shape).astype(np.float32),
                                       "b": rng.normal(0, 0.05, shape[-1]).astype(np.float32)})
           for n, shape in (("up", (L, H, I)), ("down", (L, I, H)))}
    tree = {"backbone": {"layers": {"ffn": {n: _tree(p, torch.from_numpy) for n, p in ffn.items()}}},
            "head": {"x": torch.zeros(1)}}
    got = tffn.add_nk_weights(tree)
    for n, (K, N) in (("up", (H, I)), ("down", (I, H))):
        p = got["backbone"]["layers"]["ffn"][n]
        assert p["w_t"].shape == (L, N, K) and p["w_t"].is_contiguous()
        assert torch.equal(p["w_t"], p["w_q"].transpose(1, 2))
        assert p["w_q"] is tree["backbone"]["layers"]["ffn"][n]["w_q"]
        assert torch.equal(tffn.nk_weight(p["w_q"][1]), p["w_t"][1])
    assert "w_t" not in tree["backbone"]["layers"]["ffn"]["up"] and got["head"] is tree["head"]
    fp = {"backbone": {"layers": {"ffn": {"up": {"w": torch.zeros(H, I)}, "down": {"w": torch.zeros(I, H)}}}}}
    assert tffn.add_nk_weights(fp) is fp
    assert tffn.add_nk_weights({"backbone": {"layers": {}}}) == {"backbone": {"layers": {}}}


def test_add_nk_weights_keeps_a_tree_that_has_them():
    """A tree that holds the [N, K] copies already (an engine's tree passed
    to another engine) is returned as it is: no second copy is made."""
    rng = np.random.default_rng(18)
    L, H, I = 2, 16, 32
    ffn = {n: _tree(tq.quantize_dense_param({"w": rng.normal(0, 0.05, shape).astype(np.float32)}), torch.from_numpy)
           for n, shape in (("up", (L, H, I)), ("down", (L, I, H)))}
    tree = {"backbone": {"layers": {"ffn": ffn}}}
    once = tffn.add_nk_weights(tree)
    assert once is not tree and tffn.add_nk_weights(once) is once
    ffn = once["backbone"]["layers"]["ffn"]
    assert all(torch.equal(ffn[n]["w_t"], ffn[n]["w_q"].transpose(1, 2)) for n in ("up", "down"))


def test_fused_ffn_route_ignores_nk_weights_on_cpu():
    """fused_ffn on a tree that carries [N, K] copies (an engine's tree moved
    to the CPU) gives the same bits as without them."""
    rng = np.random.default_rng(16)
    x = _t(rng.normal(size=(2, 8, 128)), "bfloat16")
    up = _tree(jq.quantize_dense_param(_dense(rng, 128, 256)), lambda a: torch.from_numpy(np.asarray(a)))
    dn = _tree(jq.quantize_dense_param(_dense(rng, 256, 128)), lambda a: torch.from_numpy(np.asarray(a)))
    with tl.act_quant(True):
        plain = tffn.fused_ffn(up, dn, x, "gelu", torch.bfloat16)
        with_nk = tffn.fused_ffn(dict(up, w_t=tffn.nk_weight(up["w_q"])), dict(dn, w_t=tffn.nk_weight(dn["w_q"])),
                                 x, "gelu", torch.bfloat16)
    assert torch.equal(plain, with_nk)


@pytest.mark.parametrize("quant_mode", ["int8-dynamic", "int8"])
def test_engine_on_cpu_adds_no_nk_weights(quant_mode):
    """Only an int8-dynamic engine on the card keeps [N, K] FFN copies (K2's
    tensor-core variant); on the CPU the plain version needs none."""
    from gliclass.c_tpu_torch.config import BackboneConfig, GLiClassConfig, RuntimeConfig
    from gliclass.c_tpu_torch.engine import InferenceEngine

    rng = np.random.default_rng(17)
    params = jq.quantize_tree({"backbone": {"layers": {"ffn": {
        "up": {"w": rng.normal(0, 0.05, (2, 32, 64)).astype(np.float32)},
        "down": {"w": rng.normal(0, 0.05, (2, 64, 32)).astype(np.float32)}}}}})
    bb = BackboneConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64)
    cfg = GLiClassConfig(hidden_size=32, class_token_index=7, backbone=bb)
    eng = InferenceEngine(cfg, params, RuntimeConfig(compute_dtype="bfloat16", quant_mode=quant_mode), device="cpu")
    ffn = eng.params["backbone"]["layers"]["ffn"]
    assert "w_t" not in ffn["up"] and "w_t" not in ffn["down"]
    assert ffn["up"]["w_q"].dtype == torch.int8
