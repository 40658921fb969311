"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (sm_90a) and the CUDA toolkit, and skips
with a reason without one. The file imports neither JAX nor the JAX package
and needs no conftest, so on a machine with a card it runs as

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from gliclass.c_tpu_torch.config import BackboneConfig, GLiClassConfig, RuntimeConfig
from gliclass.c_tpu_torch.engine import InferenceEngine
from gliclass.c_tpu_torch.ops import causal_attention as CA
from gliclass.c_tpu_torch.ops import fused_attention as FA
from gliclass.c_tpu_torch.ops import fused_ffn as FF
from gliclass.c_tpu_torch.ops import int8_matmul as IM
from gliclass.c_tpu_torch.ops.quant import quantize_tree, quantize_weight
from gliclass.c_tpu_torch.tokenization import TokenizedBatch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _attn_inputs(dev, B, h, S, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(B, h, S, 64, generator=g, device=dev).to(dtype) for _ in range(3))
    pk, pq = (torch.randn(h, 2 * S - 1, 64, generator=g, device=dev).to(dtype) for _ in range(2))
    mask = torch.ones(B, S, dtype=torch.int32, device=dev)
    mask[1, max(1, S // 2):] = 0  # ragged row
    mask[2, 1:] = 0           # a padded batch row: one valid key
    mask[3, : min(70, S - 1)] = 0  # the first key tile wholly masked
    return q, k, v, pk, pq, mask


# Every bucket of the bench's ladder, plus lengths off any tile boundary.
@pytest.mark.parametrize("S", [1, 56, 72, 88, 100, 104, 120, 128, 130, 192, 200, 256, 384, 512])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_attention_kernel_matches_plain(dev, S, dtype, tol):
    args = _attn_inputs(dev, 4, 3, S, dtype, S)
    scale = math.sqrt(3 * 64)
    got = FA.flash_disentangled_attention(*args, scale)
    want = FA.flash_disentangled_attention_plain(*args, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_attention_kernel_checks_inputs(dev):
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, 32, torch.float32, 0)
    with pytest.raises(ValueError, match="int32"):
        FA.flash_disentangled_attention(q, k, v, pk, pq, mask.long(), 8.0)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_disentangled_attention(q[..., :32], k[..., :32], v[..., :32], pk, pq, mask, 8.0)


def _ffn_args(dev, M, H, I, seed):
    rng = np.random.default_rng(seed)
    wu, su = quantize_weight(rng.normal(0, 0.05, (H, I)).astype(np.float32))
    wd, sd = quantize_weight(rng.normal(0, 0.05, (I, H)).astype(np.float32))
    c = lambda a: torch.from_numpy(np.asarray(a, dtype=a.dtype)).to(dev)
    x = torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32)).to(dev, torch.bfloat16)
    bu = c(rng.normal(0, 0.05, I).astype(np.float32))
    bd = c(rng.normal(0, 0.05, H).astype(np.float32))
    return x, c(wu), c(su), bu, c(wd), c(sd), bd, "gelu"


@pytest.mark.parametrize("M,H,I", [(1, 128, 256), (40, 128, 256), (300, 768, 3072)])
def test_ffn_kernel_matches_plain(dev, M, H, I):
    args = _ffn_args(dev, M, H, I, M)
    got = FF.fused_ffn_w8a8(*args).float()
    want = FF.fused_ffn_w8a8_plain(*args).float()
    torch.cuda.synchronize()
    # a few bf16 ulps of the output, plus a rare int8 re-quantization step
    tol = 4 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("M,K,N", [(1, 64, 8), (70, 96, 40), (300, 768, 2304)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_matmul_kernel_matches_plain(dev, M, K, N, dtype, with_bias):
    rng = np.random.default_rng(M + K + N)
    w_q, scale = quantize_weight(rng.normal(0, 0.05, (K, N)).astype(np.float32))
    w_q, scale = torch.from_numpy(w_q).to(dev), torch.from_numpy(scale).to(dev)
    bias = torch.from_numpy(rng.normal(0, 0.05, N).astype(np.float32)).to(dev) if with_bias else None
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev, dtype)
    got = IM.int8_matmul(x, w_q, scale, bias).float()
    want = IM.int8_matmul_plain(x, w_q, scale, bias).float()
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= tol


def test_engine_on_card_matches_cpu_and_uses_the_kernels(dev):
    """A small model with the kernels' head width (d=64), on the card by
    default, against the same engine on the CPU (plain versions)."""
    bb = BackboneConfig(vocab_size=300, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=256, max_position_embeddings=128, position_buckets=16)
    cfg = GLiClassConfig(hidden_size=128, class_token_index=7, backbone=bb)
    rng = np.random.default_rng(0)

    def dense(i, o, lead=()):
        return {"w": rng.normal(0, 0.05, (*lead, i, o)).astype(np.float32),
                "b": rng.normal(0, 0.02, (*lead, o)).astype(np.float32)}

    ln = lambda lead=(): {"scale": np.ones((*lead, 128), np.float32), "bias": np.zeros((*lead, 128), np.float32)}
    L = (2,)
    params = quantize_tree({
        "backbone": {
            "embeddings": {"word": rng.normal(size=(300, 128)).astype(np.float32), "ln": ln()},
            "rel_embeddings": rng.normal(size=(32, 128)).astype(np.float32), "rel_ln": ln(),
            "layers": {"attn": {**{n: dense(128, 128, L) for n in "qkvo"}, "ln": ln(L)},
                       "ffn": {"up": dense(128, 256, L), "down": dense(256, 128, L), "ln": ln(L)}},
        },
        "head": {p: {"linear_1": dense(128, 512), "linear_2": dense(512, 128)}
                 for p in ("text_projector", "classes_projector")},
    })
    ids = rng.integers(10, 290, size=(5, 40)).astype(np.int32)
    ids[:, 1:6:2] = 7
    mask = np.ones_like(ids)
    mask[3, 25:] = 0
    batch = TokenizedBatch(ids, mask, mask.sum(1).astype(np.int32))
    for quant_mode, kernels in (("int8-dynamic", (FA, FF)), ("int8", (FA, IM))):
        rt = RuntimeConfig(batch_size=8, compute_dtype="bfloat16", quant_mode=quant_mode)
        card = InferenceEngine(cfg, params, rt)
        assert card.device.type == "cuda"
        for mod in kernels:
            mod.launches = 0
        got = card.run(batch, 4)
        assert all(mod.launches > 0 for mod in kernels)
        want = InferenceEngine(cfg, params, rt, device="cpu").run(batch, 4)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=3e-2)


@pytest.mark.parametrize("M,H,I", [(1, 128, 256), (40, 128, 256), (300, 768, 3072), (8192, 768, 3072)])
def test_ffn_wonly_kernel_matches_plain(dev, M, H, I):
    args = _ffn_args(dev, M, H, I, M + 1)
    FF.launches_wonly = 0
    got = FF.fused_ffn_wonly(*args).float()
    assert FF.launches_wonly == 1
    want = FF.fused_ffn_wonly_plain(*args).float()
    torch.cuda.synchronize()
    # a few bf16 ulps of the output: the fp32 sums differ in order, which can
    # move one bf16 step of the rounded intermediate
    tol = 4 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= tol


def test_ffn_kernels_check_inputs(dev):
    x, wu, su, bu, wd, sd, bd, _ = _ffn_args(dev, 8, 128, 256, 0)
    with pytest.raises(ValueError, match="tanh-gelu"):
        FF.fused_ffn_wonly(x, wu, su, bu, wd, sd, bd, "silu")
    with pytest.raises(ValueError, match="bf16"):
        FF.fused_ffn_wonly(x.float(), wu, su, bu, wd, sd, bd, "gelu")


def _causal_inputs(dev, B, nkv, g, S, d, dtype, seed):
    """q as a head view of a [B, S, nh*d] projection (the model's layout),
    k and v contiguous; ragged right padding and a padded batch row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, nkv * g * d, generator=gen, device=dev).to(dtype)
    qg = q.reshape(B, S, nkv, g, d).permute(0, 2, 3, 1, 4)
    k, v = (torch.randn(B, nkv, S, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    mask = torch.ones(B, S, dtype=torch.int32, device=dev)
    if B > 1:
        mask[1, 1:] = 0               # a padded batch row: key 0 only
    if B > 2:
        mask[2, max(1, S // 2):] = 0  # a ragged row
    return qg, k, v, mask


@pytest.mark.parametrize("S", [1, 12, 56, 64, 65, 88, 128, 130, 512])
@pytest.mark.parametrize("nkv,g,d", [(2, 6, 128), (4, 1, 128), (1, 4, 64), (2, 2, 8)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_causal_kernel_matches_plain(dev, S, nkv, g, d, dtype, tol):
    qg, k, v, mask = _causal_inputs(dev, 3, nkv, g, S, d, dtype, S + d)
    scale = 1.0 / math.sqrt(d)
    CA.launches = 0
    got = CA.causal_flash_attention(qg, k, v, mask, scale)
    assert CA.launches == 1
    want = CA.causal_flash_attention_plain(qg, k, v, mask, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    # the output's memory is [B, S, nh, d]: merging heads is a view
    assert got.permute(0, 3, 1, 2, 4).is_contiguous()


def test_causal_kernel_row_without_valid_key_is_zero(dev):
    qg, k, v, mask = _causal_inputs(dev, 1, 2, 2, 70, 64, torch.float32, 0)
    mask[0, :66] = 0  # the first key tile wholly masked; rows 0..65 see no valid key
    got = CA.causal_flash_attention(qg, k, v, mask, 0.125)
    want = CA.causal_flash_attention_plain(qg, k, v, mask, 0.125)
    torch.cuda.synchronize()
    assert (got[..., :66, :] == 0).all()
    assert (got - want).abs().max().item() <= 1e-4


def test_causal_kernel_checks_inputs(dev):
    qg, k, v, mask = _causal_inputs(dev, 2, 2, 2, 16, 64, torch.float32, 0)
    with pytest.raises(ValueError, match="int32"):
        CA.causal_flash_attention(qg, k, v, mask.long(), 0.125)
    with pytest.raises(TypeError, match="share"):
        CA.causal_flash_attention(qg, k.bfloat16(), v, mask, 0.125)
    big = torch.zeros(2, 1, 1, 16, 160, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        CA.causal_flash_attention(big, big[:, :, 0], big[:, :, 0], mask, 0.1)


def test_decoder_engine_on_card_matches_cpu_and_uses_the_kernels(dev):
    """A small qwen2-style model with the kernel's head width (d=128, g=2),
    on the card by default, against the same engine on the CPU."""
    from gliclass.c_tpu_torch.ops.quant import quantize_dense_param

    H, nh, nkv, d, I, L = 256, 2, 1, 128, 512, 2
    bb = BackboneConfig(model_type="qwen2", vocab_size=300, hidden_size=H, num_hidden_layers=L,
                        num_attention_heads=nh, num_key_value_heads=nkv, intermediate_size=I,
                        hidden_act="silu", relative_attention=False, attention_bias=True)
    cfg = GLiClassConfig(hidden_size=H, class_token_index=7, prompt_first=False, backbone=bb)
    rng = np.random.default_rng(1)

    def dense(i, o, bias=False, std=0.05):
        p = {"w": rng.normal(0, std, (L, i, o)).astype(np.float32)}
        if bias:
            p["b"] = rng.normal(0, 0.02, (L, o)).astype(np.float32)
        return p

    norm = lambda lead=(L,): {"scale": (1 + rng.normal(0, 0.05, (*lead, H))).astype(np.float32)}
    params = quantize_tree({
        "backbone": {
            "embeddings": {"word": rng.normal(size=(300, H)).astype(np.float32)},
            "layers": {"attn": {"q": dense(H, nh * d, True), "k": dense(H, nkv * d, True),
                                "v": dense(H, nkv * d, True), "o": dense(nh * d, H)},
                       "attn_norm": norm(),
                       "mlp": {"gate": dense(H, I), "up": dense(H, I), "down": dense(I, H)},
                       "mlp_norm": norm()},
            "final_norm": norm(()),
        },
        "head": {p: {"linear_1": quantize_dense_param({"w": rng.normal(0, 0.02, (H, 4 * H)).astype(np.float32)}),
                     "linear_2": {"w": rng.normal(0, 0.01, (4 * H, H)).astype(np.float32)}}
                 for p in ("text_projector", "classes_projector")},
    })
    ids = rng.integers(10, 290, size=(5, 70)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[3, 40:] = 0
    ids[:, 30:36:2] = 7
    batch = TokenizedBatch(ids, mask, mask.sum(1).astype(np.int32))
    for quant_mode in ("int8-dynamic", "int8"):
        rt = RuntimeConfig(batch_size=8, compute_dtype="bfloat16", quant_mode=quant_mode)
        card = InferenceEngine(cfg, params, rt)
        CA.launches = 0
        got = card.run(batch, 4)
        assert CA.launches == L
        want = InferenceEngine(cfg, params, rt, device="cpu").run(batch, 4)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=3e-2)


# ---------------------------------------------------------------------------
# The bias route: K6 (tables), K7 (softmax over biases), and the route as a
# whole against K1.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 56, 72, 88, 100, 128, 130, 192, 256, 384, 512, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abs_pos_table_kernel_equals_plain(dev, S, dtype):
    g = torch.Generator(device=dev).manual_seed(S)
    pos = torch.randn(3 if S <= 512 else 1, 2 * S - 1, 64, generator=g, device=dev).to(dtype)
    got = FA.abs_pos_table(pos, S)
    want = FA.abs_pos_table_plain(pos, S)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)  # a copy of values: exact


@pytest.mark.parametrize("d", [8, 128])
def test_abs_pos_table_kernel_other_widths(dev, d):
    g = torch.Generator(device=dev).manual_seed(d)
    pos = torch.randn(2, 2 * 130 - 1, d, generator=g, device=dev)
    assert torch.equal(FA.abs_pos_table(pos, 130), FA.abs_pos_table_plain(pos, 130))


def _bias_inputs(dev, S, dtype, layout, seed):
    """_attn_inputs plus c2p/p2c: views of [h, S, B, S] products as the route
    passes them ("route"), or dense [B, h, S, S] tensors."""
    q, k, v, _, _, mask = _attn_inputs(dev, 4, 3, S, dtype, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    if layout == "route":
        c2p = (4 * torch.randn(3, S, 4, S, generator=g, device=dev)).to(dtype).permute(2, 0, 1, 3)
        p2c = (4 * torch.randn(3, S, 4, S, generator=g, device=dev)).to(dtype).permute(2, 0, 3, 1)
    else:
        c2p, p2c = ((4 * torch.randn(4, 3, S, S, generator=g, device=dev)).to(dtype) for _ in range(2))
    return q, k, v, c2p, p2c, mask


@pytest.mark.parametrize("S", [1, 56, 88, 128, 130, 256, 512, 600, 1024, 2048])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("layout", ["route", "dense"])
def test_bias_kernel_matches_plain(dev, S, dtype, tol, layout):
    """Over the ladder (64, 32 and 16 rows per block), with ragged, single and
    leading-masked keys (_attn_inputs), in both bias layouts."""
    args = _bias_inputs(dev, S, dtype, layout, S)
    scale = math.sqrt(3 * 64)
    got = FA.bias_fused_attention(*args, scale)
    want = FA.bias_fused_attention_plain(*args, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_bias_kernel_row_without_valid_key_is_the_mean_of_v(dev):
    """A row with every key masked: all scores sit at -1e30, so both versions
    average v over the S keys (the engine never builds such a row)."""
    q, k, v, c2p, p2c, mask = _bias_inputs(dev, 100, torch.float32, "route", 0)
    mask[0] = 0
    got = FA.bias_fused_attention(q, k, v, c2p, p2c, mask, 8.0)
    want = FA.bias_fused_attention_plain(q, k, v, c2p, p2c, mask, 8.0)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    assert (got[0] - v[0].mean(dim=1, keepdim=True)).abs().max().item() <= 1e-5


def test_bias_kernel_checks_inputs(dev):
    q, k, v, c2p, p2c, mask = _bias_inputs(dev, 32, torch.float32, "route", 0)
    with pytest.raises(ValueError, match="int32"):
        FA.bias_fused_attention(q, k, v, c2p, p2c, mask.long(), 8.0)
    with pytest.raises(ValueError, match="head dim"):
        FA.bias_fused_attention(q[..., :32], k[..., :32], v[..., :32], c2p, p2c, mask, 8.0)
    with pytest.raises(ValueError, match="one type"):
        FA.bias_fused_attention(q, k, v, c2p, p2c.to(torch.bfloat16), mask, 8.0)
    q, k, v, c2p, p2c, mask = _bias_inputs(dev, 2056, torch.bfloat16, "dense", 0)
    with pytest.raises(ValueError, match="2048"):
        FA.bias_fused_attention(q, k, v, c2p, p2c, mask, 8.0)


@pytest.mark.parametrize("S", [56, 88, 128, 512, 1024, 2048])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_bias_route_matches_flash_route(dev, S, dtype, tol):
    """table_bias_attention (K6, bias products, K7) against K1 on the same
    inputs. bf16 stores the biases in bf16, which K1 never rounds."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, S, dtype, S + 7)
    scale = math.sqrt(3 * 64)
    FA.launches_table = FA.launches_bias = 0
    got = FA.table_bias_attention(q, k, v, pk, pq, mask, scale, score_dtype=dtype)
    want = FA.flash_disentangled_attention(q, k, v, pk, pq, mask, scale)
    torch.cuda.synchronize()
    assert (FA.launches_table, FA.launches_bias) == (2, 1)
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_engine_bias_route_on_card(dev):
    """The engine with attn_route="bias" launches K6 twice and K7 once per
    layer and no K1, and agrees with the CPU (plain versions) and with the
    flash route on the card."""
    bb = BackboneConfig(vocab_size=300, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=256, max_position_embeddings=128, position_buckets=16)
    cfg = GLiClassConfig(hidden_size=128, class_token_index=7, backbone=bb)
    rng = np.random.default_rng(2)
    dense = lambda i, o, lead=(): {"w": rng.normal(0, 0.05, (*lead, i, o)).astype(np.float32),
                                   "b": rng.normal(0, 0.02, (*lead, o)).astype(np.float32)}
    ln = lambda lead=(): {"scale": np.ones((*lead, 128), np.float32), "bias": np.zeros((*lead, 128), np.float32)}
    L = (2,)
    params = {
        "backbone": {
            "embeddings": {"word": rng.normal(size=(300, 128)).astype(np.float32), "ln": ln()},
            "rel_embeddings": rng.normal(size=(32, 128)).astype(np.float32), "rel_ln": ln(),
            "layers": {"attn": {**{n: dense(128, 128, L) for n in "qkvo"}, "ln": ln(L)},
                       "ffn": {"up": dense(128, 256, L), "down": dense(256, 128, L), "ln": ln(L)}},
        },
        "head": {p: {"linear_1": dense(128, 512), "linear_2": dense(512, 128)}
                 for p in ("text_projector", "classes_projector")},
    }
    ids = rng.integers(10, 290, size=(5, 40)).astype(np.int32)
    ids[:, 1:6:2] = 7
    mask = np.ones_like(ids)
    mask[3, 25:] = 0
    batch = TokenizedBatch(ids, mask, mask.sum(1).astype(np.int32))
    rt = RuntimeConfig(batch_size=8, compute_dtype="float32", attn_route="bias")
    card = InferenceEngine(cfg, params, rt)
    FA.launches = FA.launches_table = FA.launches_bias = 0
    got = card.run(batch, 4)
    assert (FA.launches, FA.launches_table, FA.launches_bias) == (0, 4, 2)
    want = InferenceEngine(cfg, params, rt, device="cpu").run(batch, 4)
    flash = InferenceEngine(cfg, params, dataclasses.replace(rt, attn_route="flash")).run(batch, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, flash, atol=1e-5)
