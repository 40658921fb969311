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


# Every bucket of the bench's ladder, plus lengths off any tile boundary and
# two long ones; ragged, single-key and leading-masked rows (_attn_inputs: at
# S > 70 the first key tile of row 3 is wholly masked). bf16 runs the
# tensor-core variant, fp32 the CUDA-core one.
@pytest.mark.parametrize("S", [1, 56, 72, 88, 100, 104, 120, 128, 130, 192, 200, 256, 384, 512, 1024, 2048])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_attention_kernel_matches_plain(dev, S, dtype, tol):
    args = _attn_inputs(dev, 4, 3 if S <= 512 else 1, S, dtype, S)
    scale = math.sqrt(3 * 64)
    FA.launches = FA.launches_flash_tc = 0
    got = FA.flash_disentangled_attention(*args, scale)
    assert (FA.launches, FA.launches_flash_tc) == (1, int(dtype == torch.bfloat16))
    want = FA.flash_disentangled_attention_plain(*args, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert got.permute(0, 2, 1, 3).is_contiguous()


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


def _nk(args):
    """The [N, K] weights K2's tensor-core variant reads, as the engine makes them."""
    return dict(wt_up=FF.nk_weight(args[1]), wt_dn=FF.nk_weight(args[4]))


def _ffn_cuda_core(args):
    """The CUDA-core K2's C entry on the wrapper's arguments (the wrapper
    sends H, I multiples of 16 to tensor cores)."""
    from gliclass.c_tpu_torch.ops import _build

    x = args[0]
    M, H = x.shape
    out = torch.empty_like(x)
    rc = _build.lib().gct_fused_ffn_w8a8(*(a.data_ptr() for a in args[:7]), out.data_ptr(), M, H,
                                         args[1].shape[1], _build.stream_ptr(x))
    _build.check(rc, "gct_fused_ffn_w8a8")
    return out


# Multiples of 16 (all of these) take the tensor-core variant, which must also
# equal the CUDA-core K2 bit for bit: exact int32 sums and the same fp32
# operations in the same order.
@pytest.mark.parametrize("M,H,I", [(1, 128, 256), (40, 128, 256), (300, 768, 3072), (8192, 768, 3072),
                                   (129, 32, 64), (1000, 768, 3072)])
def test_ffn_kernel_matches_plain(dev, M, H, I):
    args = _ffn_args(dev, M, H, I, M)
    FF.launches = FF.launches_tc = 0
    got = FF.fused_ffn_w8a8(*args, **_nk(args))
    assert (FF.launches, FF.launches_tc) == (1, 1)
    want = FF.fused_ffn_w8a8_plain(*args).float()
    cc = _ffn_cuda_core(args)
    torch.cuda.synchronize()
    # a few bf16 ulps of the output, plus a rare int8 re-quantization step
    tol = 4 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got.float() - want).abs().max().item() <= tol
    assert torch.equal(got, cc)


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


# (M, H, I): multiples of 16 take the tensor-core variant (gliclass-base's
# FFN at M = 8192 among them); H = 100, I = 196 and I = 200 the fused
# CUDA-core kernel.
@pytest.mark.parametrize("M,H,I", [(1, 128, 256), (40, 128, 256), (300, 768, 3072), (8192, 768, 3072),
                                   (1, 100, 196), (40, 100, 196), (300, 96, 200), (130, 32, 64)])
def test_ffn_wonly_kernel_matches_plain(dev, M, H, I):
    args = _ffn_args(dev, M, H, I, M + 1)
    FF.launches_wonly = FF.launches_wonly_tc = 0
    got = FF.fused_ffn_wonly(*args).float()
    assert (FF.launches_wonly, FF.launches_wonly_tc) == (1, int(H % 16 == 0 and I % 16 == 0))
    want = FF.fused_ffn_wonly_plain(*args).float()
    torch.cuda.synchronize()
    # a few bf16 ulps of the output: the fp32 sums differ in order, which can
    # move one bf16 step of the rounded intermediate
    tol = 4 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("H,I,tc", [(768, 3072, 1), (128, 256, 1), (32, 64, 1), (100, 196, 0), (96, 200, 0),
                                    (200, 96, 0)])
def test_ffn_wonly_variant_launch_counters(dev, H, I, tc):
    """Every K4 call counts once in launches_wonly (the tensor-core variant's
    two launches too), only those with H and I multiples of 16 in
    launches_wonly_tc."""
    args = _ffn_args(dev, 70, H, I, H + I)
    FF.launches_wonly = FF.launches_wonly_tc = 0
    got = FF.fused_ffn_wonly(*args).float()
    assert (FF.launches_wonly, FF.launches_wonly_tc) == (1, tc)
    assert FF.kernel_variant(H, I) == (FA.TENSOR_CORE if tc else FA.CUDA_CORE)
    want = FF.fused_ffn_wonly_plain(*args).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 4 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)


def test_ffn_wonly_tc_kernel_realigns_a_view_and_takes_stacked_weights(dev):
    """x rows starting 2 bytes off a 16-byte boundary (a view one element
    into its storage) are copied; weights as slices of a stacked [L, H, I]
    tensor (the engine's layout) are taken as they are."""
    x, wu, su, bu, wd, sd, bd, act = _ffn_args(dev, 40, 128, 256, 5)
    flat = torch.cat([x.new_zeros(1), x.reshape(-1)])
    xv = flat[1:].view(40, 128)
    wus, wds = torch.stack([wu.flip(0), wu]), torch.stack([wd.flip(0), wd])
    FF.launches_wonly_tc = 0
    got = FF.fused_ffn_wonly(xv, wus[1], su, bu, wds[1], sd, bd, act).float()
    assert FF.launches_wonly_tc == 1
    want = FF.fused_ffn_wonly_plain(x, wu, su, bu, wd, sd, bd, act).float()
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 4 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)


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
    """bf16 at d = 64 and 128 runs the tensor-core variant (exp by
    ex2.approx, one reciprocal per row: within bf16's 2e-2), fp32 and d = 8
    the CUDA-core one."""
    qg, k, v, mask = _causal_inputs(dev, 3, nkv, g, S, d, dtype, S + d)
    scale = 1.0 / math.sqrt(d)
    CA.launches = CA.launches_tc = 0
    got = CA.causal_flash_attention(qg, k, v, mask, scale)
    assert (CA.launches, CA.launches_tc) == (1, int(dtype == torch.bfloat16 and d != 8))
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


@pytest.mark.parametrize("S", [1, 63, 129, 300, 1024, 2048])
@pytest.mark.parametrize("nkv,g,d", [(2, 6, 128), (1, 3, 16), (2, 2, 32), (1, 2, 48), (2, 1, 80), (1, 1, 112)])
def test_causal_tc_kernel_matches_plain(dev, S, nkv, g, d):
    """K5's tensor-core variant at every head width it takes (d below 64 or
    128 zero-padded in the tile) and lengths off the 64-key tiles."""
    qg, k, v, mask = _causal_inputs(dev, 3, nkv, g, S, d, torch.bfloat16, S + 7 * d)
    scale = 1.0 / math.sqrt(d)
    CA.launches_tc = 0
    got = CA.causal_flash_attention(qg, k, v, mask, scale)
    assert CA.launches_tc == 1
    want = CA.causal_flash_attention_plain(qg, k, v, mask, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert got.permute(0, 3, 1, 2, 4).is_contiguous()


@pytest.mark.parametrize("S", [70, 200])
def test_causal_tc_kernel_row_without_valid_key_is_zero(dev, S):
    """bf16: rows that see no valid key (the first key tile wholly masked,
    and a batch row masked everywhere) give exactly 0."""
    qg, k, v, mask = _causal_inputs(dev, 2, 2, 2, S, 64, torch.bfloat16, 0)
    mask[0, :66] = 0
    mask[1] = 0
    CA.launches_tc = 0
    got = CA.causal_flash_attention(qg, k, v, mask, 0.125)
    assert CA.launches_tc == 1
    want = CA.causal_flash_attention_plain(qg, k, v, mask, 0.125)
    torch.cuda.synchronize()
    assert (got[0, ..., :66, :] == 0).all() and (got[1] == 0).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


def test_causal_tc_kernel_realigns_views(dev):
    """q starting 2 bytes off a 16-byte boundary and k, v with a row stride
    that is no multiple of 8 elements: the wrapper copies them, the
    tensor-core variant runs."""
    B, nkv, g, S, d = 2, 2, 3, 100, 64
    gen = torch.Generator(device=dev).manual_seed(3)
    flat = torch.randn(B * nkv * g * S * d + 1, generator=gen, device=dev).to(torch.bfloat16)
    qg = flat[1:].view(B, nkv, g, S, d)
    k, v = (torch.randn(B, nkv, S, d + 4, generator=gen, device=dev).to(torch.bfloat16)[..., :d] for _ in range(2))
    mask = torch.ones(B, S, dtype=torch.int32, device=dev)
    mask[1, 60:] = 0
    CA.launches_tc = 0
    got = CA.causal_flash_attention(qg, k, v, mask, 0.125)
    assert CA.launches_tc == 1
    want = CA.causal_flash_attention_plain(qg, k, v, mask, 0.125)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype,d,tc", [
    (torch.bfloat16, 128, 1), (torch.bfloat16, 64, 1), (torch.bfloat16, 16, 1), (torch.bfloat16, 8, 0),
    (torch.bfloat16, 40, 0), (torch.float32, 128, 0), (torch.float32, 64, 0)])
def test_causal_variant_launch_counters(dev, dtype, d, tc):
    """Every K5 launch counts in launches, only bf16 with d a multiple of 16
    in launches_tc; fp32 keeps the CUDA-core kernel at 1e-4."""
    qg, k, v, mask = _causal_inputs(dev, 3, 2, 2, 90, d, dtype, d)
    CA.launches = CA.launches_tc = 0
    got = CA.causal_flash_attention(qg, k, v, mask, 1.0 / math.sqrt(d))
    assert (CA.launches, CA.launches_tc) == (1, tc)
    assert CA.kernel_variant(dtype, d) == (FA.TENSOR_CORE if tc else FA.CUDA_CORE)
    want = CA.causal_flash_attention_plain(qg, k, v, mask, 1.0 / math.sqrt(d))
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= (2e-2 if dtype == torch.bfloat16 else 1e-4)


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
        CA.launches = CA.launches_tc = 0
        got = card.run(batch, 4)
        assert (CA.launches, CA.launches_tc) == (L, L)
        want = InferenceEngine(cfg, params, rt, device="cpu").run(batch, 4)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=3e-2)


# ---------------------------------------------------------------------------
# The bias route: K6 (tables), K7 (softmax over biases), and the route as a
# whole against K1.
# ---------------------------------------------------------------------------
# S = 1024, 1030 and 2048 span more than one block of key columns; S not a
# multiple of 8 (bf16) or 4 (fp32) takes the element-wise store path.
@pytest.mark.parametrize("S", [1, 56, 72, 88, 100, 128, 130, 192, 256, 384, 512, 1024, 1030, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abs_pos_table_kernel_equals_plain(dev, S, dtype):
    g = torch.Generator(device=dev).manual_seed(S)
    pos = torch.randn(3 if S <= 512 else 1, 2 * S - 1, 64, generator=g, device=dev).to(dtype)
    FA.launches_table = 0
    got = FA.abs_pos_table(pos, S)
    assert FA.launches_table == 1
    want = FA.abs_pos_table_plain(pos, S)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)  # a copy of values: exact


@pytest.mark.parametrize("S", [7, 100, 130])
@pytest.mark.parametrize("d", [6, 8, 32, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abs_pos_table_kernel_other_widths(dev, S, d, dtype):
    """d = 6 is no whole number of 16-byte vectors (element-wise staging)."""
    g = torch.Generator(device=dev).manual_seed(S * d)
    pos = torch.randn(2, 2 * S - 1, d, generator=g, device=dev).to(dtype)
    assert torch.equal(FA.abs_pos_table(pos, S), FA.abs_pos_table_plain(pos, S))


def _unaligned(dev, shape, dtype, seed):
    """A contiguous table that starts one element past a 16-byte boundary."""
    n = math.prod(shape)
    pos = torch.empty(n + 1, dtype=dtype, device=dev)[1:].view(shape)
    pos.copy_(torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed), device=dev))
    assert pos.is_contiguous() and pos.data_ptr() % 16 != 0
    return pos


@pytest.mark.parametrize("S", [88, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_abs_pos_table_kernel_unaligned_input(dev, S, dtype):
    pos = _unaligned(dev, (3, 2 * S - 1, 64), dtype, S)
    assert torch.equal(FA.abs_pos_table(pos, S), FA.abs_pos_table_plain(pos, S))


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


# ---------------------------------------------------------------------------
# The row route (K8) and the tiled route (K9 windowed tables, K10), and both
# routes through the engine.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 8, 56, 64, 65, 88, 128, 200, 256, 384, 512])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_row_kernel_matches_plain(dev, S, dtype, tol):
    """K8 over lengths up to 512 (one to eight row tiles, ragged edges), with
    ragged, single and leading-masked keys (_attn_inputs)."""
    args = _attn_inputs(dev, 4, 3, S, dtype, S + 11)
    scale = math.sqrt(3 * 64)
    FA.launches_row = 0
    got = FA.row_disentangled_attention(*args, scale)
    assert FA.launches_row == 1
    want = FA.row_disentangled_attention_plain(*args, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert got.permute(0, 2, 1, 3).is_contiguous()  # [B, S, h, d] in memory


def test_row_kernel_row_without_valid_key_is_the_mean_of_v(dev):
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, 100, torch.float32, 1)
    mask[0] = 0
    got = FA.row_disentangled_attention(q, k, v, pk, pq, mask, 8.0)
    want = FA.row_disentangled_attention_plain(q, k, v, pk, pq, mask, 8.0)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5
    assert (got[0] - v[0].mean(dim=1, keepdim=True)).abs().max().item() <= 1e-5


def test_row_kernel_checks_inputs(dev):
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, 32, torch.float32, 0)
    with pytest.raises(ValueError, match="int32"):
        FA.row_disentangled_attention(q, k, v, pk, pq, mask.long(), 8.0)
    with pytest.raises(ValueError, match="head dim"):
        FA.row_disentangled_attention(q[..., :32], k[..., :32], v[..., :32], pk, pq, mask, 8.0)
    with pytest.raises(ValueError, match="pos_k_rel"):
        FA.row_disentangled_attention(q, k, v, pk[:, 1:], pq, mask, 8.0)
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 1, 520, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="512"):
        FA.row_disentangled_attention(q, k, v, pk, pq, mask, 8.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_and_tiled_kernels_rows_not_16_byte_aligned(dev, dtype):
    """q/k/v rows 65 elements apart and one element off alignment, and
    relative tables one element off: the kernels' element-wise loads."""
    g = torch.Generator(device=dev).manual_seed(5)
    S = 96
    q, k, v = (torch.randn(4, 3, S, 65, generator=g, device=dev).to(dtype)[..., 1:] for _ in range(3))
    flat = torch.randn(2 * 3 * (2 * S - 1) * 64 + 1, generator=g, device=dev).to(dtype)
    pk, pq = flat[1:].view(2, 3, 2 * S - 1, 64)
    mask = torch.ones(4, S, dtype=torch.int32, device=dev)
    mask[1, 40:] = 0
    for fn, plain in ((FA.row_disentangled_attention, FA.row_disentangled_attention_plain),
                      (FA.tiled_bias_attention, FA.tiled_bias_attention_plain)):
        got = fn(q, k, v, pk, pq, mask, 8.0)
        want = plain(q, k, v, pk, pq, mask, 8.0)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert (got.float() - want.float()).abs().max().item() <= tol


# blk = 1024: the rows a block shares exceed 48 KB, so it copies from pos_rel
# directly.
@pytest.mark.parametrize("S,blk", [(32, 32), (64, 8), (88, 8), (128, 32), (512, 32), (512, 64), (2048, 32),
                                   (1024, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_table_kernel_equals_plain(dev, S, blk, dtype):
    g = torch.Generator(device=dev).manual_seed(S + blk)
    pos = torch.randn(3 if S <= 512 else 1, 2 * S - 1, 64, generator=g, device=dev).to(dtype)
    FA.launches_win_table = 0
    got = FA.windowed_pos_tables(pos, blk)
    assert FA.launches_win_table == 1
    want = FA.windowed_pos_tables_plain(pos, blk)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.equal(got, want)  # a copy of values: exact


@pytest.mark.parametrize("d", [6, 8, 128])
def test_windowed_table_kernel_other_widths(dev, d):
    """d whose rows are not whole 16-byte vectors takes the elementwise copy."""
    pos = torch.randn(2, 2 * 96 - 1, d, generator=torch.Generator(device=dev).manual_seed(d), device=dev)
    assert torch.equal(FA.windowed_pos_tables(pos, 16), FA.windowed_pos_tables_plain(pos, 16))


@pytest.mark.parametrize("S,blk", [(128, 32), (512, 32), (96, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_table_kernel_unaligned_input(dev, S, blk, dtype):
    pos = _unaligned(dev, (3, 2 * S - 1, 64), dtype, S + blk)
    assert torch.equal(FA.windowed_pos_tables(pos, blk), FA.windowed_pos_tables_plain(pos, blk))


def test_windowed_table_kernel_checks_inputs(dev):
    pos = torch.randn(2, 2 * 96 - 1, 64, device=dev)
    with pytest.raises(ValueError, match="multiple of blk"):
        FA.windowed_pos_tables(pos, 64)
    with pytest.raises(ValueError, match="contiguous"):
        FA.windowed_pos_tables(pos.transpose(0, 1).contiguous().transpose(0, 1), 32)


@pytest.mark.parametrize("S", [32, 64, 96, 128, 256, 512, 2048])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_tiled_kernel_matches_plain(dev, S, dtype, tol):
    """K10 on K9's tables (blk 32, the route's) against its plain version on
    the same tables, with ragged, single and leading-masked keys."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3 if S <= 512 else 1, S, dtype, S + 13)
    scale = math.sqrt(3 * 64)
    twc, twq = FA.windowed_pos_tables(pk, 32), FA.windowed_pos_tables(pq, 32)
    FA.launches_tiled = 0
    got = FA.tiled_attention(q, k, v, twc, twq, mask, scale)
    assert FA.launches_tiled == 1
    want = FA.tiled_attention_plain(q, k, v, twc, twq, mask, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert got.permute(0, 2, 1, 3).is_contiguous()


@pytest.mark.parametrize("B,blk,dtype,table_dtype", [
    (10, 8, torch.float32, torch.float32), (10, 64, torch.bfloat16, torch.bfloat16),
    (9, 128, torch.float32, torch.bfloat16), (1, 16, torch.bfloat16, torch.float32)])
def test_tiled_kernel_batch_groups_blocks_and_types(dev, B, blk, dtype, table_dtype):
    """Batch sizes that leave a group of 8 rows part full, other table blocks,
    and tables in another type than q/k/v."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, max(B, 4), 3, 128, dtype, B + blk)
    q, k, v, mask = q[:B], k[:B], v[:B], mask[:B].contiguous()
    twc = FA.windowed_pos_tables(pk.to(table_dtype), blk)
    twq = FA.windowed_pos_tables(pq.to(table_dtype), blk)
    got = FA.tiled_attention(q, k, v, twc, twq, mask, 8.0)
    want = FA.tiled_attention_plain(q, k, v, twc, twq, mask, 8.0)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_tiled_kernel_row_without_valid_key_is_the_mean_of_v(dev):
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, 96, torch.float32, 2)
    mask[0] = 0
    got = FA.tiled_bias_attention(q, k, v, pk, pq, mask, 8.0)
    torch.cuda.synchronize()
    assert (got[0] - v[0].mean(dim=1, keepdim=True)).abs().max().item() <= 1e-5


def test_tiled_kernel_checks_inputs(dev):
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, 64, torch.float32, 0)
    twc, twq = FA.windowed_pos_tables(pk, 32), FA.windowed_pos_tables(pq, 32)
    with pytest.raises(ValueError, match="int32"):
        FA.tiled_attention(q, k, v, twc, twq, mask.long(), 8.0)
    with pytest.raises(ValueError, match="one type"):
        FA.tiled_attention(q, k, v, twc, twq.to(torch.bfloat16), mask, 8.0)
    with pytest.raises(ValueError, match="windowed table"):
        FA.tiled_attention(q, k, v, twc[:, 1:].contiguous(), twq, mask, 8.0)
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, 48, torch.float32, 0)
    with pytest.raises(ValueError, match="multiple of 32"):
        FA.tiled_bias_attention(q, k, v, pk, pq, mask, 8.0, blk=16)


# ---------------------------------------------------------------------------
# The tensor-core variants of K8 and K10 (bf16, csrc/*_tc.cu)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 8, 56, 64, 65, 88, 200, 512])
def test_row_tc_kernel_matches_plain(dev, S):
    """K8's tensor-core variant over one to eight row tiles and ragged edges,
    with ragged, single and leading-masked keys (_attn_inputs)."""
    args = _attn_inputs(dev, 4, 3, S, torch.bfloat16, S + 29)
    scale = math.sqrt(3 * 64)
    FA.launches_row = FA.launches_row_tc = 0
    got = FA.row_disentangled_attention(*args, scale)
    assert (FA.launches_row, FA.launches_row_tc) == (1, 1)
    want = FA.row_disentangled_attention_plain(*args, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert got.permute(0, 2, 1, 3).is_contiguous()


# (S, B, blk): part and whole groups of 16 batch rows at three lengths, then
# the table blocks (16-row slices crossing a block at blk = 8) and S = 2048.
_TILED_TC_CASES = [(S, B, blk) for B in (1, 9, 16, 17) for S, blk in ((32, 32), (96, 16), (512, 32))] + [
    (32, 17, 8), (96, 17, 8), (512, 17, 8), (512, 16, 16), (512, 16, 64), (512, 9, 128),
    (2048, 9, 32), (2048, 1, 128)]


@pytest.mark.parametrize("S,B,blk", _TILED_TC_CASES)
def test_tiled_tc_kernel_matches_plain(dev, S, B, blk):
    """K10's tensor-core variant on K9's bf16 tables against its plain version
    on the same tables."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, max(B, 4), 3 if S <= 512 else 1, S, torch.bfloat16, S + B + blk)
    q, k, v, mask = q[:B], k[:B], v[:B], mask[:B].contiguous()
    twc, twq = FA.windowed_pos_tables(pk, blk), FA.windowed_pos_tables(pq, blk)
    scale = math.sqrt(3 * 64)
    FA.launches_tiled = FA.launches_tiled_tc = 0
    got = FA.tiled_attention(q, k, v, twc, twq, mask, scale)
    assert (FA.launches_tiled, FA.launches_tiled_tc) == (1, 1)
    want = FA.tiled_attention_plain(q, k, v, twc, twq, mask, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert got.permute(0, 2, 1, 3).is_contiguous()


def test_row_and_tiled_tc_kernels_rows_not_16_byte_aligned(dev):
    """bf16 q/k/v rows 65 elements apart and one element off alignment, and
    relative tables one element off: the tensor-core variants' element loads."""
    g = torch.Generator(device=dev).manual_seed(6)
    S = 96
    q, k, v = (torch.randn(4, 3, S, 65, generator=g, device=dev).to(torch.bfloat16)[..., 1:] for _ in range(3))
    flat = torch.randn(2 * 3 * (2 * S - 1) * 64 + 1, generator=g, device=dev).to(torch.bfloat16)
    pk, pq = flat[1:].view(2, 3, 2 * S - 1, 64)
    mask = torch.ones(4, S, dtype=torch.int32, device=dev)
    mask[1, 40:] = 0
    FA.launches_row_tc = FA.launches_tiled_tc = 0
    row = FA.row_disentangled_attention(q, k, v, pk, pq, mask, 8.0)
    tiled = FA.tiled_bias_attention(q, k, v, pk, pq, mask, 8.0, score_dtype=torch.bfloat16)
    assert (FA.launches_row_tc, FA.launches_tiled_tc) == (1, 1)
    torch.cuda.synchronize()
    want_row = FA.row_disentangled_attention_plain(q, k, v, pk, pq, mask, 8.0)
    want_tiled = FA.tiled_bias_attention_plain(q, k, v, pk, pq, mask, 8.0, score_dtype=torch.bfloat16)
    assert (row.float() - want_row.float()).abs().max().item() <= 2e-2
    assert (tiled.float() - want_tiled.float()).abs().max().item() <= 2e-2


def test_row_and_tiled_tc_kernels_row_without_valid_key_is_the_mean_of_v(dev):
    """bf16: K8 rounds p = 1/S to bf16 before p.v (as its plain version);
    K10 sums exp(0) = 1 per key and divides by S after, so only the output's
    rounding to bf16 remains."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, 96, torch.bfloat16, 3)
    mask[0] = 0
    mean = v[0].float().mean(dim=1, keepdim=True)
    row = FA.row_disentangled_attention(q, k, v, pk, pq, mask, 8.0)
    tiled = FA.tiled_bias_attention(q, k, v, pk, pq, mask, 8.0, score_dtype=torch.bfloat16)
    want = FA.row_disentangled_attention_plain(q, k, v, pk, pq, mask, 8.0)
    torch.cuda.synchronize()
    assert (row.float() - want.float()).abs().max().item() <= 2e-2
    assert (row[0].float() - mean).abs().max().item() <= 2e-2
    assert (tiled[0].float() - mean).abs().max().item() <= 1e-2


@pytest.mark.parametrize("dtype,table_dtype,tc", [
    (torch.bfloat16, torch.bfloat16, 1), (torch.float32, torch.float32, 0),
    (torch.bfloat16, torch.float32, 0), (torch.float32, torch.bfloat16, 0)])
def test_row_and_tiled_variant_launch_counters(dev, dtype, table_dtype, tc):
    """Every launch counts in launches_row / launches_tiled; only bf16 (with
    bf16 tables for K10) counts in the tensor-core counters."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, 64, dtype, 4)
    twc = FA.windowed_pos_tables(pk.to(table_dtype), 32)
    twq = FA.windowed_pos_tables(pq.to(table_dtype), 32)
    FA.launches_row = FA.launches_row_tc = FA.launches_tiled = FA.launches_tiled_tc = 0
    FA.tiled_attention(q, k, v, twc, twq, mask, 8.0)
    assert (FA.launches_tiled, FA.launches_tiled_tc) == (1, tc)
    if table_dtype == dtype:
        FA.row_disentangled_attention(q, k, v, pk, pq, mask, 8.0)
        assert (FA.launches_row, FA.launches_row_tc) == (1, tc)
    torch.cuda.synchronize()


@pytest.mark.parametrize("S", [64, 128, 512, 2048])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_row_and_tiled_routes_match_flash_route(dev, S, dtype, tol):
    """The row route (K8, S <= 512) and the tiled route (K9 twice, K10) against
    K1 on the same inputs. bf16 stores the tiled route's tables in bf16,
    which are the bf16 inputs' values: no extra rounding."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3 if S <= 512 else 1, S, dtype, S + 17)
    scale = math.sqrt(3 * 64)
    flash = FA.flash_disentangled_attention(q, k, v, pk, pq, mask, scale)
    FA.launches_win_table = FA.launches_tiled = 0
    tiled = FA.tiled_bias_attention(q, k, v, pk, pq, mask, scale, score_dtype=dtype)
    assert (FA.launches_win_table, FA.launches_tiled) == (2, 1)
    torch.cuda.synchronize()
    assert (tiled.float() - flash.float()).abs().max().item() <= tol
    if S <= 512:
        row = FA.row_disentangled_attention(q, k, v, pk, pq, mask, scale)
        torch.cuda.synchronize()
        assert (row.float() - flash.float()).abs().max().item() <= tol


@pytest.mark.parametrize("route", ["row", "tiled"])
def test_engine_row_and_tiled_routes_on_card(dev, route):
    """The engine with attn_route "row" (K8 once per layer) or "tiled" (K9
    twice and K10 once per layer at S a multiple of 32, K1 at other S) agrees
    with the CPU (plain versions) and with the flash route on the card; its
    warmup runs every bucket through the route that bucket takes."""
    bb = BackboneConfig(vocab_size=300, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                        intermediate_size=256, max_position_embeddings=128, position_buckets=16)
    cfg = GLiClassConfig(hidden_size=128, class_token_index=7, backbone=bb)
    rng = np.random.default_rng(3)
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
    ids = rng.integers(10, 290, size=(5, 64)).astype(np.int32)
    ids[:, 1:6:2] = 7
    mask = np.ones_like(ids)
    mask[3, 25:] = 0
    batch = TokenizedBatch(ids, mask, mask.sum(1).astype(np.int32))
    rt = RuntimeConfig(batch_size=8, compute_dtype="float32", attn_route=route, seq_buckets=(64, 88),
                       label_buckets=(4,))
    card = InferenceEngine(cfg, params, rt)
    FA.launches = FA.launches_row = FA.launches_win_table = FA.launches_tiled = 0
    got = card.run(batch, 4)
    counts = (FA.launches, FA.launches_row, FA.launches_win_table, FA.launches_tiled)
    assert counts == ((0, 2, 0, 0) if route == "row" else (0, 0, 4, 2))
    want = InferenceEngine(cfg, params, rt, device="cpu").run(batch, 4)
    flash = InferenceEngine(cfg, params, dataclasses.replace(rt, attn_route="flash")).run(batch, 4)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, flash, atol=1e-5)
    # warmup: rows 1, 2, 4, 8 at S = 64 and 88 (88 is no multiple of 32)
    FA.launches = FA.launches_row = FA.launches_win_table = FA.launches_tiled = 0
    assert card.warmup() == 8
    counts = (FA.launches, FA.launches_row, FA.launches_win_table, FA.launches_tiled)
    assert counts == ((0, 16, 0, 0) if route == "row" else (8, 0, 16, 8))


# ---------------------------------------------------------------------------
# The tensor-core variants of K3 and K7 (bf16, csrc/int8_matmul_tc.cu and
# csrc/bias_fused_attention_tc.cu), and a head width the kernels do not take
# ---------------------------------------------------------------------------
# (M, K, N): the encoder's qkv, o, up and down at M = 8192, a ragged M, the
# rel-embedding projection (M = 512, 64-wide tiles), the head's few rows, and
# qwen-1.5B's N = 256 k/v projections.
_INT8_TC_CASES = [(8192, 768, 2304), (8192, 768, 768), (8192, 768, 3072), (8192, 3072, 768), (1000, 768, 2304),
                  (512, 768, 2304), (16, 768, 3072), (5, 3072, 768), (1, 32, 96), (300, 1536, 256)]


@pytest.mark.parametrize("M,K,N", _INT8_TC_CASES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_matmul_tc_kernel_matches_plain(dev, M, K, N, with_bias):
    """K3's tensor-core variant: the same fp32 sums in another order, rounded
    once to bf16, so within one bf16 ulp of the largest output."""
    rng = np.random.default_rng(M + K + N + with_bias)
    w_q, scale = quantize_weight(rng.normal(0, 0.02, (K, N)).astype(np.float32))
    w_q, scale = torch.from_numpy(w_q).to(dev), torch.from_numpy(scale).to(dev)
    bias = torch.from_numpy(rng.normal(0, 0.02, N).astype(np.float32)).to(dev) if with_bias else None
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev, torch.bfloat16)
    IM.launches = IM.launches_tc = 0
    got = IM.int8_matmul(x, w_q, scale, bias).float()
    assert (IM.launches, IM.launches_tc) == (1, 1)
    want = IM.int8_matmul_plain(x, w_q, scale, bias).float()
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    tol = 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= tol


def test_int8_matmul_tc_kernel_realigns_a_view(dev):
    """x rows starting 2 bytes off a 16-byte boundary (a view one element into
    its storage): the wrapper copies it, the tensor-core variant runs."""
    rng = np.random.default_rng(21)
    w_q, scale = quantize_weight(rng.normal(0, 0.02, (64, 128)).astype(np.float32))
    w_q, scale = torch.from_numpy(w_q).to(dev), torch.from_numpy(scale).to(dev)
    flat = torch.from_numpy(rng.normal(size=40 * 64 + 1).astype(np.float32)).to(dev, torch.bfloat16)
    x = flat[1:].view(40, 64)
    IM.launches_tc = 0
    got = IM.int8_matmul(x, w_q, scale)
    assert IM.launches_tc == 1
    want = IM.int8_matmul_plain(x, w_q, scale)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2.0 ** (
        math.floor(math.log2(want.float().abs().max().item())) - 7)


@pytest.mark.parametrize("dtype,K,N,tc", [
    (torch.bfloat16, 768, 2304, 1), (torch.bfloat16, 96, 40, 0), (torch.bfloat16, 100, 64, 0),
    (torch.float32, 768, 768, 0), (torch.float32, 1536, 256, 0)])
def test_int8_matmul_variant_launch_counters(dev, dtype, K, N, tc):
    """Every launch counts in launches, only the tensor-core ones in
    launches_tc; fp32 (the parity mode) keeps the CUDA-core kernel at 1e-4
    (outputs up to ~6 from sums over up to 1536 terms)."""
    rng = np.random.default_rng(K + N)
    w_q, scale = quantize_weight(rng.normal(0, 0.05, (K, N)).astype(np.float32))
    w_q, scale = torch.from_numpy(w_q).to(dev), torch.from_numpy(scale).to(dev)
    x = torch.from_numpy(rng.normal(size=(70, K)).astype(np.float32)).to(dev, dtype)
    IM.launches = IM.launches_tc = 0
    got = IM.int8_matmul(x, w_q, scale).float()
    assert (IM.launches, IM.launches_tc) == (1, tc)
    assert IM.kernel_variant(dtype, K, N) == (FA.TENSOR_CORE if tc else FA.CUDA_CORE)
    want = IM.int8_matmul_plain(x, w_q, scale).float()
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("S", [1, 56, 88, 130, 512, 600, 1024, 2048])
@pytest.mark.parametrize("layout", ["route", "dense"])
def test_bias_tc_kernel_matches_plain(dev, S, layout):
    """K7's tensor-core variant (32 rows a block up to S = 512, 16 above) in
    both bias layouts, with ragged, single and leading-masked keys
    (_attn_inputs); S = 1 and 130 take its element loads."""
    args = _bias_inputs(dev, S, torch.bfloat16, layout, S + 31)
    scale = math.sqrt(3 * 64)
    FA.launches_bias = FA.launches_bias_tc = 0
    got = FA.bias_fused_attention(*args, scale)
    assert (FA.launches_bias, FA.launches_bias_tc) == (1, 1)
    want = FA.bias_fused_attention_plain(*args, scale)
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert got.permute(0, 2, 1, 3).is_contiguous()


def test_bias_tc_kernel_other_strides(dev):
    """c2p contiguous in i and p2c in j (the route's layouts swapped), and
    q/k/v rows one element off alignment: every staging path of K7's
    tensor-core variant."""
    g = torch.Generator(device=dev).manual_seed(8)
    S = 96
    q, k, v = (torch.randn(4, 3, S, 65, generator=g, device=dev).to(torch.bfloat16)[..., 1:] for _ in range(3))
    c2p = (4 * torch.randn(3, S, 4, S, generator=g, device=dev)).to(torch.bfloat16).permute(2, 0, 3, 1)
    p2c = (4 * torch.randn(3, S, 4, S, generator=g, device=dev)).to(torch.bfloat16).permute(2, 0, 1, 3)
    mask = torch.ones(4, S, dtype=torch.int32, device=dev)
    mask[1, 40:] = 0
    FA.launches_bias_tc = 0
    got = FA.bias_fused_attention(q, k, v, c2p, p2c, mask, 8.0)
    assert FA.launches_bias_tc == 1
    want = FA.bias_fused_attention_plain(q, k, v, c2p, p2c, mask, 8.0)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("S", [100, 1024])
def test_bias_tc_kernel_row_without_valid_key_is_the_mean_of_v(dev, S):
    """bf16: all scores at -1e30, p = 1/S rounded to bf16 before p.v, as the
    plain version."""
    q, k, v, c2p, p2c, mask = _bias_inputs(dev, S, torch.bfloat16, "route", 1)
    mask[0] = 0
    got = FA.bias_fused_attention(q, k, v, c2p, p2c, mask, 8.0)
    want = FA.bias_fused_attention_plain(q, k, v, c2p, p2c, mask, 8.0)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert (got[0].float() - v[0].float().mean(dim=1, keepdim=True)).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype,bias_dtype,tc", [
    (torch.bfloat16, torch.bfloat16, 1), (torch.float32, torch.float32, 0),
    (torch.bfloat16, torch.float32, 0), (torch.float32, torch.bfloat16, 0)])
def test_bias_variant_launch_counters(dev, dtype, bias_dtype, tc):
    """Every K7 launch counts in launches_bias, only bf16 with bf16 biases in
    launches_bias_tc."""
    q, k, v, c2p, p2c, mask = _bias_inputs(dev, 64, dtype, "route", 2)
    c2p, p2c = c2p.to(bias_dtype), p2c.to(bias_dtype)
    FA.launches_bias = FA.launches_bias_tc = 0
    got = FA.bias_fused_attention(q, k, v, c2p, p2c, mask, 8.0)
    assert (FA.launches_bias, FA.launches_bias_tc) == (1, tc)
    want = FA.bias_fused_attention_plain(q, k, v, c2p, p2c, mask, 8.0)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= (2e-2 if dtype == torch.bfloat16 else 1e-4)


# ---------------------------------------------------------------------------
# The w8a8 linears' int8 product at any row count
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M", [1, 16, 17, 20, 342, 343, 344, 1001, 8192])
@pytest.mark.parametrize("K,N", [(32, 32), (768, 768), (36, 40)])
def test_int_mm_exact_on_card(dev, M, K, N):
    """int_mm pads what torch._int_mm refuses (M <= 16, K or N not a
    multiple of 8, and at small K row counts that are not a multiple of 32,
    M = 342 among them) and equals the exact product."""
    from gliclass.c_tpu_torch.ops.layers import int_mm

    gen = torch.Generator(device=dev).manual_seed(M + K)
    a = torch.randint(-127, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
    got = int_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.cpu().long(), a.cpu().long() @ b.cpu().long())


@pytest.mark.parametrize("M", [1, 17, 342, 343, 1000])
@pytest.mark.parametrize("K,N", [(32, 32), (768, 768)])
def test_linear_w8a8_matches_cpu_at_any_row_count(dev, M, K, N):
    """The w8a8 linear on the card: against the exact int64 product of its
    own int8 activations, scaled as it scales (to fp32 rounding), and
    against the same linear on the CPU. The two devices' row scales may
    differ in the last bit (measured: 4.3% of the outputs differ at M = 342,
    K = 768), which moves an element near a rounding boundary by one int8
    step: a relative L2 error far below 1e-2."""
    from gliclass.c_tpu_torch.ops.layers import _linear_w8a8, row_quant

    rng = np.random.default_rng(M + N)
    w_q, scale = quantize_weight(rng.normal(0, 0.05, (K, N)).astype(np.float32))
    p = {"w_q": torch.from_numpy(w_q), "scale": torch.from_numpy(scale)}
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(torch.bfloat16)
    got = _linear_w8a8({n: t.to(dev) for n, t in p.items()}, x.to(dev))
    x_q, s_x = row_quant(x.to(dev).float())
    torch.cuda.synchronize()
    assert got.shape == (M, N)
    exact = (x_q.cpu().long() @ p["w_q"].long()).float() * s_x.cpu() * p["scale"]
    torch.testing.assert_close(got.cpu(), exact, rtol=1e-6, atol=1e-6)
    want = _linear_w8a8(p, x)
    assert ((got.cpu() - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.parametrize("compute_dtype,quant_mode", [("float32", "int8"), ("bfloat16", "int8"),
                                                      ("bfloat16", "int8-dynamic")])
def test_classify_job_head_width_8_on_card(dev, compute_dtype, quant_mode):
    """A DeBERTa of head width 8 (hidden 32, 4 heads) through classify_job on
    the card: every route takes the score path there (the kernels take width
    64 only), the linears run K3 or the w8a8 path and the FFN K2 or K4, and
    the result agrees with the same pipeline on the CPU, which runs the
    kernels' plain versions on the flash route."""
    import chip_smoke
    from gliclass.c_tpu_torch.data import parse_job
    from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline
    from gliclass.c_tpu_torch.prompting import pack_prompts
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    bb = BackboneConfig(model_type="deberta-v2", vocab_size=600, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64, max_position_embeddings=64,
                        position_buckets=16, norm_rel_ebd="layer_norm", share_att_key=True,
                        position_biased_input=False)
    tok = PromptTokenizer(chip_smoke.WordTokenizer(bb.vocab_size))
    cfg = GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                         text_token_index=tok.sep_token_id, prompt_first=True, backbone=bb)
    rng = np.random.default_rng(4)
    params = quantize_tree(chip_smoke.make_params(rng, bb, 32))
    labels = [["politics", "sports", "science", "health"]]
    job_dict = chip_smoke.make_job(rng, 6, 0) | {"labels": labels}
    job = parse_job(job_dict)
    # Padded to the 64 bucket as the engine pads: 6 x 64 rows (torch._int_mm
    # on the card refuses a row count such as 6 x 57).
    batch = tok.encode_batch(pack_prompts(job_dict["texts"], labels, True, cfg.prompt_first), max_length=64,
                             pad_to=64)
    valid = torch.from_numpy(batch.attention_mask).bool()
    rt = RuntimeConfig(batch_size=4, max_length=64, compute_dtype=compute_dtype, quant_mode=quant_mode,
                       seq_buckets=(32, 64), label_buckets=(4,))
    for route in ("auto", "flash", "bias", "row", "tiled"):
        assert FA.attention_route(64, 4, 8, route, dev) == "score"
        FA.launches = FA.launches_bias = FA.launches_row = FA.launches_tiled = 0
        IM.launches = FF.launches = FF.launches_wonly = 0
        card = ZeroShotClassificationPipeline(InferenceEngine(cfg, params, dataclasses.replace(rt, attn_route=route)),
                                              tok, rt).classify_job(job)
        torch.cuda.synchronize()
        assert (FA.launches, FA.launches_bias, FA.launches_row, FA.launches_tiled) == (0, 0, 0, 0)
        if quant_mode == "int8":
            assert IM.launches > 0
        if compute_dtype == "bfloat16":
            assert (FF.launches if quant_mode == "int8-dynamic" else FF.launches_wonly) > 0
        # The CPU on the score path (the card's) and on the route itself (the
        # kernels' plain versions: the same function, fp32 only, since bf16
        # rounds the two paths' scores at other places). The random head
        # leaves the probabilities near 0.5, so the backbone's hidden states
        # (relative L2 over valid tokens) are held too.
        h_card = chip_smoke.hidden_states(InferenceEngine(cfg, params, dataclasses.replace(rt, attn_route=route)),
                                          batch)
        for cpu_route in ("xla", route) if compute_dtype == "float32" else ("xla",):
            cpu_rt = dataclasses.replace(rt, attn_route=cpu_route)
            cpu = ZeroShotClassificationPipeline(InferenceEngine(cfg, params, cpu_rt, device="cpu"), tok,
                                                 rt).classify_job(job)
            assert card.failures == [] and cpu.failures == []
            assert card.probs.shape == (6, 4) and np.isfinite(card.probs).all()
            np.testing.assert_allclose(card.probs, cpu.probs, atol=1e-5 if compute_dtype == "float32" else 5e-2)
            h_cpu = chip_smoke.hidden_states(InferenceEngine(cfg, params, cpu_rt, device="cpu"), batch)
            rel = ((h_card[valid] - h_cpu[valid]).norm() / h_cpu[valid].norm()).item()
            assert rel <= (1e-5 if compute_dtype == "float32" else 5e-2), (route, cpu_route, rel)


# ---------------------------------------------------------------------------
# The tensor-core variants of K1 and K2 (csrc/flash_disentangled_attention_tc.cu,
# csrc/fused_ffn_w8a8_tc.cu)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S", [56, 88, 512])
def test_flash_tc_kernel_head_split_views(dev, S):
    """q/k/v as head views of one fused [B, S, 3H] projection (the model's
    layout, 16-byte aligned rows: cp.async copies) against contiguous copies."""
    g = torch.Generator(device=dev).manual_seed(S)
    B, h = 3, 12
    qkv = torch.randn(B, S, 3 * h * 64, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[..., i * h * 64:(i + 1) * h * 64].reshape(B, S, h, 64).transpose(1, 2) for i in range(3))
    pk, pq = (torch.randn(h, 2 * S - 1, 64, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    mask = torch.ones(B, S, dtype=torch.int32, device=dev)
    mask[1, S // 3:] = 0
    got = FA.flash_disentangled_attention(q, k, v, pk, pq, mask, 8.0)
    want = FA.flash_disentangled_attention_plain(q, k, v, pk, pq, mask, 8.0)
    same = FA.flash_disentangled_attention(*(x.contiguous() for x in (q, k, v)), pk, pq, mask, 8.0)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert torch.equal(got, same)


def test_flash_tc_kernel_rows_not_16_byte_aligned(dev):
    """bf16 q/k/v rows 65 elements apart and one element off alignment, and
    relative tables one element off: the tensor-core K1's element loads."""
    g = torch.Generator(device=dev).manual_seed(7)
    S = 96
    q, k, v = (torch.randn(4, 3, S, 65, generator=g, device=dev).to(torch.bfloat16)[..., 1:] for _ in range(3))
    flat = torch.randn(2 * 3 * (2 * S - 1) * 64 + 1, generator=g, device=dev).to(torch.bfloat16)
    pk, pq = flat[1:].view(2, 3, 2 * S - 1, 64)
    mask = torch.ones(4, S, dtype=torch.int32, device=dev)
    mask[1, 40:] = 0
    FA.launches_flash_tc = 0
    got = FA.flash_disentangled_attention(q, k, v, pk, pq, mask, 8.0)
    assert FA.launches_flash_tc == 1
    want = FA.flash_disentangled_attention_plain(q, k, v, pk, pq, mask, 8.0)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("S", [40, 100, 300])
def test_flash_tc_kernel_row_without_valid_key_is_the_mean_of_v(dev, S):
    """Masked keys weigh 2^0 = 1 each at the running max -1e30 and keys past S
    exactly 0, so a row with no valid key gives the mean of v over its S keys,
    as the plain version does."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, S, torch.bfloat16, S)
    mask[0] = 0
    got = FA.flash_disentangled_attention(q, k, v, pk, pq, mask, 8.0)
    want = FA.flash_disentangled_attention_plain(q, k, v, pk, pq, mask, 8.0)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert (got[0].float() - v[0].float().mean(dim=1, keepdim=True)).abs().max().item() <= 1e-2


@pytest.mark.parametrize("S", [40, 100, 300])
def test_flash_kernel_row_without_valid_key_is_the_mean_of_v(dev, S):
    """The CUDA-core K1 (fp32) weighs keys past S exactly 0 as the
    tensor-core one does: a row with no valid key gives the mean of v over
    its S keys, as the plain version does."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, S, torch.float32, S)
    mask[0] = 0
    FA.launches = FA.launches_flash_tc = 0
    got = FA.flash_disentangled_attention(q, k, v, pk, pq, mask, 8.0)
    assert (FA.launches, FA.launches_flash_tc) == (1, 0)
    want = FA.flash_disentangled_attention_plain(q, k, v, pk, pq, mask, 8.0)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4
    assert (got[0] - v[0].mean(dim=1, keepdim=True)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype,tc", [(torch.bfloat16, 1), (torch.float32, 0)])
def test_flash_variant_launch_counters(dev, dtype, tc):
    """Every K1 launch counts in launches, only bf16 ones in launches_flash_tc."""
    args = _attn_inputs(dev, 4, 3, 72, dtype, 9)
    FA.launches = FA.launches_flash_tc = 0
    got = FA.flash_disentangled_attention(*args, 8.0)
    assert (FA.launches, FA.launches_flash_tc) == (1, tc)
    assert FA.kernel_variant(dtype) == (FA.TENSOR_CORE if tc else FA.CUDA_CORE)
    want = FA.flash_disentangled_attention_plain(*args, 8.0)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= (2e-2 if tc else 1e-4)


@pytest.mark.parametrize("H,I,tc", [(768, 3072, 1), (128, 256, 1), (100, 196, 0), (96, 200, 0)])
def test_ffn_variant_launch_counters(dev, H, I, tc):
    """Every K2 call counts once in launches (the tensor-core variant's four
    launches too), only those with H and I multiples of 16 in launches_tc."""
    args = _ffn_args(dev, 70, H, I, H + I + 1)
    FF.launches = FF.launches_tc = 0
    got = FF.fused_ffn_w8a8(*args, **(_nk(args) if tc else {}))
    assert (FF.launches, FF.launches_tc) == (1, tc)
    assert FF.kernel_variant(H, I) == (FA.TENSOR_CORE if tc else FA.CUDA_CORE)
    want = FF.fused_ffn_w8a8_plain(*args).float()
    torch.cuda.synchronize()
    assert (got.float() - want).abs().max().item() <= 4 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)


def test_ffn_tc_kernel_takes_engine_weights_and_realigns_a_view(dev):
    """The engine's [N, K] weights (slices of stacked [L, N, K] copies) give
    the same bits as copies made in the call; x rows starting 2 bytes off a
    16-byte boundary are copied."""
    x, wu, su, bu, wd, sd, bd, act = _ffn_args(dev, 40, 128, 256, 6)
    flat = torch.cat([x.new_zeros(1), x.reshape(-1)])
    xv = flat[1:].view(40, 128)
    wts = FF.nk_weight(torch.stack([wu.flip(0), wu])), FF.nk_weight(torch.stack([wd.flip(0), wd]))
    got = FF.fused_ffn_w8a8(xv, wu, su, bu, wd, sd, bd, act, wt_up=wts[0][1], wt_dn=wts[1][1])
    want = FF.fused_ffn_w8a8(x, wu, su, bu, wd, sd, bd, act, wt_up=FF.nk_weight(wu), wt_dn=FF.nk_weight(wd))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="wt_up"):
        FF.fused_ffn_w8a8(x, wu, su, bu, wd, sd, bd, act, wt_up=wu, wt_dn=FF.nk_weight(wd))


def test_ffn_tc_kernel_requires_nk_weights(dev):
    """The tensor-core K2 reads only the [N, K] copies: without them it
    raises, and launches nothing."""
    args = _ffn_args(dev, 40, 128, 256, 8)
    FF.launches = FF.launches_tc = 0
    with pytest.raises(ValueError, match="wt_up"):
        FF.fused_ffn_w8a8(*args)
    with pytest.raises(ValueError, match="wt_dn"):
        FF.fused_ffn_w8a8(*args, wt_up=FF.nk_weight(args[1]))
    assert (FF.launches, FF.launches_tc) == (0, 0)


def test_engine_int8_dynamic_adds_nk_weights_on_card(dev):
    """An int8-dynamic engine on the card holds the [N, K] FFN weights K2's
    tensor-core variant reads; an int8 one does not."""
    rng = np.random.default_rng(1)
    L, H, I = 2, 128, 256
    params = quantize_tree({"backbone": {"layers": {"ffn": {
        "up": {"w": rng.normal(0, 0.05, (L, H, I)).astype(np.float32)},
        "down": {"w": rng.normal(0, 0.05, (L, I, H)).astype(np.float32)}}}}})
    bb = BackboneConfig(hidden_size=H, num_hidden_layers=L, num_attention_heads=2, intermediate_size=I)
    cfg = GLiClassConfig(hidden_size=H, class_token_index=7, backbone=bb)
    for mode, added in (("int8-dynamic", True), ("int8", False)):
        eng = InferenceEngine(cfg, params, RuntimeConfig(compute_dtype="bfloat16", quant_mode=mode))
        ffn = eng.params["backbone"]["layers"]["ffn"]
        assert ("w_t" in ffn["up"]) == added and ("w_t" in ffn["down"]) == added
        if added:
            assert torch.equal(ffn["up"]["w_t"], ffn["up"]["w_q"].transpose(1, 2))
            assert ffn["down"]["w_t"].shape == (L, H, I) and ffn["down"]["w_t"].is_contiguous()


# ---------------------------------------------------------------------------
# Head and encoder features (models/heads.py, the conv stem) and training
# ---------------------------------------------------------------------------
COMBINED_HEAD = {"scorer_type": "weighted-dot", "use_lstm": True, "squeeze_layers": True}
FEATURE_LABELS = [["politics", "sports", "science", "health"]]


def _feature_model(conv: int = 0, **head):
    """A 2-layer DeBERTa of head width 64 (so the kernels run: hidden 128, 2
    heads) with ``head``'s features, random weights from chip_smoke."""
    import chip_smoke
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    bb = BackboneConfig(model_type="deberta-v2", vocab_size=1000, hidden_size=128, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=256, max_position_embeddings=512,
                        position_buckets=64, norm_rel_ebd="layer_norm", share_att_key=True,
                        position_biased_input=False, conv_kernel_size=conv, conv_act="gelu")
    tok = PromptTokenizer(chip_smoke.WordTokenizer(bb.vocab_size))
    cfg = GLiClassConfig(hidden_size=128, class_token_index=tok.label_token_id, text_token_index=tok.sep_token_id,
                         prompt_first=True, backbone=bb, **head)
    rng = np.random.default_rng(5)
    params = chip_smoke.with_head_features(chip_smoke.make_params(rng, bb, 128), cfg, rng)
    texts = chip_smoke.make_job(rng, 6, 0)["texts"]
    return cfg, tok, params, texts


def _reset_counters():
    FA.launches = FA.launches_flash_tc = IM.launches = FF.launches = FF.launches_wonly = CA.launches = 0


@pytest.mark.parametrize("head", [COMBINED_HEAD, {"scorer_type": "mlp"}], ids=["combined", "mlp"])
@pytest.mark.parametrize("n", [1, 6])
@pytest.mark.parametrize("compute_dtype,quant_mode", [("float32", "int8"), ("bfloat16", "int8-dynamic")])
def test_head_features_on_card(dev, head, n, compute_dtype, quant_mode):
    """The combined head (weighted-dot scorer, BiLSTM, layer fuser) and the
    mlp scorer, card against CPU: fp32 (weight-only INT8) to 1e-4 relative
    L2 on probabilities, bf16 "int8-dynamic" to 5e-2. At B = 1 the scorer's
    w8a8 products have 1 and 4 rows (int_mm_padded)."""
    from gliclass.c_tpu_torch.prompting import pack_prompts

    cfg, tok, params, texts = _feature_model(**head)
    q = quantize_tree(params)
    batch = tok.encode_batch(pack_prompts(texts[:n], FEATURE_LABELS, True, True), max_length=128, pad_to=128)
    rt = RuntimeConfig(batch_size=8, max_length=128, compute_dtype=compute_dtype, quant_mode=quant_mode,
                       seq_buckets=(128,), label_buckets=(4,))
    _reset_counters()
    card = InferenceEngine(cfg, q, rt).run(batch, 4)
    torch.cuda.synchronize()
    assert FA.launches == 2 and (FF.launches if quant_mode == "int8-dynamic" else IM.launches) > 0
    cpu = InferenceEngine(cfg, q, rt, device="cpu").run(batch, 4)
    assert card.shape == (n, 4) and np.isfinite(card).all()
    if compute_dtype == "float32":
        assert np.linalg.norm(card - cpu) / np.linalg.norm(cpu) <= 1e-4
    else:
        assert np.abs(card - cpu).max() <= 5e-2


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_conv_stem_on_card(dev, compute_dtype, tol):
    """The conv stem (k = 3, gelu) at head width 64: the backbone's hidden
    states and every stacked state (return_all_layers), card against CPU
    (relative L2 over valid tokens), with K1 launched once a layer."""
    import chip_smoke
    from gliclass.c_tpu_torch.models.deberta import deberta_encode
    from gliclass.c_tpu_torch.prompting import pack_prompts

    cfg, tok, params, texts = _feature_model(conv=3)
    q = quantize_tree(params)
    batch = tok.encode_batch(pack_prompts(texts, FEATURE_LABELS, True, True), max_length=128, pad_to=128)
    valid = torch.from_numpy(batch.attention_mask).bool()
    rt = RuntimeConfig(max_length=128, compute_dtype=compute_dtype, quant_mode="int8-dynamic")
    card_engine, cpu_engine = InferenceEngine(cfg, q, rt), InferenceEngine(cfg, q, rt, device="cpu")
    _reset_counters()
    h_card = chip_smoke.hidden_states(card_engine, batch)
    assert FA.launches == 2
    h_cpu = chip_smoke.hidden_states(cpu_engine, batch)
    assert ((h_card[valid] - h_cpu[valid]).norm() / h_cpu[valid].norm()).item() <= tol
    states = []
    for engine in (card_engine, cpu_engine):
        ids, mask = engine._device_inputs(batch.input_ids, batch.attention_mask)
        with torch.inference_mode():
            states.append(deberta_encode(engine.params["backbone"], ids, mask, cfg.backbone, engine.compute_dtype,
                                         return_all_layers=True).float().cpu())
    assert states[0].shape == (3, len(texts), 128, 128)
    for a, b in zip(*states):
        assert ((a[valid] - b[valid]).norm() / b[valid].norm()).item() <= tol


def test_train_step_on_card_matches_cpu(dev):
    """One fp32 AdamW step of the combined head, card against CPU: loss to
    1e-4, grad norm to 1e-3 relative; no kernel launched."""
    import functools

    from gliclass.c_tpu_torch.prompting import pack_prompts
    from gliclass.c_tpu_torch.training.train import init_train_state, make_train_step

    cfg, tok, params, texts = _feature_model(**COMBINED_HEAD)
    batch = tok.encode_batch(pack_prompts(texts, FEATURE_LABELS, True, True), max_length=64, pad_to=64)
    targets = (np.arange(24).reshape(6, 4) % 3 == 0).astype(np.float32)
    args = (batch.input_ids, batch.attention_mask, targets, np.ones((6, 4), dtype=bool))
    adamw = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=0.01)
    step = make_train_step(cfg, 4)
    _reset_counters()
    got = step(init_train_state(params, adamw, device=dev), *args)[1]
    assert (FA.launches, IM.launches, FF.launches, FF.launches_wonly, CA.launches) == (0, 0, 0, 0, 0)
    want = step(init_train_state(params, adamw, device="cpu"), *args)[1]
    assert abs(got["loss"].item() - want["loss"].item()) <= 1e-4 * abs(want["loss"].item())
    assert abs(got["grad_norm"].item() - want["grad_norm"].item()) <= 1e-3 * abs(want["grad_norm"].item())


GRAD_CALLS = {
    "flash_disentangled_attention": lambda x: FA.flash_disentangled_attention(x, x, x, x, x, None, 8.0),
    "abs_pos_table": lambda x: FA.abs_pos_table(x, 8),
    "bias_fused_attention": lambda x: FA.bias_fused_attention(x, x, x, x, x, None, 8.0),
    "row_disentangled_attention": lambda x: FA.row_disentangled_attention(x, x, x, x, x, None, 8.0),
    "windowed_pos_tables": lambda x: FA.windowed_pos_tables(x, 32),
    "tiled_attention": lambda x: FA.tiled_attention(x, x, x, x, x, None, 8.0),
    "fused_ffn_w8a8": lambda x: FF.fused_ffn_w8a8(x, None, x, x, None, x, x),
    "fused_ffn_wonly": lambda x: FF.fused_ffn_wonly(x, None, x, x, None, x, x),
    "int8_matmul": lambda x: IM.int8_matmul(x, None, x, x),
    "causal_flash_attention": lambda x: CA.causal_flash_attention(x, x, x, None, 8.0),
}


@pytest.mark.parametrize("name", list(GRAD_CALLS))
def test_kernel_wrapper_refuses_grad_on_card(dev, name):
    """A kernel launched through ctypes returns a tensor with no grad_fn:
    every wrapper refuses an input that requires grad (with grad enabled)
    before it launches or counts anything."""
    import chip_smoke

    chip_smoke.reset_counts()
    x = torch.zeros(4, 64, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        GRAD_CALLS[name](x)
    assert not any(chip_smoke.read_counts().values())


CONV_STEM_CODE = r"""
import json, sys
import torch
from gliclass.c_tpu_torch.config import BackboneConfig
from gliclass.c_tpu_torch.models import deberta

cfg = BackboneConfig(model_type="deberta-v2", vocab_size=128100, hidden_size=1536, num_hidden_layers=4,
                     num_attention_heads=24, intermediate_size=6144, conv_kernel_size=3, conv_act="gelu")
g = torch.Generator().manual_seed(0)
H = cfg.hidden_size
p = {"w": torch.randn(3, H, H, generator=g) * 0.02, "b": torch.randn(H, generator=g) * 0.01,
     "ln": {"scale": 1 + 0.05 * torch.randn(H, generator=g), "bias": 0.05 * torch.randn(H, generator=g)}}
embed = torch.randn(4, 96, H, generator=g)
layer0 = 0.1 * torch.randn(4, 96, H, generator=g)
mask = torch.ones(4, 96, dtype=torch.int32)
mask[1, 50:] = 0
mask[3, 1:] = 0
cpu = deberta.conv_layer(p, embed, layer0, mask, cfg, torch.float32)
on = lambda t: {k: on(v) for k, v in t.items()} if isinstance(t, dict) else t.cuda()
card = deberta.conv_layer(on(p), embed.cuda(), layer0.cuda(), mask.cuda(), cfg, torch.float32).cpu()
print(json.dumps({"allow_tf32": torch.backends.cudnn.allow_tf32,
                  "engine": "gliclass.c_tpu_torch.engine" in sys.modules,
                  "rel": ((card - cpu).norm() / cpu.norm()).item()}))
"""


def test_conv_stem_fp32_on_card_without_the_engine(dev):
    """The conv stem at deberta-v2-xlarge's width (H = 1536, k = 3) in fp32,
    in a process that imported only ``models.deberta`` (so cuDNN's
    ``allow_tf32`` keeps torch's default, True): the card against the CPU
    at 1e-4 relative L2."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", CONV_STEM_CODE], cwd=root, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["allow_tf32"] is True and got["engine"] is False
    assert got["rel"] <= 1e-4, got


def test_device_peaks_by_the_cards_name(dev):
    """The peaks table has this card (looked up by its name), the kernels'
    bound is computed from it, and a name not in the table raises."""
    from gliclass.c_tpu_torch.utils import perf

    name = torch.cuda.get_device_name(0)
    assert perf.device_peaks() is perf.DEVICE_PEAKS[name]
    peaks = perf.DEVICE_PEAKS[name]
    assert perf.kernel_bound_ms(2e12, "bf16", 1e9) == (2e12 / peaks["bf16"] * 1e3, "operations")
    assert perf.kernel_bound_ms(1e9, "int8", 3.35e10) == (3.35e10 / peaks["hbm_bytes_per_s"] * 1e3, "bytes")
    with pytest.raises(ValueError, match="no published peaks"):
        perf.device_peaks(name + " (another part)")


@pytest.mark.parametrize("quant_mode,kernels", [
    ("int8-dynamic", ("flash_disentangled_attention_tc", "fused_ffn_w8a8_tc")),
    ("int8", ("flash_disentangled_attention_tc", "int8_matmul_tc", "fused_ffn_wonly_tc")),
])
def test_per_kernel_report_on_card(dev, quant_mode, kernels):
    """per_kernel_report at gliclass-base's widths on the card: finite rows
    timed by CUDA events, each within its speed of light, through the
    tensor-core kernels of the mode."""
    import chip_smoke
    from gliclass.c_tpu_torch.config import deberta_v3_config
    from gliclass.c_tpu_torch.utils import perf

    bb = deberta_v3_config("base")
    cfg = GLiClassConfig(hidden_size=bb.hidden_size, backbone=bb)
    chip_smoke.reset_counts()
    rows = perf.per_kernel_report(cfg, 8, 64, quant_mode, device=dev, iters=4)
    counts = chip_smoke.read_counts()
    assert [r["component"] for r in rows] == ["qkv_o_proj", "ffn", "attn_total"]
    for r in rows:
        assert r["clock"] == "cuda events" and math.isfinite(r["ms"]) and r["ms"] > 0
        assert 0 < r["sol_frac"] <= 1, r
    assert rows[2]["route"] == "flash"
    for k in kernels:
        assert counts[k] > 0, counts


# ---------------------------------------------------------------------------
# Tensor parallelism: K2' split at s_h, K1' and K5' at a rank's local heads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M,H,I", [(70, 128, 256), (512, 768, 1536), (8192, 768, 1536)])
def test_ffn_tc_split_halves_equal_fused_at_tp1(dev, M, H, I):
    """One rank's two halves (gct_fused_ffn_w8a8_tc_up, then _down on its
    absmax) give the fused entry's bits, in bf16 and, rounded, in fp32; and
    the fused entry's h_q."""
    args = _ffn_args(dev, M, H, I, M + H)
    x, wu, su, bu, wd, sd, bd, _ = args
    nk = _nk(args)
    out = torch.empty_like(x)
    entry_args, (i8, _f32) = FF.w8a8_tc_args(x, nk["wt_up"], su, bu, nk["wt_dn"], sd, bd, out)
    from gliclass.c_tpu_torch.ops import _build

    _build.check(_build.lib().gct_fused_ffn_w8a8_tc(*entry_args), "gct_fused_ffn_w8a8_tc")
    h, sh, _ = FF.w8a8_tc_up(x, nk["wt_up"], su, bu)
    got, hq = FF.w8a8_tc_down(h, sh, nk["wt_dn"], sd, bd, torch.bfloat16)
    h, sh, _ = FF.w8a8_tc_up(x, nk["wt_up"], su, bu)
    got32, _ = FF.w8a8_tc_down(h, sh, nk["wt_dn"], sd, bd, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(got, out) and torch.equal(got32.to(torch.bfloat16), out)
    assert torch.equal(hq.reshape(-1), i8[M * H:])


def test_ffn_tc_split_with_a_shared_s_h_matches_the_plain_split(dev):
    """Two ranks' halves on their columns of I = 3072 (1536 each), the row
    absmax their maximum (as the all-reduce gives it): h_q, concatenated,
    is the one-rank K2's; the fp32 partial sums plus the bias agree with the
    plain split within K2's bf16 tolerance."""
    M, H, I = 1024, 768, 3072
    args = _ffn_args(dev, M, H, I, 12)
    x, wu, su, bu, wd, sd, bd, _ = args
    nk = _nk(args)
    h1, sh1, _ = FF.w8a8_tc_up(x, nk["wt_up"], su, bu)
    _, hq1 = FF.w8a8_tc_down(h1, sh1, nk["wt_dn"], sd, bd, torch.bfloat16)
    cols = [slice(0, I // 2), slice(I // 2, I)]
    ups = [FF.w8a8_tc_up(x, FF.nk_weight(wu[:, c]), su[c].contiguous(), bu[c].contiguous()) for c in cols]
    sh = torch.maximum(ups[0][1], ups[1][1])
    downs = [FF.w8a8_tc_down(h, sh.clone(), FF.nk_weight(wd[c]), sd) for (h, _, _), c in zip(ups, cols)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([hq for _, hq in downs], dim=-1), hq1)
    y = (downs[0][0] + downs[1][0] + bd).to(torch.bfloat16).float()
    hs = [FF.ffn_w8a8_up_plain(x, wu[:, c], su[c], bu[c]) for c in cols]
    amax = torch.maximum(hs[0][1], hs[1][1])
    want = (sum(FF.ffn_w8a8_down_plain(h, amax, wd[c], sd) for (h, _), c in zip(hs, cols)) + bd)
    want = want.to(torch.bfloat16).float()
    assert (y - want).abs().max().item() <= 4 * 2.0 ** (math.floor(math.log2(want.abs().max().item())) - 7)


def test_ffn_split_refuses_the_cuda_core_widths(dev, monkeypatch):
    """Under a model group of two the CUDA-core K2 (H or I not a multiple of
    16) cannot split at s_h: the wrapper raises and launches nothing."""
    args = _ffn_args(dev, 40, 100, 196, 3)
    monkeypatch.setattr(FF, "group_size", lambda group: 2)
    FF.launches = FF.launches_split = 0
    with pytest.raises(ValueError, match="only\\s+its tensor-core variant"):
        FF.fused_ffn_w8a8(*args, group=object())
    assert (FF.launches, FF.launches_split) == (0, 0)


@pytest.mark.parametrize("S", [56, 128, 512])
def test_flash_tc_kernel_at_a_ranks_six_heads(dev, S):
    """K1' at gliclass-base's local heads under tp = 2 (6 of 12)."""
    args = _attn_inputs(dev, 4, 6, S, torch.bfloat16, S + 6)
    FA.launches = FA.launches_flash_tc = 0
    got = FA.flash_disentangled_attention(*args, math.sqrt(3 * 64))
    assert (FA.launches, FA.launches_flash_tc) == (1, 1)
    want = FA.flash_disentangled_attention_plain(*args, math.sqrt(3 * 64))
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("S", [56, 300])
def test_causal_tc_kernel_at_a_ranks_heads(dev, S):
    """K5' at qwen-1.5B's local heads under tp = 2: 6 query heads on 1 kv head, d = 128."""
    qg, k, v, mask = _causal_inputs(dev, 3, 1, 6, S, 128, torch.bfloat16, S)
    CA.launches_tc = 0
    got = CA.causal_flash_attention(qg, k, v, mask, 1.0 / math.sqrt(128))
    assert CA.launches_tc == 1
    want = CA.causal_flash_attention_plain(qg, k, v, mask, 1.0 / math.sqrt(128))
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


# ---------------------------------------------------------------------------
# K1 and K5 at a query-row offset (sequence parallelism)
# ---------------------------------------------------------------------------
# (S, [(q_off, Sq), ...]): the blocks of sp = 2 and 4, blocks off the 64-row
# tiles, one row at the end.
_OFFSET_BLOCKS = [
    (56, [(0, 28), (28, 28)]),
    (128, [(0, 64), (64, 64), (32, 32), (96, 32)]),
    (512, [(0, 256), (256, 256), (384, 128)]),
    (200, [(50, 50), (150, 50), (199, 1)]),
]


@pytest.mark.parametrize("S,blocks", _OFFSET_BLOCKS, ids=lambda x: str(x))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_attention_kernel_query_row_offset(dev, S, blocks, dtype, tol):
    """K1 (fp32) and K1' (bf16) on a block of query rows at q_off: the
    block's rows of the launch over all S bit for bit, and the plain
    version at q_off within the kernel's tolerance."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, S, dtype, S + 1)
    scale = math.sqrt(3 * 64)
    full = FA.flash_disentangled_attention(q, k, v, pk, pq, mask, scale)
    for off, n in blocks:
        FA.launches = FA.launches_flash_tc = 0
        got = FA.flash_disentangled_attention(q[:, :, off:off + n], k, v, pk, pq, mask, scale, q_off=off)
        assert (FA.launches, FA.launches_flash_tc) == (1, int(dtype == torch.bfloat16))
        want = FA.flash_disentangled_attention_plain(q[:, :, off:off + n], k, v, pk, pq, mask, scale, off)
        torch.cuda.synchronize()
        assert got.shape == (4, 3, n, 64) and got.permute(0, 2, 1, 3).is_contiguous()
        assert torch.equal(got, full[:, :, off:off + n])
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("S,blocks", _OFFSET_BLOCKS, ids=lambda x: str(x))
@pytest.mark.parametrize("nkv,g,d,dtype,tol", [(2, 6, 128, torch.bfloat16, 2e-2), (1, 4, 64, torch.bfloat16, 2e-2),
                                               (2, 6, 128, torch.float32, 1e-4), (2, 2, 8, torch.float32, 1e-4)])
def test_causal_kernel_query_row_offset(dev, S, blocks, nkv, g, d, dtype, tol):
    """K5' (bf16, d % 16 == 0) and K5 on a block of query rows at q_off (cut
    at j <= i + q_off): the block's rows of the launch over all S bit for
    bit, and the plain version at q_off within the kernel's tolerance."""
    qg, k, v, mask = _causal_inputs(dev, 3, nkv, g, S, d, dtype, S + d)
    scale = 1.0 / math.sqrt(d)
    full = CA.causal_flash_attention(qg, k, v, mask, scale)
    for off, n in blocks:
        CA.launches = CA.launches_tc = 0
        got = CA.causal_flash_attention(qg[:, :, :, off:off + n], k, v, mask, scale, q_off=off)
        assert (CA.launches, CA.launches_tc) == (1, int(CA.kernel_variant(dtype, d) == CA.TENSOR_CORE))
        want = CA.causal_flash_attention_plain(qg[:, :, :, off:off + n], k, v, mask, scale, off)
        torch.cuda.synchronize()
        assert got.shape == (3, nkv, g, n, d) and got.permute(0, 3, 1, 2, 4).is_contiguous()
        assert torch.equal(got, full[:, :, :, off:off + n])
        assert (got.float() - want.float()).abs().max().item() <= tol


def test_offset_kernels_check_the_rows(dev):
    """A block of rows that runs past the keys is refused before a launch."""
    q, k, v, pk, pq, mask = _attn_inputs(dev, 4, 3, 64, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="outside the 64 keys"):
        FA.flash_disentangled_attention(q[:, :, :40], k, v, pk, pq, mask, 8.0, q_off=32)
    qg, k, v, mask = _causal_inputs(dev, 3, 2, 2, 64, 64, torch.bfloat16, 0)
    with pytest.raises(ValueError, match="outside the 64 keys"):
        CA.causal_flash_attention(qg[:, :, :, :40], k, v, mask, 0.125, q_off=32)
