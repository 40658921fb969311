"""Causal grouped-query attention of the decoder backbones, kernel K5.

    s[i, j] = scale * q_i . k_j          (fp32)
    out_i   = softmax_j(s[i, :] over keys j <= i + q_off with mask[j] = 1) . v

Queries arrive grouped as in the JAX package: ``qg [B, nkv, g, S, d]``, so
query head ``h = kv * g + gi`` reads kv head ``h // g``; ``k, v [B, nkv, S,
d]``; ``attention_mask [B, S]`` (1 = valid key); ``scale`` multiplies the
scores (1/sqrt(d)). Under sequence parallelism ``qg`` holds a rank's block
of Sq query rows, the absolute rows ``q_off .. q_off + Sq - 1`` of the S
keys: ``qg [B, nkv, g, Sq, d]``. Each row reads only its own scores, so the
rows of a launch at ``q_off`` equal those rows of the launch over all S bit
for bit.

On a CUDA tensor :func:`causal_flash_attention` launches one of two
blocked online-softmax kernels (:func:`kernel_variant`): bf16 with d a
multiple of 16 on tensor cores (``csrc/causal_flash_attention_tc.cu``),
every other case on CUDA cores (``csrc/causal_flash_attention.cu``). On a
CPU tensor it runs :func:`causal_flash_attention_plain`, the same function
computed densely in PyTorch: fp32 scores and statistics, probabilities
rounded to v's dtype before P.v, masked keys at -1e30 and contributing
exactly 0, so a row with no valid key (``l == 0``) gives 0 in both. Right
padding keeps key 0 valid in every row the engine builds, so that case does
not arise there; the JAX kernel would average over the masked keys of the
tiles it visited.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_attention import CUDA_CORE, TENSOR_CORE
from .layers import wide

# Kernel launches since the last reset (the main path's proof): every launch
# of K5, the tensor-core ones among them, and those at a query-row offset
# q_off > 0 (a sequence-parallel rank's rows).
launches = 0
launches_tc = 0
launches_offset = 0

MAX_HEAD_DIM = 128  # the kernels pad d to 64 or 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """The variant of K5 that takes q/k/v of this dtype and head width d:
    the bf16 tensor-core kernel when they are bfloat16 and d is a multiple
    of 16 up to 128 (its m16n8k16 steps over d and 16-byte row copies),
    else the CUDA-core kernel, which keeps fp32's 1e-4 agreement (TF32
    tensor cores would round q and k) and the other widths."""
    tc = dtype == torch.bfloat16 and d % 16 == 0 and 0 < d <= MAX_HEAD_DIM
    return TENSOR_CORE if tc else CUDA_CORE


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t itself when its rows can be copied 16 bytes at a time (strides
    multiples of 8 elements, 16-byte aligned start), else a contiguous copy."""
    if t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def causal_mask(Sq: int, S: int, device, q_off: int = 0) -> torch.Tensor:
    """[Sq, S] bool: key j <= query row i + q_off."""
    return torch.ones(Sq, S, dtype=torch.bool, device=device).tril(q_off)


def causal_flash_attention_plain(qg, k, v, attention_mask, scale, q_off=0):
    """Dense reference of the kernel -> [B, nkv, g, Sq, d] in qg's dtype."""
    Sq, S = qg.shape[3], k.shape[2]
    s = torch.einsum("bkgid,bkjd->bkgij", wide(qg), wide(k)) * scale
    causal = causal_mask(Sq, S, qg.device, q_off)
    ok = causal[None, None, None] & (attention_mask > 0)[:, None, None, None, :]
    s = torch.where(ok, s, torch.full_like(s, _NEG))
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    ctx = torch.einsum("bkgij,bkjd->bkgid", wide(p.to(v.dtype)), wide(v))
    # Times 1/l, as the kernels and the JAX kernel normalise (not ctx / l).
    ctx = torch.where(l > 0, ctx * (1.0 / torch.where(l > 0, l, torch.ones_like(l))), torch.zeros_like(ctx))
    return ctx.to(qg.dtype)


def causal_flash_attention(qg, k, v, attention_mask, scale, q_off=0):
    """Causal GQA attention. qg [B, nkv, g, Sq, d] (query rows q_off ..
    q_off + Sq - 1; by default Sq = S and q_off = 0), k and v [B, nkv, S, d]
    (any strides with a unit last stride, e.g. head views of a projection),
    one of float32/bfloat16, d <= 128; attention_mask [B, S] int32.
    Returns [B, nkv, g, Sq, d], laid out in memory as [B, Sq, nkv*g, d] so
    that merging the heads back to [B, Sq, nh*d] is free."""
    _build.refuse_grad("causal_flash_attention", qg, k, v)
    if not qg.is_cuda:
        return causal_flash_attention_plain(qg, k, v, attention_mask, scale, q_off)
    global launches, launches_tc, launches_offset
    B, nkv, g, Sq, d = qg.shape
    S = k.shape[2]
    if not (0 <= q_off and q_off + Sq <= S):
        raise ValueError(f"causal_flash_attention: query rows {q_off}..{q_off + Sq - 1} outside the {S} keys")
    if qg.dtype not in _DTYPE_CODES or k.dtype != qg.dtype or v.dtype != qg.dtype:
        raise TypeError(f"causal_flash_attention: q/k/v must share float32 or bfloat16, got {qg.dtype}")
    if tuple(k.shape) != (B, nkv, S, d) or tuple(v.shape) != (B, nkv, S, d):
        raise ValueError(f"causal_flash_attention: k and v must be [{B}, {nkv}, {S}, {d}]")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"causal_flash_attention: head dim must be 1..{MAX_HEAD_DIM}, got {d}")
    if qg.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("causal_flash_attention: q, k, v need a unit last stride")
    for name, t in (("qg", qg), ("k", k), ("v", v)):
        if sum((n - 1) * st for n, st in zip(t.shape, t.stride())) > 2**31 - 1:
            raise ValueError(f"causal_flash_attention: {name} strides exceed 32 bits")
    if attention_mask.dtype != torch.int32 or tuple(attention_mask.shape) != (B, S) or not attention_mask.is_contiguous():
        raise ValueError("causal_flash_attention: attention_mask must be contiguous int32 [B, S]")
    for t in (k, v, attention_mask):
        if t.device != qg.device:
            raise ValueError("causal_flash_attention: all tensors must be on one device")
    out = torch.empty((B, Sq, nkv, g, d), dtype=qg.dtype, device=qg.device)
    if out.numel() == 0:
        return out.permute(0, 2, 3, 1, 4)
    tc = kernel_variant(qg.dtype, d) == TENSOR_CORE
    if tc:
        # The tensor-core kernel copies 16-byte pieces of rows: realign a view that does not allow it.
        qg, k, v = _aligned(qg), _aligned(k), _aligned(v)
    args = (qg.data_ptr(), *qg.stride()[:4], k.data_ptr(), *k.stride()[:3], v.data_ptr(), *v.stride()[:3],
            attention_mask.data_ptr(), out.data_ptr(), B, nkv, g, Sq, S, q_off, d, float(scale),
            _build.stream_ptr(qg))
    if tc:
        rc = _build.lib().gct_causal_flash_attention_tc(*args)
    else:
        rc = _build.lib().gct_causal_flash_attention(_DTYPE_CODES[qg.dtype], *args)
    _build.check(rc, "causal_flash_attention")
    launches += 1
    launches_tc += tc
    launches_offset += q_off > 0
    return out.permute(0, 2, 3, 1, 4)
