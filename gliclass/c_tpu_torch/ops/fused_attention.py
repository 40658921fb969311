"""DeBERTa disentangled attention, two routes with the same result.

    s[i, j] = (q_i.k_j + q_i.pos_k_rel[j-i+S-1] + k_j.pos_q_rel[i-j+S-1]) / scale
    out_i   = softmax_j(s[i, :], keys masked at -1e30) . v

The flash route (:func:`flash_disentangled_attention`, kernel K1) forms the
relative terms per tile and never materializes scores. The bias route
(:func:`table_bias_attention`) applies the relative-to-absolute skew to the
batch-independent position tables (:func:`abs_pos_table`, kernel K6), forms
the two [B, h, S, S] biases as batched products (torch.matmul), and feeds
them to a softmax kernel that keeps whole score rows on chip
(:func:`bias_fused_attention`, kernel K7). :func:`attention_route` picks one.

On a CUDA tensor each wrapper launches its kernel (``csrc/*.cu``) or raises;
on a CPU tensor it runs its ``*_plain`` version, the same function computed
densely in PyTorch: fp32 scores, fp32 softmax statistics, probabilities
rounded to v's dtype before P.v, as the kernels do.

Padded query rows are computed like the others (key-only mask); callers
ignore them.
"""

from __future__ import annotations

import torch

from ..config import check_attn_route
from . import _build

# Kernel launches since the last reset (the main path's proof): K1, K6, K7.
launches = 0
launches_table = 0
launches_bias = 0

HEAD_DIM = 64  # the kernel's head width (DeBERTa-v3: 768 / 12)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30


def rel_index(S: int, device) -> torch.Tensor:
    """[S, S] int64 index with idx[i, j] = j - i + S - 1 (the relative axis)."""
    r = torch.arange(S, device=device)
    return r[None, :] - r[:, None] + (S - 1)


def flash_disentangled_attention_plain(q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale):
    """Dense reference of the kernel. q, k, v [B, h, S, d]; pos_*_rel
    [h, 2S-1, d]; attention_mask [B, S] (1 = valid key) -> [B, h, S, d]."""
    B, h, S, d = q.shape
    qf, kf = q.float(), k.float()
    qk = qf @ kf.transpose(-1, -2)
    qp = torch.einsum("bhid,hmd->bhim", qf, pos_k_rel.float())  # [B, h, S, 2S-1]
    kp = torch.einsum("bhjd,hmd->bhjm", kf, pos_q_rel.float())
    idx = rel_index(S, q.device).expand(B, h, S, S)
    c2p = torch.gather(qp, -1, idx)                    # qp[i, j-i+S-1]
    p2c = torch.gather(kp, -1, idx).transpose(-1, -2)  # kp[j, i-j+S-1]
    s = (qk + c2p + p2c) * (1.0 / scale)
    s = torch.where(attention_mask[:, None, None, :] > 0, s, torch.full_like(s, _NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ctx = (p.to(v.dtype).float() @ v.float()) / p.sum(dim=-1, keepdim=True)
    return ctx.to(q.dtype)


def flash_disentangled_attention(q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale):
    """Disentangled attention. q, k, v: [B, h, S, 64] (views with a unit last
    stride and the same strides, e.g. head splits of a fused projection);
    pos_k_rel, pos_q_rel: [h, 2S-1, 64]; attention_mask: [B, S] int32.
    Returns [B, h, S, 64], laid out in memory as [B, S, h, 64] so that the
    merge of heads back to [B, S, h*64] is free."""
    if not q.is_cuda:
        return flash_disentangled_attention_plain(
            q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale
        )
    global launches
    B, h, S, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"flash_disentangled_attention: head dim must be {HEAD_DIM}, got {d}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_disentangled_attention: q/k/v must share float32 or bfloat16, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("flash_disentangled_attention: q, k, v shapes differ")
    if q.stride() != k.stride() or q.stride() != v.stride() or q.stride(-1) != 1:
        raise ValueError("flash_disentangled_attention: q, k, v need equal strides and a unit last stride")
    if max(q.stride()[:3]) * B > 2**31 - 1:
        raise ValueError("flash_disentangled_attention: strides exceed 32 bits")
    for name, t in (("pos_k_rel", pos_k_rel), ("pos_q_rel", pos_q_rel)):
        if t.dtype != q.dtype or tuple(t.shape) != (h, 2 * S - 1, d) or not t.is_contiguous():
            raise ValueError(f"flash_disentangled_attention: {name} must be contiguous {q.dtype} [{h}, {2 * S - 1}, {d}]")
    if attention_mask.dtype != torch.int32 or tuple(attention_mask.shape) != (B, S) or not attention_mask.is_contiguous():
        raise ValueError("flash_disentangled_attention: attention_mask must be contiguous int32 [B, S]")
    for t in (k, v, pos_k_rel, pos_q_rel, attention_mask):
        if t.device != q.device:
            raise ValueError("flash_disentangled_attention: all tensors must be on one device")
    out = torch.empty((B, S, h, d), dtype=q.dtype, device=q.device)
    sb, sh, ss, _ = q.stride()
    rc = _build.lib().gct_flash_disentangled_attention(
        _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), sb, sh, ss,
        pos_k_rel.data_ptr(), pos_q_rel.data_ptr(), attention_mask.data_ptr(),
        out.data_ptr(), B, h, S, 1.0 / scale, _build.stream_ptr(q),
    )
    _build.check(rc, "flash_disentangled_attention")
    launches += 1
    return out.permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# The bias route: K6 (absolute position tables) and K7 (softmax over biases)
# ---------------------------------------------------------------------------
def abs_pos_table_plain(pos_rel: torch.Tensor, S: int) -> torch.Tensor:
    """[h, 2S-1, d] -> [h, S, d, S] with T[h, x, :, y] = pos_rel[h, y-x+S-1, :]
    (the kernel's layout: see :func:`abs_pos_table`)."""
    return pos_rel[:, rel_index(S, pos_rel.device)].permute(0, 1, 3, 2).contiguous()


def abs_pos_table(pos_rel: torch.Tensor, S: int) -> torch.Tensor:
    """Absolute position table of the bias route, kernel K6.

    Returns [h, S, d, S] with T[h, x, :, y] = pos_rel[h, y - x + S - 1, :]:
    the JAX package's [h, d, S, S] table with the query axis moved ahead of
    d, so that the [d, S] slab each query row multiplies is contiguous and the
    bias products batch over (h, x) without a copy. Exact (a copy of values)."""
    if not pos_rel.is_cuda:
        return abs_pos_table_plain(pos_rel, S)
    global launches_table
    h, W, d = pos_rel.shape
    if W != 2 * S - 1:
        raise ValueError(f"abs_pos_table: pos_rel has {W} relative rows, expected {2 * S - 1}")
    if pos_rel.dtype not in _DTYPE_CODES or not pos_rel.is_contiguous() or not 1 <= d <= 128:
        raise ValueError("abs_pos_table: pos_rel must be contiguous float32 or bfloat16 with d <= 128")
    out = torch.empty((h, S, d, S), dtype=pos_rel.dtype, device=pos_rel.device)
    rc = _build.lib().gct_abs_pos_table(
        _DTYPE_CODES[pos_rel.dtype], pos_rel.data_ptr(), out.data_ptr(), h, S, d,
        _build.stream_ptr(pos_rel),
    )
    _build.check(rc, "abs_pos_table")
    launches_table += 1
    return out


def bias_fused_attention_plain(q, k, v, c2p, p2c, attention_mask, scale):
    """Dense reference of K7: softmax((q.k + c2p + p2c) / scale) . v."""
    s = q.float() @ k.float().transpose(-1, -2)
    s = (s + c2p.float() + p2c.float()) * (1.0 / scale)
    s = torch.where(attention_mask[:, None, None, :] > 0, s, torch.full_like(s, _NEG))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return (p.to(v.dtype).float() @ v.float()).to(q.dtype)


BIAS_MAX_SEQ = 2048  # K7 keeps whole score rows on chip: 16 rows of 2048


def bias_fused_attention(q, k, v, c2p, p2c, attention_mask, scale):
    """softmax((q.k^T + c2p + p2c) / scale, keys masked at -1e30) . v, kernel K7.

    q, k, v: [B, h, S, 64] (views with a unit last stride and equal strides);
    c2p, p2c: [B, h, S, S] unscaled biases of one type (float32 or bfloat16),
    any strides (the route passes views of its products, c2p contiguous in j
    and p2c in i); attention_mask: [B, S] int32. Returns [B, h, S, 64], laid
    out as [B, S, h, 64] like K1's output."""
    if not q.is_cuda:
        return bias_fused_attention_plain(q, k, v, c2p, p2c, attention_mask, scale)
    global launches_bias
    B, h, S, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"bias_fused_attention: head dim must be {HEAD_DIM}, got {d}")
    if not 1 <= S <= BIAS_MAX_SEQ:
        raise ValueError(f"bias_fused_attention: S={S} outside 1..{BIAS_MAX_SEQ}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"bias_fused_attention: q/k/v must share float32 or bfloat16, got {q.dtype}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("bias_fused_attention: q, k, v shapes differ")
    if q.stride() != k.stride() or q.stride() != v.stride() or q.stride(-1) != 1:
        raise ValueError("bias_fused_attention: q, k, v need equal strides and a unit last stride")
    for name, t in (("c2p", c2p), ("p2c", p2c)):
        if t.dtype not in _DTYPE_CODES or t.dtype != c2p.dtype or tuple(t.shape) != (B, h, S, S):
            raise ValueError(f"bias_fused_attention: {name} must be float32 or bfloat16 [{B}, {h}, {S}, {S}], "
                             "both of one type")
    if attention_mask.dtype != torch.int32 or tuple(attention_mask.shape) != (B, S) or not attention_mask.is_contiguous():
        raise ValueError("bias_fused_attention: attention_mask must be contiguous int32 [B, S]")
    for t in (k, v, c2p, p2c, attention_mask):
        if t.device != q.device:
            raise ValueError("bias_fused_attention: all tensors must be on one device")
    out = torch.empty((B, S, h, d), dtype=q.dtype, device=q.device)
    rc = _build.lib().gct_bias_fused_attention(
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[c2p.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *q.stride()[:3], c2p.data_ptr(), *c2p.stride(), p2c.data_ptr(), *p2c.stride(),
        attention_mask.data_ptr(), out.data_ptr(), B, h, S, 1.0 / scale, _build.stream_ptr(q),
    )
    _build.check(rc, "bias_fused_attention")
    launches_bias += 1
    return out.permute(0, 2, 1, 3)


def table_bias_attention(q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale,
                         score_dtype=torch.float32):
    """The bias route (JAX ``table_bias_attention`` with the Pallas softmax).

    Two K6 tables; the bias products c2p[b,h,i,j] = q_i . T_c[h,i,:,j] and
    p2c[b,h,i,j] = k_j . T_q[h,j,:,i] as torch.matmul batched over (h, row)
    with the batch as M (fp32 accumulation, output in ``score_dtype``, laid
    out [h, S, B, S]); then K7, which reads both through strides. Same
    arguments and result as :func:`flash_disentangled_attention`."""
    S = q.shape[2]
    Tc = abs_pos_table(pos_k_rel, S)
    c2p = torch.matmul(q.permute(1, 2, 0, 3), Tc).to(score_dtype)  # [h, S_i, B, S_j]
    del Tc
    Tq = abs_pos_table(pos_q_rel, S)
    p2c = torch.matmul(k.permute(1, 2, 0, 3), Tq).to(score_dtype)  # [h, S_j, B, S_i]
    del Tq
    return bias_fused_attention(q, k, v, c2p.permute(2, 0, 1, 3), p2c.permute(2, 0, 3, 1),
                                attention_mask, scale)


def attention_route(S: int, B: int, head_dim: int, route: str = "auto") -> str:
    """"flash" or "bias" for one forward at sequence length S and batch B.

    A forced route wins: "flash" at any S, "bias" at any S that is a multiple
    of 8 (with head_dim a multiple of 8), as the JAX package's
    GLICLASS_TPU_ATTN_ROUTE does; elsewhere the default route runs. "row" and
    "tiled" raise (not ported). "auto" follows the H100 measurement below."""
    check_attn_route(route)
    bias_ok = S % 8 == 0 and head_dim % 8 == 0 and S <= BIAS_MAX_SEQ
    if route == "bias":
        return "bias" if bias_ok else "flash"
    if route == "flash":
        return "flash"
    return "bias" if bias_ok and _auto_bias(S, B) else "flash"


def _auto_bias(S: int, B: int) -> bool:
    """The "auto" rule: the bias route where it was measured faster on the
    H100, else K1.

    Measured by chip_smoke.py's route phase: the whole gliclass-base
    "int8-dynamic" forward at S=512, CUDA events, two alternating turns
    (NVIDIA H100 80GB HBM3, 700.00 W), bias vs flash:
    B=16 75.2 vs 67.0 ms, B=32 129.9 vs 127.2, B=64 236.0 vs 241.3,
    B=128 446.1 vs 470.2. The tables cost the same at any batch and K7 saves
    on K1 per row, so the bias route wins from B=64 on. Lengths other than
    the 512 bucket were not measured and keep K1 (the tables grow as S^2)."""
    return S == 512 and B >= 64
