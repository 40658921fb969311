"""DeBERTa disentangled attention, four kernel routes with the same result.

    s[i, j] = (q_i.k_j + q_i.pos_k_rel[j-i+S-1] + k_j.pos_q_rel[i-j+S-1]) / scale
    out_i   = softmax_j(s[i, :], keys masked at -1e30) . v

The flash route (:func:`flash_disentangled_attention`, kernel K1) forms the
relative terms per tile and never materializes scores. The bias route
(:func:`table_bias_attention`) applies the relative-to-absolute skew to the
batch-independent position tables (:func:`abs_pos_table`, kernel K6), forms
the two [B, h, S, S] biases as batched products (torch.matmul), and feeds
them to a softmax kernel that keeps whole score rows on chip
(:func:`bias_fused_attention`, kernel K7). The row route
(:func:`row_disentangled_attention`, kernel K8) keeps whole score rows on
chip and forms c2p/p2c there from the relative tables. The tiled route
(:func:`tiled_bias_attention`) builds windowed absolute tables
(:func:`windowed_pos_tables`, kernel K9) and runs a flash kernel that
contracts q and k with them per tile (:func:`tiled_attention`, kernel K10).
:func:`attention_route` picks one.

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

# Kernel launches since the last reset (the main path's proof): K1, K6, K7,
# K8, K9, K10; launches, launches_bias, launches_row and launches_tiled count
# both variants of K1, K7, K8 and K10, the *_tc counters their tensor-core
# launches; launches_offset the K1 launches at a query-row offset q_off > 0
# (a sequence-parallel rank's rows).
launches = 0
launches_flash_tc = 0
launches_offset = 0
launches_table = 0
launches_bias = 0
launches_row = 0
launches_win_table = 0
launches_tiled = 0
launches_bias_tc = 0
launches_row_tc = 0
launches_tiled_tc = 0

HEAD_DIM = 64  # the kernels' head width (DeBERTa-v3: 768 / 12)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG = -1e30


TENSOR_CORE = "tensor-core bf16"
CUDA_CORE = "cuda-core"


def kernel_variant(*dtypes) -> str:
    """The variant of K1, K7, K8 or K10 that takes inputs of these dtypes
    (q's, and K7's biases' or K10's tables'): the bf16 tensor-core kernels
    (``*_tc.cu``) when all are bfloat16, else the CUDA-core kernels, which
    keep fp32's 1e-4 agreement (TF32 tensor cores could not) and the mixed
    types."""
    return TENSOR_CORE if all(d == torch.bfloat16 for d in dtypes) else CUDA_CORE


def rel_index(S: int, device, q_off: int = 0, Sq: int | None = None) -> torch.Tensor:
    """[Sq, S] int64 index with idx[i, j] = j - (i + q_off) + S - 1 (the
    relative axis of S keys for query rows q_off .. q_off + Sq - 1; by
    default all S rows)."""
    Sq = S if Sq is None else Sq
    r = torch.arange(S, device=device)
    return r[None, :] - (r[:Sq, None] + q_off) + (S - 1)


def _rel_biases(q, k, pos_k_rel, pos_q_rel, q_off: int = 0):
    """fp32 c2p[b,h,i,j] = q_i.pos_k_rel[j-(i+q_off)+Sk-1] and p2c[b,h,i,j] =
    k_j.pos_q_rel[(i+q_off)-j+Sk-1], [B, h, Sq, Sk] each: q holds the Sq
    query rows from q_off on, k all Sk keys."""
    B, h, Sq, d = q.shape
    Sk = k.shape[2]
    qp = torch.einsum("bhid,hmd->bhim", q.float(), pos_k_rel.float())  # [B, h, Sq, 2Sk-1]
    kp = torch.einsum("bhjd,hmd->bhjm", k.float(), pos_q_rel.float())  # [B, h, Sk, 2Sk-1]
    idx = rel_index(Sk, q.device, q_off, Sq)
    c2p = torch.gather(qp, -1, idx.expand(B, h, Sq, Sk))
    p2c = torch.gather(kp, -1, (2 * Sk - 2 - idx).T.expand(B, h, Sk, Sq))
    return c2p, p2c.transpose(-1, -2)


def _online_softmax_pv(q, k, v, c2p, p2c, attention_mask, scale):
    """The flash kernels' result: softmax((q.k + c2p + p2c) / scale) . v
    with exp(s - max) rounded to v's dtype before P.v and the sum divided
    out after, as a running-max kernel computes it."""
    s = (q.float() @ k.float().transpose(-1, -2) + c2p + p2c) * (1.0 / scale)
    s = torch.where(attention_mask[:, None, None, :] > 0, s, torch.full_like(s, _NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ctx = (p.to(v.dtype).float() @ v.float()) / p.sum(dim=-1, keepdim=True)
    return ctx.to(q.dtype)


def _check_qkv(name, q, k, v, attention_mask, q_off=None):
    """The checks every attention wrapper makes of q, k, v and the mask.
    With ``q_off`` (K1): q holds Sq query rows from row q_off on, q_off + Sq
    <= Sk, with strides of its own; k and v hold all Sk keys."""
    B, h, Sq, d = q.shape
    S = k.shape[2]
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head dim must be {HEAD_DIM}, got {d}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q/k/v must share float32 or bfloat16, got {q.dtype}")
    if q_off is None:
        if k.shape != q.shape or v.shape != q.shape:
            raise ValueError(f"{name}: q, k, v shapes differ")
        if q.stride() != k.stride() or q.stride() != v.stride() or q.stride(-1) != 1:
            raise ValueError(f"{name}: q, k, v need equal strides and a unit last stride")
    else:
        if tuple(k.shape) != (B, h, S, d) or v.shape != k.shape:
            raise ValueError(f"{name}: k and v must be [{B}, {h}, Sk, {d}] like q [{B}, {h}, Sq, {d}]")
        if not (0 <= q_off and q_off + Sq <= S):
            raise ValueError(f"{name}: query rows {q_off}..{q_off + Sq - 1} outside the {S} keys")
        if k.stride() != v.stride() or q.stride(-1) != 1 or k.stride(-1) != 1:
            raise ValueError(f"{name}: k and v need equal strides, and q, k, v a unit last stride")
    if attention_mask.dtype != torch.int32 or tuple(attention_mask.shape) != (B, S) or not attention_mask.is_contiguous():
        raise ValueError(f"{name}: attention_mask must be contiguous int32 [B, S]")


def _check_rel_tables(name, k, pos_k_rel, pos_q_rel):
    """The tables of k's S keys: [h, 2S - 1, d] each, in k's dtype."""
    h, S, d = k.shape[1:]
    for label, t in (("pos_k_rel", pos_k_rel), ("pos_q_rel", pos_q_rel)):
        if t.dtype != k.dtype or tuple(t.shape) != (h, 2 * S - 1, d) or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous {k.dtype} [{h}, {2 * S - 1}, {d}]")


def _check_device(name, q, *others):
    for t in others:
        if t.device != q.device:
            raise ValueError(f"{name}: all tensors must be on one device")


def flash_disentangled_attention_plain(q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale, q_off=0):
    """Dense reference of the kernel. q [B, h, Sq, d] (query rows q_off ..
    q_off + Sq - 1), k, v [B, h, S, d]; pos_*_rel [h, 2S-1, d];
    attention_mask [B, S] (1 = valid key) -> [B, h, Sq, d]."""
    c2p, p2c = _rel_biases(q, k, pos_k_rel, pos_q_rel, q_off)
    return _online_softmax_pv(q, k, v, c2p, p2c, attention_mask, scale)


def flash_disentangled_attention(q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale, q_off=0):
    """Disentangled attention, kernel K1. k, v: [B, h, S, 64] (views with a
    unit last stride and the same strides, e.g. head splits of a fused
    projection); q: [B, h, Sq, 64], query rows q_off .. q_off + Sq - 1 of
    the S (all S by default; a sequence-parallel rank's block of rows), with
    strides of its own and a unit last stride; pos_k_rel, pos_q_rel: [h,
    2S-1, 64]; attention_mask: [B, S] int32. Returns [B, h, Sq, 64], laid
    out in memory as [B, Sq, h, 64] so that the merge of heads back to [B,
    Sq, h*64] is free. Each query row reads only its own scores, so the
    rows of a launch at q_off equal those rows of the launch over all S bit
    for bit. bf16 inputs launch the tensor-core kernel, fp32 the CUDA-core
    one (:func:`kernel_variant`)."""
    _build.refuse_grad("flash_disentangled_attention", q, k, v, pos_k_rel, pos_q_rel)
    if not q.is_cuda:
        return flash_disentangled_attention_plain(
            q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale, q_off
        )
    global launches, launches_flash_tc, launches_offset
    name = "flash_disentangled_attention"
    B, h, Sq, d = q.shape
    S = k.shape[2]
    _check_qkv(name, q, k, v, attention_mask, q_off)
    _check_rel_tables(name, k, pos_k_rel, pos_q_rel)
    _check_device(name, q, k, v, pos_k_rel, pos_q_rel, attention_mask)
    tc = kernel_variant(q.dtype) == TENSOR_CORE
    if not tc and max(max(q.stride()[:3]), max(k.stride()[:3])) * B > 2**31 - 1:
        raise ValueError(f"{name}: strides exceed 32 bits")
    out = torch.empty((B, Sq, h, d), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), *q.stride()[:3], k.data_ptr(), v.data_ptr(), *k.stride()[:3], pos_k_rel.data_ptr(),
            pos_q_rel.data_ptr(), attention_mask.data_ptr(), out.data_ptr(), B, h, Sq, S, q_off, 1.0 / scale,
            _build.stream_ptr(q))
    if tc:
        rc = _build.lib().gct_flash_disentangled_attention_tc(*args)
    else:
        rc = _build.lib().gct_flash_disentangled_attention(_DTYPE_CODES[q.dtype], *args)
    _build.check(rc, name)
    launches += 1
    launches_flash_tc += tc
    launches_offset += q_off > 0
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
    _build.refuse_grad("abs_pos_table", pos_rel)
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
    out as [B, S, h, 64] like K1's output. bf16 q/k/v with bf16 biases
    launch the tensor-core kernel, other types the CUDA-core one
    (:func:`kernel_variant`)."""
    _build.refuse_grad("bias_fused_attention", q, k, v, c2p, p2c)
    if not q.is_cuda:
        return bias_fused_attention_plain(q, k, v, c2p, p2c, attention_mask, scale)
    global launches_bias, launches_bias_tc
    name = "bias_fused_attention"
    B, h, S, d = q.shape
    _check_qkv(name, q, k, v, attention_mask)
    if not 1 <= S <= BIAS_MAX_SEQ:
        raise ValueError(f"{name}: S={S} outside 1..{BIAS_MAX_SEQ}")
    for label, t in (("c2p", c2p), ("p2c", p2c)):
        if t.dtype not in _DTYPE_CODES or t.dtype != c2p.dtype or tuple(t.shape) != (B, h, S, S):
            raise ValueError(f"{name}: {label} must be float32 or bfloat16 [{B}, {h}, {S}, {S}], "
                             "both of one type")
    _check_device(name, q, k, v, c2p, p2c, attention_mask)
    out = torch.empty((B, S, h, d), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], c2p.data_ptr(), *c2p.stride(),
            p2c.data_ptr(), *p2c.stride(), attention_mask.data_ptr(), out.data_ptr(), B, h, S, 1.0 / scale,
            _build.stream_ptr(q))
    tc = kernel_variant(q.dtype, c2p.dtype) == TENSOR_CORE
    if tc:
        rc = _build.lib().gct_bias_fused_attention_tc(*args)
    else:
        rc = _build.lib().gct_bias_fused_attention(_DTYPE_CODES[q.dtype], _DTYPE_CODES[c2p.dtype], *args)
    _build.check(rc, name)
    launches_bias += 1
    launches_bias_tc += tc
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


# ---------------------------------------------------------------------------
# The row route: K8 (whole score rows, relative terms formed in-kernel)
# ---------------------------------------------------------------------------
ROW_MAX_SEQ = 512  # K8 keeps 64 whole score rows on chip (JAX MAX_FUSED_SEQ)


def row_disentangled_attention_plain(q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale):
    """Dense reference of K8 (JAX ``_kernel``): exact softmax over the whole
    row, p normalised, then rounded to v's dtype before P.v."""
    c2p, p2c = _rel_biases(q, k, pos_k_rel, pos_q_rel)
    return bias_fused_attention_plain(q, k, v, c2p, p2c, attention_mask, scale)


def row_disentangled_attention(q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale):
    """Whole-row disentangled attention, kernel K8, S <= 512. Same arguments
    and output layout as :func:`flash_disentangled_attention`; the softmax is
    exact over each row and p is normalised before it is rounded to v's type
    (the JAX package's ``fused_disentangled_attention``). bf16 inputs launch
    the tensor-core kernel, others the CUDA-core one (:func:`kernel_variant`)."""
    _build.refuse_grad("row_disentangled_attention", q, k, v, pos_k_rel, pos_q_rel)
    if not q.is_cuda:
        return row_disentangled_attention_plain(q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale)
    global launches_row, launches_row_tc
    name = "row_disentangled_attention"
    B, h, S, d = q.shape
    _check_qkv(name, q, k, v, attention_mask)
    if not 1 <= S <= ROW_MAX_SEQ:
        raise ValueError(f"{name}: S={S} outside 1..{ROW_MAX_SEQ}")
    _check_rel_tables(name, k, pos_k_rel, pos_q_rel)
    _check_device(name, q, k, v, pos_k_rel, pos_q_rel, attention_mask)
    out = torch.empty((B, S, h, d), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], pos_k_rel.data_ptr(),
            pos_q_rel.data_ptr(), attention_mask.data_ptr(), out.data_ptr(), B, h, S, 1.0 / scale,
            _build.stream_ptr(q))
    tc = kernel_variant(q.dtype) == TENSOR_CORE
    if tc:
        rc = _build.lib().gct_row_disentangled_attention_tc(*args)
    else:
        rc = _build.lib().gct_row_disentangled_attention(_DTYPE_CODES[q.dtype], *args)
    _build.check(rc, name)
    launches_row += 1
    launches_row_tc += tc
    return out.permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# The tiled route: K9 (windowed absolute tables) and K10 (flash attention
# contracting q and k with them per tile)
# ---------------------------------------------------------------------------
TILED_BLK = 32  # the tables' block on the card: 48.8 MB each at h=12, S=512, bf16
TILED_SEQ_MULTIPLE = 32  # K10's key tile


def _win_index(S: int, blk: int, device) -> torch.Tensor:
    """[2S/blk - 1, blk, blk] index with idx[w, x, y] = w*blk + y - x + blk - 1."""
    w = torch.arange(2 * (S // blk) - 1, device=device)[:, None, None] * blk
    r = torch.arange(blk, device=device)
    return w + r[None, None, :] - r[None, :, None] + (blk - 1)


def windowed_pos_tables_plain(pos_rel: torch.Tensor, blk: int) -> torch.Tensor:
    """[h, 2S-1, d] -> [h, 2S/blk-1, blk, blk, d] (the kernel's layout: see
    :func:`windowed_pos_tables`)."""
    S = (pos_rel.shape[1] + 1) // 2
    return pos_rel[:, _win_index(S, blk, pos_rel.device)]


def windowed_pos_tables(pos_rel: torch.Tensor, blk: int) -> torch.Tensor:
    """Windowed absolute position tables of the tiled route, kernel K9.

    Returns [h, 2n-1, blk, blk, d] (n = S / blk) with
    T[h, w, x, y, :] = pos_rel[h, w*blk + y - x + blk - 1, :]: the absolute
    table restricted to the block-diagonal w = jb - ib + n - 1 of the
    (query block ib, key block jb) tile, at (x, y) = (i, j) mod blk. The JAX
    package's layout is [h, 2n-1, d, blk, blk]; here d is innermost, so that
    the vector K10 contracts for one (x, y) pair is contiguous. Exact (a copy
    of values)."""
    _build.refuse_grad("windowed_pos_tables", pos_rel)
    if not pos_rel.is_cuda:
        return windowed_pos_tables_plain(pos_rel, blk)
    global launches_win_table
    h, W, d = pos_rel.shape
    S = (W + 1) // 2
    if W % 2 != 1 or blk < 1 or S % blk:
        raise ValueError(f"windowed_pos_tables: {W} relative rows (S={S}) are not 2S-1 with S a multiple of blk={blk}")
    if pos_rel.dtype not in _DTYPE_CODES or not pos_rel.is_contiguous():
        raise ValueError("windowed_pos_tables: pos_rel must be contiguous float32 or bfloat16")
    n_win = 2 * (S // blk) - 1
    out = torch.empty((h, n_win, blk, blk, d), dtype=pos_rel.dtype, device=pos_rel.device)
    rc = _build.lib().gct_windowed_pos_table(
        _DTYPE_CODES[pos_rel.dtype], pos_rel.data_ptr(), out.data_ptr(), h, S, d, blk,
        _build.stream_ptr(pos_rel),
    )
    _build.check(rc, "windowed_pos_tables")
    launches_win_table += 1
    return out


def _tile_tables(twc, twq, S):
    """The [h, S, S, d] absolute tables the windowed ones stand for: c2p's
    entry of (i, j) in window jb - ib + n - 1 at (i mod blk, j mod blk),
    p2c's in window ib - jb + n - 1 at (j mod blk, i mod blk)."""
    blk = twc.shape[2]
    n = S // blk
    r = torch.arange(S, device=twc.device)
    ib, x = r // blk, r % blk
    Tc = twc[:, ib[None, :] - ib[:, None] + n - 1, x[:, None], x[None, :]]
    Tq = twq[:, ib[:, None] - ib[None, :] + n - 1, x[None, :], x[:, None]]
    return Tc, Tq


def tiled_attention_plain(q, k, v, twc, twq, attention_mask, scale):
    """Dense reference of K10: c2p[b,h,i,j] = q_i . Tc[h,i,j], p2c[b,h,i,j] =
    k_j . Tq[h,i,j] from the windowed tables, then the flash softmax."""
    Tc, Tq = _tile_tables(twc, twq, q.shape[2])
    c2p = torch.einsum("bhie,hije->bhij", q.float(), Tc.float())
    p2c = torch.einsum("bhje,hije->bhij", k.float(), Tq.float())
    return _online_softmax_pv(q, k, v, c2p, p2c, attention_mask, scale)


def tiled_attention(q, k, v, twc, twq, attention_mask, scale):
    """Flash attention over the windowed tables, kernel K10 (JAX
    ``_tiled_kernel``). q, k, v and the mask as for
    :func:`flash_disentangled_attention`, S a multiple of 32; twc, twq:
    :func:`windowed_pos_tables` of pos_k_rel and pos_q_rel, one type
    (float32 or bfloat16), one blk dividing S. Returns [B, h, S, 64], laid
    out as [B, S, h, 64]. bf16 q/k/v with bf16 tables launch the tensor-core
    kernel, other types the CUDA-core one (:func:`kernel_variant`)."""
    _build.refuse_grad("tiled_attention", q, k, v, twc, twq)
    if not q.is_cuda:
        return tiled_attention_plain(q, k, v, twc, twq, attention_mask, scale)
    global launches_tiled, launches_tiled_tc
    name = "tiled_attention"
    B, h, S, d = q.shape
    _check_qkv(name, q, k, v, attention_mask)
    if S % TILED_SEQ_MULTIPLE:
        raise ValueError(f"{name}: S={S} is not a multiple of {TILED_SEQ_MULTIPLE}")
    blk = twc.shape[2] if twc.dim() == 5 else 0
    want = (h, 2 * (S // blk) - 1, blk, blk, d) if blk and S % blk == 0 else None
    for label, t in (("twc", twc), ("twq", twq)):
        if (want is None or t.dtype not in _DTYPE_CODES or t.dtype != twc.dtype or tuple(t.shape) != want
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {label} must be a contiguous float32 or bfloat16 windowed table "
                             f"[h, 2S/blk-1, blk, blk, {d}] with blk dividing S={S}, both of one type")
    _check_device(name, q, k, v, twc, twq, attention_mask)
    out = torch.empty((B, S, h, d), dtype=q.dtype, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], twc.data_ptr(), twq.data_ptr(),
            attention_mask.data_ptr(), out.data_ptr(), B, h, S, blk, 1.0 / scale, _build.stream_ptr(q))
    tc = kernel_variant(q.dtype, twc.dtype) == TENSOR_CORE
    if tc:
        rc = _build.lib().gct_tiled_disentangled_attention_tc(*args)
    else:
        rc = _build.lib().gct_tiled_disentangled_attention(_DTYPE_CODES[q.dtype], _DTYPE_CODES[twc.dtype], *args)
    _build.check(rc, name)
    launches_tiled += 1
    launches_tiled_tc += tc
    return out.permute(0, 2, 1, 3)


def tiled_bias_attention(q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale,
                         score_dtype=torch.float32, blk: int | None = None):
    """The tiled route (JAX ``tiled_bias_attention``): two K9 tables in
    ``score_dtype`` at block ``blk`` (default :data:`TILED_BLK`), then K10.
    Same arguments and result as :func:`flash_disentangled_attention`."""
    blk = blk or TILED_BLK
    twc = windowed_pos_tables(pos_k_rel.to(score_dtype), blk)
    twq = windowed_pos_tables(pos_q_rel.to(score_dtype), blk)
    return tiled_attention(q, k, v, twc, twq, attention_mask, scale)


def tiled_bias_attention_plain(q, k, v, pos_k_rel, pos_q_rel, attention_mask, scale,
                               score_dtype=torch.float32, blk: int | None = None):
    """:func:`tiled_bias_attention` with the plain versions of K9 and K10."""
    blk = blk or TILED_BLK
    twc = windowed_pos_tables_plain(pos_k_rel.to(score_dtype), blk)
    twq = windowed_pos_tables_plain(pos_q_rel.to(score_dtype), blk)
    return tiled_attention_plain(q, k, v, twc, twq, attention_mask, scale)


def attention_route(S: int, B: int, head_dim: int, route: str = "auto", device=None) -> str:
    """The route of one forward at sequence length S and batch B on
    ``device`` (a torch device or its name; None: the CPU): "flash", "bias",
    "row", "tiled" or "score" (the materialized-score path).

    A forced route wins where its kernels take the shape, as the JAX
    package's GLICLASS_TPU_ATTN_ROUTE does (its predicates ``use_bias_route``,
    ``fusable``, ``use_tiled_route``): "flash" at any S; "bias" at S a
    multiple of 8 up to 2048; "row" at S a multiple of 8 up to 512; "tiled"
    at S a multiple of 32; each with head_dim a multiple of 8. At other S
    these three run "flash" (where the JAX package takes its score path:
    the same function). "table" and "xla" force the score path at any S.
    "auto" takes the route :func:`_auto_route` names, on the same terms.

    On a CUDA device every route is "score" unless head_dim is the kernels'
    :data:`HEAD_DIM` (their wrappers refuse other widths), where the JAX
    package runs the same function at any width. On the CPU the plain
    versions take any width, so the routes above stand."""
    check_attn_route(route)
    if device is not None and torch.device(device).type == "cuda" and head_dim != HEAD_DIM:
        return "score"
    aligned = S % 8 == 0 and head_dim % 8 == 0
    if route in ("table", "xla"):
        return "score"
    if route == "bias":
        return "bias" if aligned and S <= BIAS_MAX_SEQ else "flash"
    if route == "row":
        return "row" if aligned and S <= ROW_MAX_SEQ else "flash"
    if route == "tiled":
        return "tiled" if S % TILED_SEQ_MULTIPLE == 0 and head_dim % 8 == 0 else "flash"
    if route == "flash":
        return "flash"
    return attention_route(S, B, head_dim, _auto_route(S, B))


# (S, B) where chip_smoke.py's four-route phase measured a route other than
# flash fastest by the rule in _auto_route's docstring.
_AUTO_MEASURED = {(512, 8): "row"}


def _auto_route(S: int, B: int) -> str:
    """The "auto" rule: the route measured fastest on the H100 at (S, B),
    else K1. Whole gliclass-base "int8-dynamic" forward, CUDA events
    (NVIDIA H100 80GB HBM3, 700.00 W).

    The four routes with K1, K3, K7, K8 and K10 on tensor cores, in four
    runs of chip_smoke.py's four-route phase (two turns in opposite orders
    each). A route takes a shape where it was faster than the other three in
    both turns of two runs or more, and no other route was in any run. The
    runs' wins in both turns, first to fourth:

      1. flash [128|64|32|16, 512], [128, 128], [128, 56], [32, 72];
         tiled [64, 56];
      2. flash [128|64|32, 512], [128, 128], [128, 72]; row [8, 512];
      3. flash [128|64|32, 512], [128, 128]; row [16, 512], [8, 512];
      4. flash [128|64|32, 512], [128, 128], [128, 56], [128, 88];
         row [128, 72]; tiled [32, 72].

    So row takes [8, 512] (its median was also the lowest in all four runs:
    flash, bias, row, tiled ms 32.6, 38.8, 32.4, 35.1 / 48.9, 48.9, 41.4,
    46.7 / 30.7, 39.8, 28.5, 32.7 / 31.0, 34.4, 29.2, 30.0). Flash won
    [128|64|32, 512] and [128, 128] in all four runs (e.g. [128, 512]
    196.3, 226.7, 218.3, 219.2 in the first) and [128, 56] in two.
    [16, 512], [128, 72] and [32, 72] went to two routes, [64, 56] and
    [128, 88] to one route in one run, [32, 128] to none: these take K1, as
    every shape not measured (the short shapes are host-bound, and their
    turns moved by up to 2x within a run). Before K1 ran on tensor cores,
    row won the 512 bucket and [128, 88], tiled [128, 128]."""
    return _AUTO_MEASURED.get((S, B), "flash")
